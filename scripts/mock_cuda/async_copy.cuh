// mock: cp.async as a copy made when it is issued (MOCK_CP_ASYNC unset or
// "eager": a copy into a slot other threads still read races with them)
// or when the thread's wait retires its group ("lazy": a read of a slot
// before the wait and the barrier sees the mock's NaN fill or an older
// tile).
#pragma once
#include <atomic>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <vector>
namespace spectral {
struct MockCopy { void* dst; const void* src; };
inline bool mock_cp_lazy() {
  static const bool lazy = [] {
    const char* m = std::getenv("MOCK_CP_ASYNC");
    return m != nullptr && std::strcmp(m, "lazy") == 0;
  }();
  return lazy;
}
inline std::atomic<long long> g_cp_count{0};
inline thread_local std::vector<MockCopy> g_cp_open;
inline thread_local std::deque<std::vector<MockCopy>> g_cp_groups;
inline void cp_async16(void* smem, const void* gmem) {
  g_cp_count.fetch_add(1, std::memory_order_relaxed);
  if (mock_cp_lazy()) {
    g_cp_open.push_back({smem, gmem});
  } else {
    std::memcpy(smem, gmem, 16);
  }
}
inline void cp_async_commit() {
  g_cp_groups.push_back(std::move(g_cp_open));
  g_cp_open.clear();
}
template <int kN>
inline void cp_async_wait() {
  while (g_cp_groups.size() > (size_t)kN) {
    for (const MockCopy& c : g_cp_groups.front()) std::memcpy(c.dst, c.src, 16);
    g_cp_groups.pop_front();
  }
}
}  // namespace spectral
// The copies issued since the library was loaded (run.py reads it; one
// translation unit a library includes this).
extern "C" __attribute__((used)) long long mock_cp_async_count() {
  return spectral::g_cp_count.load();
}
