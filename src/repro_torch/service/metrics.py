"""Service observability: latency / throughput / queue-depth counters
emitted in the repo's BENCH_*.json (schema 2) artifact format.

The service records per-request latency (admission -> future resolved),
deadline outcomes (met / missed-but-served / dropped), per-batch wall
time, size, FILL FRACTION (batch size over the max_batch the scheduler
aimed for), the lane each batch ran on, per-lane occupancy, queue-depth
samples, and every rejection class (backpressure, SNR gate, overload
shed, client cancel). `to_bench_doc()` renders the snapshot as the same
schema-2 document benchmarks/common.write_bench_json produces (git SHA,
backend, ISO-8601 UTC timestamp, rows of name/wall_ms/derived), so
serving metrics diff and upload exactly like the paper-table benchmarks.
The environment block names the port's own stack: ``backend`` is the
torch device type ("cuda" or "cpu"), ``jax_version`` is null (schema 2
requires the key), beside ``torch_version`` and ``cuda_version``, and on
the card the device's name and the ``nvidia-smi`` name and power-limit
line. The writer here is self-contained — `repro_torch.service` must not
depend on the benchmarks package being importable in production — but
tests assert the documents validate against
benchmarks.common.validate_bench_doc.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter
from typing import Dict, List, Optional

import torch

BENCH_SCHEMA = 2
_RESERVOIR_MAX = 100_000


def utc_now_iso() -> str:
    """ISO-8601 UTC, second precision — stable enough to diff artifacts."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _nvidia_smi(index: int) -> str:
    """The card's ``name, power.limit`` as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def environment(device) -> dict:
    """The BENCH document's environment keys for a service on
    ``device``."""
    dev = torch.device(device)
    env = {"backend": dev.type, "jax_version": None,
           "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        env["device_name"] = torch.cuda.get_device_name(index)
        env["nvidia_smi"] = _nvidia_smi(index)
    return env


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile; 0.0 on empty input."""
    if not values:
        return 0.0
    xs = sorted(values)
    k = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[k]


class ServiceMetrics:
    """Mutable counters for one service instance on ``device`` (not
    thread-safe beyond the GIL — the service mutates it from the
    event-loop thread only)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.t_start = time.monotonic()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0            # backpressure rejections
        self.gate_rejected = 0       # SNR-gate rejections
        self.shed = 0                # latest-deadline work shed at overload
        self.cancelled = 0           # dropped before dispatch (client
                                     # cancel or past-deadline sweep)
        self.deadline_dropped = 0    # subset of cancelled: deadline sweep
        self.deadline_missed = 0     # served, but after t_deadline
        self.deadline_met = 0        # served within t_deadline
        self.failed = 0
        self.streamed = 0
        # -- resilience counters (the failure-domain layer) ------------------
        self.dispatch_failures = 0   # batch attempts that raised
        self.retries = 0             # bounded-retry re-dispatches
        self.bisections = 0          # poison-batch splits
        self.lane_stalls = 0         # stall-watchdog lane restarts
        self.corrupted = 0           # sentinel-flagged scenes
        self.tier_fallbacks = 0      # precision-tier (bs16 -> f32) falls
        self.latencies_ms: List[float] = []
        self.batch_sizes: Counter = Counter()
        self.batch_fill: Counter = Counter()     # fill fraction histogram
        self.batch_wall_ms: List[float] = []
        self.depth_samples: List[int] = []
        self.lane_batches: Counter = Counter()   # batches per lane
        self.lane_busy_ms: Counter = Counter()   # device-thread ms per lane
        self._lane_occupancy: Dict[str, float] = {}

    # -- recording ----------------------------------------------------------
    def observe_submit(self, depth: int) -> None:
        self.submitted += 1
        self.depth_samples.append(depth)

    def observe_reject(self) -> None:
        self.rejected += 1

    def observe_gate_reject(self) -> None:
        self.gate_rejected += 1

    def observe_shed(self) -> None:
        self.shed += 1

    def observe_cancelled(self, reason: str = "client_cancelled") -> None:
        self.cancelled += 1
        if reason == "deadline":
            self.deadline_dropped += 1

    def observe_batch(self, size: int, wall_ms: float,
                      streamed: bool = False,
                      lane: Optional[str] = None,
                      max_batch: Optional[int] = None) -> None:
        self.batch_sizes[size] += 1
        self.batch_wall_ms.append(wall_ms)
        if streamed:
            self.streamed += size
        if lane is not None:
            self.lane_batches[lane] += 1
            self.lane_busy_ms[lane] += wall_ms
        if max_batch:
            # fill fraction quantized to max_batch-ths: the histogram key
            # is exact (no float binning), e.g. "3/4"
            self.batch_fill[f"{min(size, max_batch)}/{max_batch}"] += 1

    def observe_done(self, latency_ms: float,
                     deadline_met: Optional[bool] = None) -> None:
        self.completed += 1
        if deadline_met is True:
            self.deadline_met += 1
        elif deadline_met is False:
            self.deadline_missed += 1
        if len(self.latencies_ms) < _RESERVOIR_MAX:
            self.latencies_ms.append(latency_ms)

    def observe_failure(self) -> None:
        self.failed += 1

    def observe_dispatch_failure(self) -> None:
        self.dispatch_failures += 1

    def observe_retry(self) -> None:
        self.retries += 1

    def observe_bisect(self) -> None:
        self.bisections += 1

    def observe_stall(self) -> None:
        self.lane_stalls += 1

    def observe_corrupt(self, scenes: int = 1) -> None:
        self.corrupted += scenes

    def observe_tier_fallback(self, scenes: int = 1) -> None:
        self.tier_fallbacks += scenes

    def set_lane_occupancy(self, occupancy: Dict[str, float]) -> None:
        """Latest per-lane busy fraction (WorkerPool.occupancy())."""
        self._lane_occupancy = dict(occupancy)

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> dict:
        elapsed = max(time.monotonic() - self.t_start, 1e-9)
        n_batches = sum(self.batch_sizes.values())
        coalesced = sum(k * v for k, v in self.batch_sizes.items())
        deadlined = (self.deadline_met + self.deadline_missed
                     + self.deadline_dropped)
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "gate_rejected": self.gate_rejected,
            "shed": self.shed,
            "cancelled": self.cancelled,
            "deadline_dropped": self.deadline_dropped,
            "deadline_missed": self.deadline_missed,
            "deadline_met": self.deadline_met,
            # misses + drops over every deadline-carrying outcome (0.0
            # when no request carried a deadline)
            "deadline_miss_rate": (
                (self.deadline_missed + self.deadline_dropped) / deadlined
                if deadlined else 0.0),
            "failed": self.failed,
            "streamed": self.streamed,
            "dispatch_failures": self.dispatch_failures,
            "retries": self.retries,
            "bisections": self.bisections,
            "lane_stalls": self.lane_stalls,
            "corrupted": self.corrupted,
            "tier_fallbacks": self.tier_fallbacks,
            "throughput_rps": self.completed / elapsed,
            # goodput: completions that met their deadline per second;
            # requests without a deadline always count as good
            "goodput_rps": (self.completed - self.deadline_missed)
            / elapsed,
            "latency_p50_ms": percentile(self.latencies_ms, 50),
            "latency_p99_ms": percentile(self.latencies_ms, 99),
            "latency_mean_ms": (sum(self.latencies_ms) /
                                len(self.latencies_ms)
                                if self.latencies_ms else 0.0),
            "mean_batch_size": coalesced / n_batches if n_batches else 0.0,
            "batch_size_hist": dict(sorted(self.batch_sizes.items())),
            "batch_fill_hist": dict(sorted(self.batch_fill.items())),
            "lane_batches": dict(sorted(self.lane_batches.items())),
            "lane_occupancy": dict(sorted(self._lane_occupancy.items())),
            "queue_depth_max": max(self.depth_samples, default=0),
        }

    def rows(self, section: str = "service") -> List[dict]:
        """Snapshot rendered as BENCH rows (wall_ms carries the metric's
        natural unit; non-latency metrics ride in `derived`)."""
        s = self.snapshot()
        rows = []
        for name in ("latency_p50_ms", "latency_p99_ms", "latency_mean_ms"):
            rows.append({"section": section, "name": name,
                         "wall_ms": s[name], "derived": ""})
        rows.append({
            "section": section, "name": "throughput",
            "wall_ms": 0.0,
            "derived": f"rps={s['throughput_rps']:.2f};"
                       f"goodput_rps={s['goodput_rps']:.2f};"
                       f"completed={s['completed']};"
                       f"rejected={s['rejected']};"
                       f"gate_rejected={s['gate_rejected']};"
                       f"shed={s['shed']};"
                       f"cancelled={s['cancelled']};"
                       f"deadline_miss_rate={s['deadline_miss_rate']:.4f};"
                       f"streamed={s['streamed']}",
        })
        rows.append({
            "section": section, "name": "batching",
            "wall_ms": 0.0,
            "derived": f"mean_batch={s['mean_batch_size']:.2f};"
                       f"hist={s['batch_size_hist']};"
                       f"fill_hist={s['batch_fill_hist']};"
                       f"queue_depth_max={s['queue_depth_max']}",
        })
        rows.append({
            "section": section, "name": "resilience",
            "wall_ms": 0.0,
            "derived": f"dispatch_failures={s['dispatch_failures']};"
                       f"retries={s['retries']};"
                       f"bisections={s['bisections']};"
                       f"lane_stalls={s['lane_stalls']};"
                       f"corrupted={s['corrupted']};"
                       f"tier_fallbacks={s['tier_fallbacks']};"
                       f"failed={s['failed']}",
        })
        occ = ";".join(f"occ_{name}={frac:.4f}"
                       for name, frac in s["lane_occupancy"].items())
        per_lane = ";".join(f"batches_{name}={n}"
                            for name, n in s["lane_batches"].items())
        rows.append({
            "section": section, "name": "lanes",
            "wall_ms": 0.0,
            "derived": ";".join(p for p in (
                f"lanes={len(s['lane_occupancy'])}", occ, per_lane) if p),
        })
        return rows

    def to_bench_doc(self, section: str = "service", **meta) -> dict:
        """The schema-2 BENCH_*.json document for this snapshot."""
        return {
            "schema": BENCH_SCHEMA,
            "git_sha": _git_sha(),
            **environment(self.device),
            "python": sys.version.split()[0],
            "generated_utc": utc_now_iso(),
            **meta,
            "rows": self.rows(section),
        }

    def write_bench_json(self, path: str, section: str = "service",
                         **meta) -> None:
        with open(path, "w") as f:
            json.dump(self.to_bench_doc(section, **meta), f, indent=2)
