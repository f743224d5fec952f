"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` source compiles, at first use, into its own shared
library with a plain C interface under ``kernels/_build/`` (listed in
.gitignore); nothing prebuilt ships with the repository. The sources
build side by side, one ``nvcc`` process a core, the longest first
(``LONGEST_FIRST``). A library is rebuilt when any
file of ``csrc/`` is newer than it.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -fmad=false -shared -Xcompiler -fPIC \
         -o _build/lib<name>.so csrc/<name>.cu

No ``--use_fast_math``: the float32 path must keep precise ``sincosf``
and IEEE division. ``-fmad=false``: no multiply-add is contracted behind
the source's back, so the kernels that share ``spectral_common.cuh``
round every point the same way (fused1 equals fused3 bit for bit).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler",
              "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# Seconds from the start of the last build_all to each source's nvcc
# exiting (a source may wait for a core first).
BUILD_SECONDS: dict[str, float] = {}


def sources() -> dict[str, str]:
    """Kernel name -> path of its CUDA source."""
    return {f[:-3]: os.path.join(CSRC, f)
            for f in sorted(os.listdir(CSRC)) if f.endswith(".cu")}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str, src: str) -> bool:
    """No library yet, or one older than any file of ``csrc/`` (a source
    may include the shared headers, and another source: mega_forms.cu
    builds mega.cu's operand forms)."""
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(built < os.path.getmtime(os.path.join(CSRC, f))
               for f in os.listdir(CSRC))


def build_all(verbose: bool = False, force: bool = False,
              names=None) -> dict[str, str]:
    """Compile every stale source (every source with ``force``; only those
    of ``names`` when given), one ``nvcc`` process a core. Returns
    name -> compiler output of each
    source compiled (``-Xptxas -v`` register and shared memory report when
    ``verbose``). Raises on any failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    todo = []
    for name, src in sources().items():
        if names is not None and name not in names:
            continue
        if not (force or _stale(name, src)):
            continue
        tmp = lib_path(name) + f".tmp{os.getpid()}"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, src]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        todo.append((name, tmp, cmd))
    todo.sort(key=lambda job: _rank(job[0]))
    logs = {}
    failed = []
    BUILD_SECONDS.clear()
    outs = {name: [] for name, _, _ in todo}
    t0 = time.perf_counter()
    queue = list(todo)
    workers = [threading.Thread(target=_compile, args=(queue, outs))
               for _ in range(min(len(todo), os.cpu_count() or 1))]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    for name, tmp, _ in todo:
        out, end, code = outs[name]
        BUILD_SECONDS[name] = end - t0
        logs[name] = out
        if code != 0:
            failed.append(f"{name}: nvcc exited {code}\n{out}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


# The sources by their compile time on the H100 machine's 8 cores, the
# longest first: build_all runs one nvcc a core, these in this order (a
# source not named here first), so that the longest ones never wait for
# a core and the shortest fill the cores the long ones leave.
LONGEST_FIRST = ("staged_long_forms", "staged_long", "mega_forms",
                 "spectral", "mega_long", "staged_forms", "mega_long_forms",
                 "mega", "resident_bs16", "staged", "spectral_long_forms",
                 "transpose")


def _rank(name: str) -> int:
    return LONGEST_FIRST.index(name) + 1 if name in LONGEST_FIRST else 0


def _compile(queue: list, outs: dict) -> None:
    """Run the queue's nvcc commands one after another, as long as it has
    any: outs[name] = [output, exit time, exit code]."""
    while True:
        try:
            name, _, cmd = queue.pop(0)
        except IndexError:
            return
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        text, _ = proc.communicate()
        outs[name][:] = [text, time.perf_counter(), proc.returncode]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = sources()[name]
            if _stale(name, src):
                build_all()
            lib = ctypes.CDLL(lib_path(name))
            _LIBS[name] = lib
        return lib
