#!/usr/bin/env python3
"""Garbage-collection pauses across ``chip_smoke.py``'s phases, on the card.

    python3 scripts/gc_pauses.py [--min-ms 5] [--repeats 2]

Runs ``chip_smoke.py``'s whole run (every phase and check, the build
included) in this process with a ``gc.callbacks`` hook that times every
collection. Each pause of ``--min-ms`` or longer is tagged with its
generation and with the phase whose line was printed last before it
began (so it fell in the work that leads to the next line). Phase 17, the
focusing service, then runs ``--repeats`` more times in the same process;
each pass reports the 128^2 burst's p50 / p99 beside the pauses that fell
inside it, so a burst that stalls can be set against a collection.

Prints ``chip_smoke.py``'s own lines, then one ``gc_pause`` line for each
long pause, one ``gc_pass`` line for each phase-17 pass and a ``gc_total``
line, the last. Exits with ``chip_smoke.py``'s code.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--min-ms", type=float, default=5.0)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()

    state = {"phase": "start", "pass": "run", "t0": 0.0}
    pauses = []          # (pass, phase, generation, ms)
    bursts = {}          # pass -> the 128^2 service line's latency

    def on_gc(event, info):
        if event == "start":
            state["t0"] = time.perf_counter()
            return
        ms = (time.perf_counter() - state["t0"]) * 1e3
        if ms >= args.min_ms:
            pauses.append((state["pass"], state["phase"],
                           info["generation"], ms))

    emit = chip_smoke.emit

    def tagged_emit(phase, **kw):
        state["phase"] = phase
        if phase == "service" and kw.get("scene") == [128, 128]:
            bursts[state["pass"]] = kw["latency"]
        emit(phase, **kw)

    service_phase = chip_smoke.service_phase

    def repeated_service_phase(*a, **kw):
        state["pass"] = "17.0"
        records = service_phase(*a, **kw)
        for i in range(1, args.repeats + 1):
            state["pass"] = f"17.{i}"
            service_phase(*a, **kw)
        state["pass"] = "run"
        return records

    chip_smoke.emit = tagged_emit
    chip_smoke.service_phase = repeated_service_phase
    gc.callbacks.append(on_gc)
    try:
        rc = chip_smoke.main()
    finally:
        gc.callbacks.remove(on_gc)
    # after chip_smoke's last line, so its contract's last line stays
    # where the driver reads it when this script is not the one run
    for p, phase, gen, ms in pauses:
        print(json.dumps({"phase": "gc_pause", "pass": p, "after": phase,
                          "generation": gen, "ms": ms}), flush=True)
    passes = sorted(bursts)
    for p in passes:
        print(json.dumps({
            "phase": "gc_pass", "pass": p, "burst": bursts[p],
            "pauses_ms": [ms for q, _, _, ms in pauses if q == p]}),
            flush=True)
    print(json.dumps({"phase": "gc_total", "rc": rc,
                      "min_ms": args.min_ms, "n_pauses": len(pauses),
                      "max_ms": max((ms for *_, ms in pauses), default=0.0),
                      "by_generation": {g: sorted(ms for *_, gg, ms in pauses
                                                  if gg == g)
                                        for g in (0, 1, 2)},
                      "gc_counts": gc.get_count()}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
