"""Three-term roofline of a dry-run step on one device (NVIDIA H100 SXM
targets, the spec sheet's rates as ``tuning/cost.py`` holds them).

  compute term    = FLOPs / 989e12 FLOP/s (dense BF16)
  memory term     = HBM bytes / 3.35e12 B/s (HBM3)
  collective term = per-device link bytes / 450e9 B/s (NVLink 4, one way)

The port's counterpart of ``repro.launch.roofline``. The reference reads
FLOPs and bytes from XLA's ``cost_analysis()`` and parses its collectives
out of the post-SPMD HLO text; the port has no HLO, so every term comes
from counts: FLOPs and bytes from the aten ops a device runs on meta
tensors, and the collectives from records of the copies between mesh
positions (``launch/dryrun.py``'s ``MetaCounter``), each
``(op, bytes, group size)``. The bytes of a record are what the
reference's parser reads off an HLO line, the op's output, scaled by the
same ring-transfer factor on the group size g:
  all-reduce      2 (g-1)/g        (reduce-scatter + all-gather phases)
  all-gather      (g-1)/g          (on the gathered output bytes)
  reduce-scatter  (g-1)/g          (on the scattered output bytes)
  all-to-all      (g-1)/g
  collective-permute  1
The counts are one device's (the busiest mesh position's), so each term
is that device's step latency directly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from repro_torch.tuning.cost import (BF16_DENSE_FLOPS, HBM_BYTES_PER_S,
                                     PEAK_LINK_BYTES)

PEAK_FLOPS = BF16_DENSE_FLOPS     # dense bf16 per card
HBM_BW = HBM_BYTES_PER_S          # bytes/s per card
LINK_BW = PEAK_LINK_BYTES         # bytes/s a card sends over NVLink

_FACTORS = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_op: dict
    link_bytes: float      # ring-model per-device bytes over the slowest link

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def collective_stats(records: Iterable) -> CollectiveStats:
    """``CollectiveStats`` of ``(op, bytes, group_size)`` records, priced
    as the reference prices its HLO lines (a record of no bytes is
    skipped, as the reference skips such a line)."""
    counts: dict = {}
    bytes_by_op: dict = {}
    link = 0.0
    for op, nbytes, group in records:
        if op not in _FACTORS:
            raise ValueError(f"unknown collective {op!r}")
        if nbytes == 0:
            continue
        counts[op] = counts.get(op, 0) + 1
        bytes_by_op[op] = bytes_by_op.get(op, 0) + nbytes
        link += _FACTORS[op](max(int(group), 1)) * nbytes
    return CollectiveStats(counts, bytes_by_op, link)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collectives: CollectiveStats
    model_flops: Optional[float] = None   # analytic 6*N*D (or 6*N_active*D)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collectives.link_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        """Roofline step-time lower bound (max of the three terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / self.flops

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_counts": self.collectives.counts,
            "collective_bytes_by_op": self.collectives.bytes_by_op,
            "collective_link_bytes": self.collectives.link_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_bound_s": self.bound,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
        }


def from_counts(flops: float, hbm_bytes: float, collectives,
                model_flops: Optional[float] = None) -> Roofline:
    """A roofline of one device's counts; ``collectives`` is a
    ``CollectiveStats`` or its ``(op, bytes, group_size)`` records."""
    if not isinstance(collectives, CollectiveStats):
        collectives = collective_stats(collectives)
    return Roofline(float(flops), float(hbm_bytes), collectives, model_flops)
