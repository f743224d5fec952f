"""``launch/roofline.py`` against the reference's ``repro.launch.roofline``:
the ring factors, the link bytes of the same collectives (the reference
parses them out of HLO lines, the port takes records), the record's keys,
and the H100 rates of ``tuning/cost.py``."""
import pytest

from repro.launch import roofline as ref
from repro_torch.launch import roofline as rf
from repro_torch.tuning import cost

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")
# (op, dtype, shape, replica groups as the HLO prints them, group size)
COLLECTIVES = [
    ("all-gather", "f32", (1024, 256), "{{0,1,2,3}}", 4),
    ("all-reduce", "bf16", (2048,), "{{0,1,2,3,4,5,6,7}}", 8),
    ("reduce-scatter", "f32", (64, 32), "[2,4]<=[8]", 4),
    ("all-to-all", "f32", (16, 4096), "[1,16]<=[16]", 16),
    ("collective-permute", "c64", (128, 128), "{{0,1}}", 2),
    ("all-gather", "bf16", (3, 5, 7), "[32,16]<=[512]", 16),
    ("all-reduce", "f32", (1,), "{{0}}", 1),
]
_BYTES = {"f32": 4, "bf16": 2, "c64": 8}


def hlo_line(i, op, dtype, shape, groups):
    dims = ",".join(str(d) for d in shape)
    return (f"  %{op}.{i} = {dtype}[{dims}]{{0}} {op}({dtype}[{dims}] "
            f"%p.{i}), replica_groups={groups}, dimensions={{0}}")


@pytest.mark.parametrize("op", OPS)
def test_ring_factors_are_the_references(op):
    for g in range(1, 513):
        assert rf._FACTORS[op](g) == ref._FACTORS[op](g)
    assert set(rf._FACTORS) == set(ref._FACTORS)


def test_link_bytes_equal_the_references_parse():
    text = "\n".join(hlo_line(i, op, dt, shape, groups)
                     for i, (op, dt, shape, groups, _) in
                     enumerate(COLLECTIVES))
    want = ref.parse_collectives(text, n_devices=512)
    records = []
    for op, dt, shape, _, g in COLLECTIVES:
        n = _BYTES[dt]
        for d in shape:
            n *= d
        records.append((op, n, g))
    got = rf.collective_stats(records)
    assert got.counts == want.counts
    assert got.bytes_by_op == want.bytes_by_op
    assert got.link_bytes == pytest.approx(want.link_bytes, rel=1e-12)
    assert got.total_bytes == want.total_bytes
    assert rf.from_counts(1.0, 1.0, records).collectives == got


def test_to_dict_has_the_references_keys():
    stats = rf.collective_stats([("all-gather", 4096, 4)])
    got = rf.Roofline(1e12, 2e9, stats, 5e11).to_dict()
    want = ref.Roofline(1e12, 2e9, ref.CollectiveStats(
        {"all-gather": 1}, {"all-gather": 4096}, 3072.0), 5e11).to_dict()
    assert list(got) == list(want)
    assert got["collective_link_bytes"] == want["collective_link_bytes"]
    assert got["useful_flops_fraction"] == 0.5


def test_the_rates_are_the_h100s_of_the_cost_model():
    assert rf.PEAK_FLOPS == cost.BF16_DENSE_FLOPS == 989e12
    assert rf.HBM_BW == cost.HBM_BYTES_PER_S == 3.35e12
    assert rf.LINK_BW == cost.PEAK_LINK_BYTES == 450e9
    r = rf.from_counts(989e12, 3.35e12 * 2, [("collective-permute",
                                              450e9 * 3, 2)])
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 3.0)
    assert r.bottleneck == "collective" and r.bound == 3.0


def test_an_unknown_collective_is_refused():
    with pytest.raises(ValueError):
        rf.collective_stats([("all-scatter", 8, 2)])
