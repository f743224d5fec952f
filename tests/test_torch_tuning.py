"""repro_torch.tuning on the CPU, case for case beside tests/test_tuning.py
where the case concerns the port, and held to the live reference
(``repro.tuning``) on the same numpy inputs: the search space
(``factorizations``, ``candidates``), keys, configs and schedules
(encode/decode, dicts), the cache documents and migrations (either
package's document validates in the other), the measured search with a
deterministic fake measure (same winner, same trace), the H100 cost model
and its feasibility cut (what the CUDA kernels take, nothing more), and the
compiler's resolution order (explicit args > schedule > tuned cache >
defaults), with ``fused1`` compiled through one Schedule against the
reference's interpret-mode compile through the same Schedule: 2e-4 x
max|want| at f32, 5e-2 at bf16 (the reference's tolerances,
tests/test_kernels.py).

The cache lives in a temporary file (``REPRO_TORCH_AUTOTUNE_CACHE`` via
monkeypatch); no test here times a kernel.
"""
import ast
import json
import math
import os

import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - see requirements-dev.txt
    from _hypothesis_fallback import given, settings, strategies as st

import jax.numpy as jnp
from repro import tuning as jt
from repro.core.sar import build_pipeline as jbuild
from repro.core.sar.geometry import test_scene as make_jscene

from repro_torch import tuning as tt
from repro_torch.core import plan as tplan
from repro_torch.core.sar import build_pipeline
from repro_torch.core.sar.geometry import test_scene as make_scene
from repro_torch.kernels import fft4step as tfft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.tuning import cost

F32_TOL = 2e-4
BF16_TOL = 5e-2
PORT_ROOT = os.path.join(os.path.dirname(__file__), "..", "src",
                         "repro_torch")


# the CPU named explicitly: with no device a key is the card's
CPU = dict(backend="cpu", device="cpu")


@pytest.fixture
def temp_cache(tmp_path, monkeypatch):
    """The port's tuning cache in a temporary file, its views and the
    compiled-pipeline cache cleared around the test."""
    path = str(tmp_path / "c.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    tt.clear_memory_cache()
    tplan.clear_pipeline_cache()
    yield path
    tt.clear_memory_cache()
    tplan.clear_pipeline_cache()


def scene_raw(n, seed, na=None):
    rng = np.random.default_rng(seed)
    shape = (na or n, n)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------------------
# Layering and the cache's own path
# ---------------------------------------------------------------------------

def test_port_never_imports_benchmarks():
    """The reference's layering rule, for the port's tree (JAX and the JAX
    package are tests/test_torch_imports.py's)."""
    offenders = []
    for dirpath, _, files in os.walk(PORT_ROOT):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                offenders += [f"{path}:{node.lineno}" for name in names
                              if name.split(".")[0] == "benchmarks"]
    assert not offenders


def test_cache_path_is_the_ports_own(tmp_path, monkeypatch):
    """The two packages never write one file: their own variables, and
    distinct default paths."""
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert tt.default_cache_path() == str(
        tmp_path / "repro_torch" / "autotune_cache.json")
    assert tt.default_cache_path() != jt.default_cache_path()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    assert tt.default_cache_path() != str(tmp_path / "jax.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    assert tt.default_cache_path() == str(tmp_path / "t.json")


# ---------------------------------------------------------------------------
# Keys: batch bucketing + device fingerprint
# ---------------------------------------------------------------------------

def test_batch_buckets_are_the_references():
    for b in range(1, 40):
        assert tt.bucket_batch(b) == jt.bucket_batch(b)
    assert [tt.bucket_batch(b) for b in (1, 2, 3, 5, 8, 9)] == \
        [1, 2, 4, 8, 8, 16]


def test_tune_key_normalizes_batch_and_requires_buckets():
    k3 = tt.TuneKey.kernel(512, 3, **CPU)
    k4 = tt.TuneKey.kernel(512, 4, **CPU)
    assert k3 == k4 and k3.batch == 4
    with pytest.raises(ValueError, match="bucket"):
        tt.TuneKey(kind="kernel", backend="cpu", device="cpu",
                   n=512, batch=3, lines=16)


def test_key_backend_is_the_torch_device_type():
    """With no device named a key is the card's, and raises without one,
    as every entry point of the port does; the CPU only when asked."""
    if torch.cuda.is_available():
        key = tt.TuneKey.kernel(512, 1)
        assert key.backend == "cuda"
        assert key.device == torch.cuda.get_device_name().replace(" ", "-")
    else:
        for make in (lambda: tt.TuneKey.kernel(512, 1),
                     lambda: tt.TuneKey.pipeline("fused3", 256, 256),
                     tt.default_backend, tt.device_fingerprint,
                     lambda: tt.best_config(512, tune_missing=False)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    cpu = tt.TuneKey.kernel(512, 1, backend=tt.default_backend("cpu"),
                            device=tt.device_fingerprint("cpu"))
    assert (cpu.backend, cpu.device) == ("cpu", "cpu")
    assert tt.TuneKey.kernel(512, 1, backend="cpu") == cpu


def test_padded_batch_hits_exact_batch_cache_entry(tmp_path):
    cache = tt.TuneCache(str(tmp_path / "c.json"))
    cfg = tt.KernelConfig(block=16, n1=32, n2=16)
    cache.put(tt.TuneKey.kernel(512, 4, **CPU), cfg)
    assert tt.cached_config(512, 3, cache=cache, device="cpu") == cfg
    assert tt.cached_config(512, 4, cache=cache, device="cpu") == cfg
    # bucket 8
    assert tt.cached_config(512, 5, cache=cache, device="cpu") is None


@pytest.mark.parametrize("kind", ["kernel", "pipeline"])
def test_tune_key_encode_decode_matches_reference(kind):
    """Given backend and device, the two packages write the same key."""
    kw = dict(backend="cuda", device="NVIDIA-H100-80GB-HBM3")
    if kind == "kernel":
        mine = tt.TuneKey.kernel(4096, 3, lines=16, **kw)
        theirs = jt.TuneKey.kernel(4096, 3, lines=16, **kw)
    else:
        mine = tt.TuneKey.pipeline("fused3", 256, 512, batch=2,
                                   precision="bs16", **kw)
        theirs = jt.TuneKey.pipeline("fused3", 256, 512, batch=2,
                                     precision="bs16", **kw)
    assert mine.encode() == theirs.encode()
    assert tt.TuneKey.decode(theirs.encode()) == mine
    assert jt.TuneKey.decode(mine.encode()) == theirs


def test_device_fingerprint_is_part_of_the_key(tmp_path):
    cache = tt.TuneCache(str(tmp_path / "c.json"))
    other = tt.TuneKey.kernel(512, 1, device="NVIDIA-A100", backend="cpu")
    cache.put(other, tt.KernelConfig(block=4))
    assert tt.cached_config(512, 1, cache=cache, device="cpu") is None
    cache.put(tt.TuneKey.kernel(512, 1, **CPU), tt.KernelConfig(block=4))
    assert tt.cached_config(512, 1, cache=cache, device="cpu") is not None


# ---------------------------------------------------------------------------
# KernelConfig and Schedule: the one config record, as the reference's
# ---------------------------------------------------------------------------

def test_kernel_config_spectral_kwargs_drop_deferred_knobs():
    c = tt.KernelConfig(block=8, n1=64, n2=8, karatsuba=True)
    assert c.spectral_kwargs() == {"block": 8, "n1": 64, "n2": 8,
                                   "karatsuba": True}
    assert "col_block" not in tt.KernelConfig(col_block=256).spectral_kwargs()
    assert tt.KernelConfig().spectral_kwargs() == {}


def test_kernel_config_from_dict_tolerates_legacy_extras():
    legacy = {"block": 16, "n1": 32, "n2": 16, "n3": None,
              "karatsuba": False, "precision": None, "seconds": 0.01}
    c = tt.KernelConfig.from_dict(legacy)
    assert (c.block, c.factors()) == (16, (32, 16))
    with pytest.raises(ValueError, match="power of two"):
        tt.KernelConfig(n1=96)
    with pytest.raises(ValueError, match="precision"):
        tt.KernelConfig(precision="f8")


def test_merge_overrides_replaces_factorization_wholesale():
    tuned = tt.KernelConfig(block=8, n1=64, n2=8, n3=None, precision="bf16")
    m = tuned.merge_overrides({"n1": 16, "n2": 32})
    assert m.factors() == (16, 32) and m.n3 is None
    assert m.precision == "bf16" and m.block == 8
    m2 = tuned.merge_overrides({"block": 4, "karatsuba": True})
    assert m2.factors() == (64, 8) and m2.block == 4 and m2.karatsuba


def test_spectral_op_takes_kernel_config():
    """The kernels layer takes a KernelConfig's spectral kwargs: the same
    call as spelling the spec out by hand, bit for bit, and an FFT."""
    n = 256
    rng = np.random.default_rng(0)
    xr = torch.from_numpy(rng.standard_normal((1, 8, n)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((1, 8, n)).astype(np.float32))
    cfg = tt.KernelConfig(block=4, n1=64, n2=4, karatsuba=True)
    got = tops.fft_rows(xr, xi, **cfg.spectral_kwargs())
    pinned = tfft.SpectralSpec(n=n, fwd=True, inv=False, filter_mode="none",
                               karatsuba=True)
    assert tt.KernelConfig(block=4).apply(pinned).karatsuba
    applied = cfg.apply(tfft.SpectralSpec(n=n, fwd=True, inv=False,
                                          filter_mode="none"))
    assert (applied.n1, applied.n2, applied.karatsuba) == (64, 4, True)
    want = tops.fft_rows(xr, xi, block=4, n1=64, n2=4, karatsuba=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    wr, wi = tref.fft_ref(xr[0], xi[0], axis=1)
    np.testing.assert_allclose(got[0][0].numpy(), wr.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[1][0].numpy(), wi.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_configs_and_schedules_match_reference_dicts():
    cfg = dict(block=8, n1=64, n2=64, n3=None, karatsuba=True,
               precision="bs16", col_block=128, residency="staged",
               phase_block=8, buffer_depth=2)
    assert tt.KernelConfig(**cfg).to_dict() == jt.KernelConfig(**cfg).to_dict()
    segs = ((64, 64, None, True), (128, 32, None, False), (64, 64, None, None))
    mine = tt.Schedule(segments=tuple(tt.SegmentConfig(*s) for s in segs),
                       precision="bf16", residency="staged", phase_block=8,
                       buffer_depth=2)
    theirs = jt.Schedule(segments=tuple(jt.SegmentConfig(*s) for s in segs),
                         precision="bf16", residency="staged",
                         phase_block=8, buffer_depth=2)
    assert mine.to_dict() == theirs.to_dict()
    assert tt.Schedule.from_dict(theirs.to_dict()) == mine
    assert mine.to_config().to_dict() == theirs.to_config().to_dict()


# ---------------------------------------------------------------------------
# The search space
# ---------------------------------------------------------------------------

def test_factorizations_invariants_and_reference_up_to_2_21():
    n = 2
    while n <= 2 ** 21:
        fs = tt.factorizations(n)
        assert fs == jt.factorizations(n), n
        for f in fs:
            assert list(f) == sorted(f, reverse=True), (n, f)
            assert all(x <= tfft.MAX_FACTOR for x in f), (n, f)
            assert math.prod(f) == n, (n, f)
        kick_in = n > tfft.MAX_FACTOR ** 2
        assert all((len(f) == 3) == kick_in for f in fs), (n, fs)
        n *= 2


def test_factorizations_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tt.factorizations(96)


@pytest.mark.parametrize("n", [64, 512, 4096, 8192])
def test_candidates_equal_reference_as_dicts(n):
    kw = dict(blocks=(4, 8, 16), precisions=("f32", "bf16", "bs16"))
    assert [c.to_dict() for c in tt.candidates(n, **kw)] == \
        [c.to_dict() for c in jt.candidates(n, **kw)]


# ---------------------------------------------------------------------------
# The H100 cost model and its feasibility cut
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch", [(512, 1), (4096, 1), (4096, 4)])
def test_cost_model_ranks_known_best_in_top3(n, batch):
    key = tt.TuneKey.kernel(n, batch, **CPU)
    ranked = cost.rank(tt.candidates(n), key)
    top3 = [c.factors() for c in ranked[:3]]
    assert tfft.default_factorization(n) in top3, top3


def test_feasibility_cut_admits_what_the_kernels_take():
    """The cut never empties a space the kernel takes (every N <= 4096) and
    admits nothing it refuses: past 4096 a line needs a three-factor
    split or more than one block's shared memory (ROADMAP Queue 2 1d), so
    the ranking is empty there."""
    n = 2
    while n <= 2 ** 16:
        key = tt.TuneKey.kernel(n, 1, **CPU)
        space = tt.candidates(n, precisions=("f32", "bf16", "f16", "bs16"))
        for c in space:
            spec = c.apply(tfft.SpectralSpec(n=n, fwd=True, inv=True,
                                             filter_mode="shared"))
            try:
                tops.check_kernel_spec(spec)
                takes = True
            except ValueError:
                takes = False
            assert cost.structurally_feasible(c, key) == takes, (n, c)
            if takes:
                assert cost.feasible(c, key)
        assert bool(cost.rank(space, key)) == (n <= tops.KERNEL_MAX_N), n
        n *= 2


def test_cost_model_is_finite_positive_and_orders_precisions():
    key = tt.TuneKey.kernel(4096, 4, **CPU)
    t = {p: cost.predicted_seconds(
        tt.KernelConfig(block=8, n1=64, n2=64, precision=p), key)
        for p in ("f32", "bf16", "f16", "bs16")}
    assert 0 < t["bf16"] == t["f16"] <= t["bs16"] <= t["f32"] < 1.0
    kara = cost.predicted_seconds(
        tt.KernelConfig(block=8, n1=64, n2=64, karatsuba=True), key)
    assert kara < t["f32"]
    assert cost.nominal_flops(key) > 0
    # bf16 and f16 run one pass at twice the TF32 rate; f32 three passes
    assert cost._PRECISION_SPEEDUP["bf16"] == pytest.approx(
        3 * cost.BF16_DENSE_FLOPS / cost.TF32_DENSE_FLOPS)


def test_block_only_pads_so_configs_of_one_kernel_price_alike():
    key = tt.TuneKey.kernel(4096, 1, lines=16, **CPU)
    times = {cost.predicted_seconds(tt.KernelConfig(block=b, n1=64, n2=64),
                                    key) for b in (4, 8, 16)}
    assert len(times) == 1


def test_cost_breakdown_sums_its_terms():
    br = cost.cost_breakdown(tt.KernelConfig(n1=64, n2=64),
                             tt.TuneKey.kernel(4096, 1, **CPU))
    assert br["structurally_feasible"] and br["vmem_feasible"]
    assert br["predicted_seconds"] == pytest.approx(
        br["compute_seconds"] + br["memory_seconds"])


def test_mega_residency_is_the_kernels_cut():
    assert cost.mega_residency is tops.mega_residency
    assert cost.mega_residency(128, 128) == "vmem"
    assert cost.mega_residency(256, 256) == "staged"


def test_schedule_cut_is_check_mega_kernel():
    """A scene over one block's shared memory is not a resident lane; a
    three-factor or over-long segment is no lane at all."""
    segs = (tt.SegmentShape(0, fwd=True),
            tt.SegmentShape(1, fwd=True, inv=True, filtered=True),
            tt.SegmentShape(0, inv=True, filtered=True))
    big = tt.ScheduleProblem.mega_2d(4096, 4096, segs)
    small = tt.ScheduleProblem.mega_2d(128, 128, segs)
    three = tt.SegmentConfig()
    for res, prob, want in (("vmem", big, False), ("staged", big, True),
                            ("vmem", small, True), ("staged", small, True)):
        s = tt.Schedule(segments=(three,) * 3, residency=res,
                        precision="bs16")
        assert cost.schedule_structurally_feasible(s, prob) == want
        assert cost.schedule_feasible(s, prob) == want
    odd = tt.Schedule(segments=(tt.SegmentConfig(128, 32, None, True),) * 3,
                      residency="staged")
    assert cost.schedule_structurally_feasible(odd, big)
    assert not cost.schedule_structurally_feasible(odd, small)


# ---------------------------------------------------------------------------
# Cache: schema, migration, validation, the reference's documents
# ---------------------------------------------------------------------------

def _legacy_doc():
    return {
        "cpu_B3_n512": {"block": 8, "n1": 32, "n2": 16, "n3": None,
                        "karatsuba": False, "precision": None,
                        "seconds": 0.010},
        "cpu_B4_n512": {"block": 16, "n1": 64, "n2": 8, "n3": None,
                        "karatsuba": True, "precision": None,
                        "seconds": 0.005},
        "cpu_B1_n4096": {"block": 4, "n1": 64, "n2": 64, "n3": None,
                         "karatsuba": False, "precision": "bf16",
                         "seconds": 0.020},
        "garbage": "not-a-config",
    }


def test_cache_migrates_legacy_flat_format(tmp_path):
    path = str(tmp_path / "autotune_cache.json")
    with open(path, "w") as f:
        json.dump(_legacy_doc(), f)
    cache = tt.TuneCache(path)
    hit = cache.get(tt.TuneKey.kernel(512, 3, backend="cpu", device="cpu"))
    assert hit is not None and hit.factors() == (64, 8) and hit.karatsuba
    hit2 = cache.get(tt.TuneKey.kernel(4096, 1, backend="cpu", device="cpu"))
    assert hit2 is not None and hit2.precision == "bf16"
    cache.put(tt.TuneKey.kernel(256, 1, **CPU), tt.KernelConfig(block=8))
    with open(path) as f:
        doc = json.load(f)
    assert doc["schema"] == tt.CACHE_SCHEMA
    tt.validate_cache_doc(doc)
    assert len(doc["entries"]) == 3


def test_migrations_give_the_references_documents(monkeypatch):
    """Both migrators on the same input give equal documents (the device
    stamp pinned to one string; the timestamps set aside)."""
    monkeypatch.setattr("repro_torch.tuning.cache.device_fingerprint",
                        lambda device=None: "cpu")
    monkeypatch.setattr("repro.tuning.cache.device_fingerprint",
                        lambda: "cpu")

    def strip(doc):
        return {k: {f: v for f, v in e.items() if f != "updated_utc"}
                for k, e in doc["entries"].items()}

    mine = tt.migrate_legacy_doc(_legacy_doc())
    theirs = jt.migrate_legacy_doc(_legacy_doc())
    assert mine["schema"] == theirs["schema"]
    assert strip(mine) == strip(theirs)
    s1 = {"schema": 1, "entries": {
        tt.TuneKey.kernel(512, 1, backend="cpu", device="cpu").encode(): {
            "config": {"block": 8}, "seconds": 0.1}}}
    assert tt.migrate_schema1_doc(s1) == jt.migrate_schema1_doc(s1)


def test_cache_documents_validate_across_packages(tmp_path):
    """A document either package writes validates in the other, and reads
    back as the same configs and schedules."""
    kw = dict(backend="cuda", device="NVIDIA-H100-80GB-HBM3")
    sched = dict(segments=[dict(n1=64, n2=64, n3=None, karatsuba=True)] * 3,
                 precision="bs16", residency="staged", phase_block=8,
                 buffer_depth=2)
    cfg = dict(block=8, n1=128, n2=32, karatsuba=False, precision="bf16")
    mine, theirs = tt.TuneCache(str(tmp_path / "t.json")), \
        jt.TuneCache(str(tmp_path / "j.json"))
    mine.put(tt.TuneKey.kernel(4096, 1, **kw), tt.KernelConfig(**cfg))
    mine.put_schedule(tt.TuneKey.kernel(256, 2, **kw),
                      tt.Schedule.from_dict(sched))
    theirs.put(jt.TuneKey.kernel(4096, 1, **kw), jt.KernelConfig(**cfg))
    theirs.put_schedule(jt.TuneKey.kernel(256, 2, **kw),
                        jt.Schedule.from_dict(sched))
    for a, b in ((mine, jt), (theirs, tt)):
        b.validate_cache_doc(json.loads(json.dumps(a.doc())))
    strip = [{k: {f: v for f, v in e.items() if f != "updated_utc"}
              for k, e in c.doc()["entries"].items()} for c in (mine, theirs)]
    assert strip[0] == strip[1]


def test_cache_validation_rejects_malformed_docs():
    ok = {"schema": 1, "entries": {
        tt.TuneKey.kernel(512, 1, **CPU).encode(): {"config": {"block": 8},
                                             "seconds": 0.1}}}
    tt.validate_cache_doc(ok)
    with pytest.raises(ValueError, match="schema"):
        tt.validate_cache_doc({"schema": 99, "entries": {}})
    with pytest.raises(ValueError, match="entries"):
        tt.validate_cache_doc({"schema": 1})
    with pytest.raises(ValueError, match="TuneKey|malformed"):
        tt.validate_cache_doc({"schema": 1, "entries": {"bad key": {
            "config": {}}}})
    with pytest.raises(ValueError, match="config"):
        tt.validate_cache_doc(
            {"schema": 1,
             "entries": {tt.TuneKey.kernel(8, 1, **CPU).encode(): {}}})


def test_cache_in_process_layer_rereads_on_file_change(tmp_path):
    path = str(tmp_path / "c.json")
    a = tt.TuneCache(path)
    key = tt.TuneKey.kernel(512, 1, **CPU)
    assert a.get(key) is None
    tt.TuneCache(path).put(key, tt.KernelConfig(block=16))
    got = a.get(key)
    assert got is not None and got.block == 16


def test_cache_quarantines_truncated_json_and_rebuilds(tmp_path, caplog):
    import logging
    path = str(tmp_path / "c.json")
    cache = tt.TuneCache(path)
    key = tt.TuneKey.kernel(512, 1, **CPU)
    cache.put(key, tt.KernelConfig(block=16))
    with open(path, "r+b") as f:
        f.truncate(17)
    cache._mtime = None
    with caplog.at_level(logging.WARNING, logger="repro_torch.tuning.cache"):
        assert cache.get(key) is None
        assert cache.get(key) is None
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    warned = [r for r in caplog.records if "quarantined" in r.getMessage()]
    assert len(warned) == 1
    cache.put(key, tt.KernelConfig(block=32))
    assert tt.TuneCache(path).get(key).block == 32


def test_cache_quarantines_wrong_shape_json(tmp_path):
    path = str(tmp_path / "c.json")
    with open(path, "w") as f:
        json.dump([1, 2, 3], f)
    assert tt.TuneCache(path).get(tt.TuneKey.kernel(512, 1, **CPU)) is None
    assert os.path.exists(path + ".corrupt")


def test_cache_schema1_migrates_to_schema2_without_research(tmp_path,
                                                           monkeypatch):
    key = tt.TuneKey.kernel(512, 1, **CPU)
    cfg = tt.KernelConfig(block=16, n1=32, n2=16, karatsuba=True)
    path = str(tmp_path / "c.json")
    with open(path, "w") as f:
        json.dump({"schema": 1, "entries": {key.encode(): {
            "config": cfg.to_dict(), "seconds": 3.25e-4,
            "source": "search", "updated_utc": "2026-01-01T00:00:00Z"}}}, f)

    def boom(*a, **k):
        raise AssertionError("re-searched a migrated schema-1 entry")

    monkeypatch.setattr(tt, "measured_search", boom)
    monkeypatch.setattr(tt, "search_kernel", boom)
    cache = tt.TuneCache(path)
    assert cache.doc()["schema"] == tt.CACHE_SCHEMA == 2
    assert cache.get(key) == cfg
    assert cache.get_schedule(key) == tt.Schedule.from_config(cfg)
    assert cache.get_entry(key)["seconds"] == 3.25e-4
    cache.put(tt.TuneKey.kernel(256, 1, **CPU), tt.KernelConfig(block=8))
    with open(path) as f:
        ondisk = json.load(f)
    assert ondisk["schema"] == 2
    assert ondisk["entries"][key.encode()]["config"] == cfg.to_dict()


def test_cache_schedule_roundtrip_and_flat_view(tmp_path):
    path = str(tmp_path / "c.json")
    key = tt.TuneKey.kernel(256, 1, **CPU)
    sched = tt.Schedule(
        segments=(tt.SegmentConfig(16, 16, None, True),
                  tt.SegmentConfig(8, 32, None, False)),
        block=8, precision="f32", residency="staged", phase_block=8,
        buffer_depth=2)
    tt.TuneCache(path).put_schedule(key, sched, seconds=1e-3)
    fresh = tt.TuneCache(path)
    assert fresh.get_schedule(key) == sched
    flat = fresh.get(key)
    assert flat == sched.to_config() and flat.n1 is None
    assert flat.residency == "staged" and flat.buffer_depth == 2
    tt.validate_cache_doc(fresh.doc())


# ---------------------------------------------------------------------------
# The guided search
# ---------------------------------------------------------------------------

def _fake_measure(times):
    calls = []

    def measure(cand, iters):
        calls.append(cand)
        return times[cand]

    return measure, calls


def test_search_times_strictly_fewer_candidates_and_finds_best(tmp_path):
    key = tt.TuneKey.kernel(512, 1, **CPU)
    space = tt.candidates(512)
    best = cost.rank(space, key)[1]             # inside the measured part
    times = {c: (0.5 if c == best else 1.0 + i * 0.01)
             for i, c in enumerate(space)}
    measure, _ = _fake_measure(times)
    cache = tt.TuneCache(str(tmp_path / "c.json"))
    res = tt.search_kernel(key, measure=measure, cache=cache)
    assert res.config == best
    assert res.measured < len(space) and res.measured <= res.space
    assert res.predicted_rank == 1
    assert tt.cached_config(512, 1, cache=cache, device="cpu") == best


def test_search_respects_snr_gate_without_timing_gated_configs():
    key = tt.TuneKey.kernel(256, 1, **CPU)
    space = tt.candidates(256, precisions=("f32", "bs16"))
    measure, calls = _fake_measure({c: 1.0 for c in space})
    gate_calls = []

    def gate(p):
        gate_calls.append(p)
        return 9.9

    res = tt.search_kernel(key, precisions=("f32", "bs16"), measure=measure,
                           gate=gate, persist=False)
    assert gate_calls == ["bs16"]
    assert all(c.precision == "f32" for c in calls)
    assert res.config.precision == "f32"


def test_measured_search_drops_raising_candidates():
    def measure(cand, iters):
        if cand == "bad":
            raise RuntimeError("refused at launch")
        return {"a": 3.0, "b": 1.0}[cand]

    best, t, trace = tt.measured_search(["bad", "a", "b"], measure,
                                        rungs=(1,))
    assert best == "b" and t == 1.0
    assert ("bad", None) in trace


def test_measured_search_matches_reference():
    """One deterministic measure over the same candidates and rungs: the
    same winner, the same time and the same trace as the reference."""
    cands = [tt.KernelConfig(block=b, n1=f[0], n2=f[1], karatsuba=k)
             for f in tt.factorizations(1024) for b in (4, 8, 16)
             for k in (False, True)]

    def measure(c, iters):
        return (c.n1 * 7 + c.block * 3 + int(c.karatsuba)) % 11 + iters

    def as_ref(c):
        return jt.KernelConfig(**c.to_dict())

    best, t, trace = tt.measured_search(cands, measure, max_measure=9,
                                        rungs=(1, 2, 3))
    jbest, jt_, jtrace = jt.measured_search(
        [as_ref(c) for c in cands], lambda c, i: measure(
            tt.KernelConfig(**c.to_dict()), i), max_measure=9,
        rungs=(1, 2, 3))
    assert best.to_dict() == jbest.to_dict() and t == jt_
    assert [(c.to_dict(), s) for c, s in trace] == \
        [(c.to_dict(), s) for c, s in jtrace]


def test_timeit_enforces_repeat_floor():
    from repro_torch.tuning import search as searchlib
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(())

    searchlib._timeit(fn, warmup=1, iters=1)
    assert len(calls) == 1 + max(1, tt.TIMING_REPEATS_FLOOR)
    calls.clear()
    searchlib._timeit(fn, warmup=0, iters=tt.TIMING_REPEATS_FLOOR + 4)
    assert len(calls) == tt.TIMING_REPEATS_FLOOR + 4


def test_kernel_measure_times_the_rows_launch_on_the_keys_device():
    key = tt.TuneKey.kernel(64, 1, lines=8, backend="cpu", device="cpu")
    measure = tt.kernel_measure(key)
    assert measure(tt.KernelConfig(block=4, n1=8, n2=8, karatsuba=True),
                   1) > 0


def test_graph_search_finds_flat_inexpressible_schedule():
    problem = tt.ScheduleProblem.mega_2d(
        na=64, nr=256,
        segments=(tt.SegmentShape(0, fwd=True),
                  tt.SegmentShape(1, fwd=True, inv=True, filtered=True),
                  tt.SegmentShape(0, inv=True, filtered=True)))

    def measure(s, iters):
        return cost.schedule_seconds(s, problem)

    res = tt.search_schedule(problem, k=8, measure=measure, persist=False)
    win = res.schedule
    assert win is not None and len(win.segments) == 3
    assert not win.uniform() and win.to_config().n1 is None

    def flat_schedule(c):
        segs = []
        for shp in problem.segments:
            if shp.axis == 1:
                segs.append(tt.SegmentConfig(c.n1, c.n2, c.n3,
                                             bool(c.karatsuba)))
            else:
                f = (tuple(tfft.default_factorization(problem.na))
                     + (None,))[:3]
                segs.append(tt.SegmentConfig(*f, bool(c.karatsuba)))
        return tt.Schedule(
            segments=tuple(segs), block=c.block, precision=c.precision,
            residency=win.residency, phase_block=win.phase_block,
            buffer_depth=win.buffer_depth)

    flats = [flat_schedule(c) for c in tt.candidates(problem.nr)]
    assert cost.schedule_seconds(win, problem) <= min(
        cost.schedule_seconds(s, problem) for s in flats)
    assert res.seconds <= min(measure(s, 1) for s in flats)


def test_frontier_offers_no_lane_the_kernels_refuse():
    """At 4096^2 the resident lane does not fit one block: every path of
    the frontier is staged, and each is one the kernels take."""
    problem = tt.ScheduleProblem.mega_2d(
        4096, 4096, (tt.SegmentShape(0, fwd=True),
                     tt.SegmentShape(1, fwd=True, inv=True, filtered=True),
                     tt.SegmentShape(0, inv=True, filtered=True)))
    frontier = tt.schedule_frontier(problem, k=8,
                                    precisions=("f32", "bs16"))
    assert len(frontier) == 8
    assert {s.residency for s in frontier} == {"staged"}
    assert all(cost.schedule_feasible(s, problem) for s in frontier)


# ---------------------------------------------------------------------------
# The compiler: tune, fft_kw, schedule, cached_pipeline
# ---------------------------------------------------------------------------

def test_plan_compile_resolves_config_through_tuning(temp_cache):
    """A distinctive config in the tuning cache reaches the range launches'
    knobs, and the image equals compiling with the same config explicitly
    (fft_kw), bit for bit."""
    import dataclasses
    cfg = dataclasses.replace(make_scene(128), na=64)
    raw = scene_raw(128, 7, na=64)
    tuned = tt.KernelConfig(block=4, n1=16, n2=8, karatsuba=True)
    tt.get_cache().put(tt.TuneKey.kernel(
        128, 1, backend="cpu", device=tt.device_fingerprint("cpu")), tuned)
    pipe = build_pipeline(cfg, "fused3", device="cpu")
    rows = [s for s in pipe.steps
            if s.kind == "spectral" and s.phys_axis == 1]
    assert rows
    for s in rows:
        kk = s.kernel_kw
        assert (kk["n1"], kk["n2"], kk["block"], kk["karatsuba"]) == \
            (16, 8, 4, True), kk
    explicit = build_pipeline(cfg, "fused3", device="cpu", tune="off",
                              fft_kw=dict(block=4, n1=16, n2=8,
                                          karatsuba=True))
    assert torch.equal(pipe.run(raw), explicit.run(raw))


@pytest.mark.parametrize("variant", ["fused3", "fused1", "csa_fused",
                                     "omegak_fused1"])
def test_empty_cache_compiles_identically_to_tune_off(temp_cache, variant):
    cfg = make_scene(128)
    raw = scene_raw(128, 11)
    a = build_pipeline(cfg, variant, device="cpu")
    b = build_pipeline(cfg, variant, device="cpu", tune="off")
    assert [s.kernel_kw for s in a.steps] == [s.kernel_kw for s in b.steps]
    assert torch.equal(a.run(raw), b.run(raw))


def test_explicit_args_win_over_schedule_over_cache(temp_cache):
    cfg = make_scene(128)
    tt.get_cache().put(tt.TuneKey.kernel(
        128, 1, backend="cpu", device="cpu"),
        tt.KernelConfig(n1=32, n2=4, precision="bf16", karatsuba=True))
    sched = tt.Schedule(segments=(tt.SegmentConfig(64, 2, None, False),) * 3,
                        precision="f16")
    pipe = build_pipeline(cfg, "fused3", device="cpu", schedule=sched,
                          precision="bs16", fft_kw=dict(n1=128, n2=1))
    kk = [s.kernel_kw for s in pipe.steps]
    assert [k["precision"] for k in kk] == ["bs16"] * 3
    assert [(k["n1"], k["n2"]) for k in kk] == [(64, 2), (128, 1), (64, 2)]
    assert [k["karatsuba"] for k in kk] == [False] * 3
    pipe = build_pipeline(cfg, "fused3", device="cpu", schedule=sched)
    assert [s.kernel_kw["precision"] for s in pipe.steps] == ["f16"] * 3
    pipe = build_pipeline(cfg, "fused3", device="cpu")
    assert [(s.kernel_kw["n1"], s.kernel_kw["karatsuba"],
             s.kernel_kw["precision"]) for s in pipe.steps] == \
        [(32, True, "bf16")] * 3


def test_plan_compiles_through_schedule_to_kernel(temp_cache):
    cfg = make_scene(128)
    sched = tt.Schedule(
        segments=(tt.SegmentConfig(16, 8, None, True),
                  tt.SegmentConfig(8, 16, None, False),
                  tt.SegmentConfig(8, 16, None, None)),
        residency="staged", phase_block=8, buffer_depth=3)
    pipe = build_pipeline(cfg, "fused1", device="cpu", schedule=sched)
    (step,) = pipe.steps
    kk = step.kernel_kw
    assert kk["residency"] == "staged" and kk["buffer_depth"] == 3
    assert [rec[4:] for rec in kk["segments"]] == [
        (16, 8, None, True), (8, 16, None, False), (8, 16, None, None)]
    raw = scene_raw(128, 3)
    img = pipe.run(raw).numpy()
    ref_img = build_pipeline(cfg, "fused1", device="cpu",
                             tune="off").run(raw).numpy()
    scale = max(1.0, float(np.abs(ref_img).max()))
    np.testing.assert_allclose(img, ref_img, atol=F32_TOL * scale, rtol=0)


@pytest.mark.parametrize("precision,tol", [("f32", F32_TOL),
                                           ("bf16", BF16_TOL)])
def test_fused1_through_a_schedule_matches_reference(temp_cache, precision,
                                                     tol):
    """fused1 at 128^2 compiled through one Schedule with per-segment
    splits and Karatsuba — carried to the reference by to_dict /
    from_dict — against the reference's interpret-mode compile through
    the same Schedule."""
    sched = tt.Schedule(
        segments=(tt.SegmentConfig(32, 4, None, True),
                  tt.SegmentConfig(8, 16, None, False),
                  tt.SegmentConfig(16, 8, None, True)),
        precision=precision, residency="vmem")
    raw = scene_raw(128, 5)
    mine = build_pipeline(make_scene(128), "fused1", device="cpu",
                          schedule=tt.Schedule.from_dict(sched.to_dict()))
    assert [rec[4:] for rec in mine.steps[0].kernel_kw["segments"]] == [
        (32, 4, None, True), (8, 16, None, False), (16, 8, None, True)]
    theirs = jbuild(make_jscene(128), "fused1", tune="off",
                    schedule=jt.Schedule.from_dict(sched.to_dict()))
    got = mine.run(raw).numpy()
    want = np.asarray(theirs.run(jnp.asarray(raw)))
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


def test_cached_pipeline_returns_the_same_pipeline(temp_cache):
    cfg = make_scene(128)
    a = tplan.cached_pipeline(cfg, "fused3", device="cpu",
                              fft_kw={"n1": 16, "n2": 8})
    b = tplan.cached_pipeline(cfg, "fused3", device="cpu",
                              fft_kw={"n1": 16, "n2": 8})
    c = tplan.cached_pipeline(cfg, "fused3", device="cpu")
    assert a is b and a is not c
    tplan.clear_pipeline_cache()
    assert tplan.cached_pipeline(cfg, "fused3", device="cpu",
                                 fft_kw={"n1": 16, "n2": 8}) is not a


def test_tune_takes_cached_or_off():
    with pytest.raises(ValueError, match="tune"):
        build_pipeline(make_scene(128), "fused3", device="cpu", tune="full")


# ---------------------------------------------------------------------------
# Property tests: key/config/schedule round-trips (hypothesis or fallback)
# ---------------------------------------------------------------------------

_PROP_NS = (64, 128, 256, 512, 1024)


@settings(max_examples=30, deadline=None)
@given(kind=st.sampled_from([tt.KIND_KERNEL, tt.KIND_PIPELINE]),
       n=st.sampled_from(_PROP_NS), bexp=st.integers(0, 6),
       lines=st.sampled_from([16, 64, 128]),
       precision=st.sampled_from([None, "f32", "bf16", "bs16"]),
       variant=st.sampled_from([None, "fused3", "csa_fused"]))
def test_prop_tune_key_encode_decode_roundtrip(kind, n, bexp, lines,
                                               precision, variant):
    key = tt.TuneKey(kind=kind, backend="cuda", device="H100", n=n,
                     batch=2 ** bexp, lines=lines, precision=precision,
                     variant=variant)
    assert tt.TuneKey.decode(key.encode()) == key
    assert jt.TuneKey.decode(key.encode()).encode() == key.encode()


@settings(max_examples=40, deadline=None)
@given(n=st.sampled_from(_PROP_NS), fi=st.integers(0, 10 ** 6),
       block=st.sampled_from([None, 4, 8, 16]),
       karatsuba=st.sampled_from([None, False, True]),
       precision=st.sampled_from([None, "f32", "bf16", "bs16"]),
       col_block=st.sampled_from([None, 128, 256]),
       residency=st.sampled_from([None, "vmem", "staged"]),
       phase_block=st.sampled_from([None, 8, 16]),
       buffer_depth=st.sampled_from([None, 1, 2, 3]))
def test_prop_kernel_config_dict_roundtrip(n, fi, block, karatsuba,
                                           precision, col_block, residency,
                                           phase_block, buffer_depth):
    fs = tt.factorizations(n)
    f = (tuple(fs[fi % len(fs)]) + (None,))[:3]
    cfg = tt.KernelConfig(block=block, n1=f[0], n2=f[1], n3=f[2],
                          karatsuba=karatsuba, precision=precision,
                          col_block=col_block, residency=residency,
                          phase_block=phase_block, buffer_depth=buffer_depth)
    assert tt.KernelConfig.from_dict(cfg.to_dict()) == cfg
    assert tt.KernelConfig.from_dict(
        json.loads(json.dumps(cfg.to_dict()))) == cfg
    assert jt.KernelConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()


@settings(max_examples=30, deadline=None)
@given(n=st.sampled_from(_PROP_NS), nseg=st.integers(1, 3),
       fi=st.integers(0, 10 ** 6),
       karatsuba=st.sampled_from([None, False, True]),
       residency=st.sampled_from([None, "vmem", "staged"]),
       buffer_depth=st.sampled_from([None, 1, 2]))
def test_prop_schedule_dict_roundtrip(n, nseg, fi, karatsuba, residency,
                                      buffer_depth):
    fs = tt.factorizations(n)
    segs = tuple(
        tt.SegmentConfig(*(tuple(fs[(fi + i) % len(fs)]) + (None,))[:3],
                         karatsuba=karatsuba)
        for i in range(nseg))
    s = tt.Schedule(segments=segs, block=8, residency=residency,
                    buffer_depth=buffer_depth)
    assert tt.Schedule.from_dict(s.to_dict()) == s
    assert tt.Schedule.from_dict(json.loads(json.dumps(s.to_dict()))) == s
    assert jt.Schedule.from_dict(s.to_dict()).to_dict() == s.to_dict()


def test_kernel_config_is_degenerate_one_segment_schedule():
    cfg = tt.KernelConfig(block=8, n1=32, n2=16, karatsuba=True,
                          residency="staged", phase_block=8, buffer_depth=2)
    s = tt.Schedule.from_config(cfg)
    assert s.uniform() and s.to_config() == cfg
    multi = tt.Schedule(segments=(tt.SegmentConfig(32, 16),
                                  tt.SegmentConfig(16, 32)), block=8)
    assert not multi.uniform() and multi.to_config().n1 is None
