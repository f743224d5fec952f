"""repro_torch SAR slice vs the JAX reference on the CPU: geometry,
filters, simulator, the plan compiler, and the RDA ``fused3`` /
``fused_tfree`` / ``unfused`` pipelines on the 128^2 point-target scene
(``fused1``: tests/test_torch_fused1.py).

Both packages focus the SAME numpy raw scene (the reference's
``simulate_cached``), so simulator noise never hides focusing drift.
Pipelines are held to the reference by ``metrics``: the same peak pixels,
|dSNR| <= 0.1 dB (the serving gate), L2 relative error <= 1e-3.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import plan as jplan
from repro.core.sar import build_pipeline as jbuild
from repro.core.sar import filters as jfilters
from repro.core.sar import metrics as jmetrics
from repro.core.sar import paper_targets as jtargets
from repro.core.sar import rda as jrda
from repro.core.sar import simulate_cached as jsimulate_cached
from repro.core.sar.geometry import test_scene as make_jscene

import repro_torch.core.sar as P
from repro_torch.core import plan as tplan
from repro_torch.core.sar import filters as tfilters
from repro_torch.core.sar import metrics as tmetrics
from repro_torch.core.sar import rda as trda
from repro_torch.core.sar.geometry import test_scene as make_tscene

N = 128
GUARD = 16          # the golden corpus's guard width at 128^2
GATE_DB = 0.1
VARIANTS = ["fused3", "fused_tfree", "unfused"]
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "point_targets_n128.json")

_cache = {}


def jscene():
    if "raw" not in _cache:
        cfg = make_jscene(N)
        _cache["cfg"] = cfg
        _cache["targets"] = jtargets(cfg)
        _cache["raw"] = np.array(jsimulate_cached(cfg, _cache["targets"]),
                                 np.complex64)
    return _cache["cfg"], _cache["targets"], _cache["raw"]


def tcfg():
    return P.scene_from_dict(dataclasses.asdict(jscene()[0]))


def ref_image(variant):
    key = ("ref", variant)
    if key not in _cache:
        cfg, _, raw = jscene()
        _cache[key] = np.asarray(
            jbuild(cfg, variant, tune="off").run(jnp.asarray(raw)))
    return _cache[key]


def port_image(variant, **kw):
    _, _, raw = jscene()
    pipe = P.build_pipeline(tcfg(), variant, device="cpu", **kw)
    return pipe.run(torch.from_numpy(raw)).numpy()


# ---------------------------------------------------------------------------
# Geometry, filters, simulator
# ---------------------------------------------------------------------------

def test_scene_from_dict_round_trips_reference_config():
    jcfg = jscene()[0]
    cfg = tcfg()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg == make_tscene(N)
    assert [dataclasses.asdict(t) for t in P.paper_targets(cfg)] == \
        [dataclasses.asdict(t) for t in jtargets(jcfg)]
    with pytest.raises(ValueError, match="unknown"):
        P.scene_from_dict({"na": 8, "bogus": 1})


@pytest.mark.parametrize("name", ["range_mf", "rcmc_shift",
                                  "azimuth_mf_outer", "azimuth_mf"])
def test_filter_payloads_bit_equal(name):
    jcfg, cfg = jscene()[0], tcfg()
    jmode, jarr = jplan._built(name, jcfg, ())
    tmode, tarr = tplan._built(name, cfg, ())
    assert tmode == jmode
    jarr = jarr if isinstance(jarr, tuple) else (jarr,)
    tarr = tarr if isinstance(tarr, tuple) else (tarr,)
    for a, b in zip(tarr, jarr):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sinc_weights_and_shifts_bit_equal():
    jcfg, cfg = jscene()[0], tcfg()
    np.testing.assert_array_equal(tfilters.rcmc_shift_samples(cfg),
                                  jfilters.rcmc_shift_samples(jcfg))
    frac = np.linspace(0, 0.99, 17)
    np.testing.assert_array_equal(tfilters.sinc_interp_weights(frac),
                                  jfilters.sinc_interp_weights(frac))


def test_simulator_noise_free_matches_reference():
    jcfg, jtg, _ = jscene()
    want = np.asarray(jsimulate_cached(jcfg, jtg, add_noise=False))
    got = P.simulate(tcfg(), P.paper_targets(tcfg()), add_noise=False,
                     device="cpu")
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert np.abs(want).max() <= 5.0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4


def test_simulator_noise_is_seeded_and_sized():
    cfg = tcfg()
    tg = P.paper_targets(cfg)
    a = P.simulate(cfg, tg, device="cpu")
    b = P.simulate(cfg, tg, device="cpu")
    assert torch.equal(a, b)
    noise = (a - P.simulate(cfg, tg, add_noise=False, device="cpu")).numpy()
    want_rms = np.sqrt(1.0 / (10.0 ** (cfg.noise_db / 10.0)))
    assert abs(np.sqrt(np.mean(np.abs(noise) ** 2)) / want_rms - 1) < 0.05
    np.testing.assert_array_equal(P.simulate_cached(cfg, tg, device="cpu"),
                                  a.numpy())


# ---------------------------------------------------------------------------
# Pipelines vs the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_pipeline_matches_reference(variant):
    jcfg, jtg, _ = jscene()
    got, want = port_image(variant), ref_image(variant)
    assert got.shape == want.shape and got.dtype == np.complex64
    assert np.isfinite(got).all()
    cmp = jmetrics.compare_pipelines(got, want, jcfg, jtg)
    assert cmp["l2_relative_error"] <= 1e-3, cmp["l2_relative_error"]
    assert max(cmp["snr_delta_db"]) <= GATE_DB, cmp["snr_delta_db"]
    assert [(r.row, r.col) for r in cmp["reports_a"]] == \
        [(r.row, r.col) for r in cmp["reports_b"]]


@pytest.mark.parametrize("precision", ["bf16", "f16", "bs16"])
def test_narrow_precision_images_match_reference(precision):
    """At 16 bits the port's fused3 image has the reference's non-finite
    points (f16 overflows its range on this scene in both packages) and
    is within 5e-4 x max|want| of it on the rest: both round the same
    operands, so only f32 accumulation order differs (the reference's own
    bf16 bound is 5e-2)."""
    cfg, _, raw = jscene()
    want = np.asarray(jbuild(cfg, "fused3", tune="off", precision=precision)
                      .run(jnp.asarray(raw)))
    got = port_image("fused3", tune="off", precision=precision)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert fin.all() == (precision != "f16")
    err = np.abs(got[fin] - want[fin]).max() / np.abs(want[fin]).max()
    assert err <= 5e-4, err


@pytest.mark.parametrize("variant", VARIANTS)
def test_port_metrics_agree_with_reference_metrics(variant):
    jcfg, jtg, _ = jscene()
    img = port_image(variant)
    mine = tmetrics.analyze_scene(img, tcfg(), P.paper_targets(tcfg()))
    theirs = jmetrics.analyze_scene(img, jcfg, jtg)
    assert [dataclasses.asdict(r) for r in mine] == \
        [dataclasses.asdict(r) for r in theirs]


def test_fused3_within_gate_of_golden():
    """SNR within the 0.1 dB gate of the stored corpus. The corpus was
    written from an older JAX's noise draw; on today's reference scene
    three targets' mainlobes are near-ties (e.g. 73.135 vs 73.132 one row
    apart), so their argmax sits up to 2 rows from the stored pixel —
    where the live reference's own peaks sit too
    (test_pipeline_matches_reference holds the port to those exactly)."""
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert golden["scene_n"] == N and golden["guard"] == GUARD
    want = golden["families"]["rda"]["targets"]
    cfg = tcfg()
    tg = P.paper_targets(cfg)
    img = port_image("fused3")
    noise = tmetrics.noise_rms(img, cfg, tg, guard=GUARD)
    for t, w in zip(tg, want):
        rep = tmetrics.analyze_target(img, cfg, t, noise)
        assert abs(rep.row - w["row"]) <= 2 and rep.col == w["col"]
        assert abs(rep.snr_db - w["snr_db"]) <= GATE_DB


@pytest.mark.parametrize("variant", ["fused3", "fused_tfree"])
def test_batch_equals_per_scene_runs(variant):
    _, _, raw = jscene()
    pipe = P.build_pipeline(tcfg(), variant, device="cpu")
    second = raw[::-1].copy() * np.complex64(0.5)
    batch = torch.from_numpy(np.stack([raw, second]))
    out = pipe.run(batch)
    assert out.shape == batch.shape
    assert torch.equal(out[0], pipe.run(torch.from_numpy(raw)))
    assert torch.equal(out[1], pipe.run(torch.from_numpy(second)))


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,count", [("fused3", 3), ("fused_tfree", 4),
                                           ("unfused", 7)])
def test_dispatches_equal_documented(variant, count):
    pipe = P.build_pipeline(tcfg(), variant, device="cpu")
    assert pipe.dispatches == P.documented_dispatches(variant) == count
    assert jrda.documented_dispatches(variant) == count
    assert pipe.hbm_roundtrips == count
    assert pipe.device == torch.device("cpu")
    spectral = [s for s in pipe.steps if s.kind == "spectral"]
    assert all(s.kernel_kw is not None for s in spectral)
    assert len(spectral) == count - (variant == "unfused")   # + sinc RCMC


@pytest.mark.parametrize("fuse", [False, True, tplan.FUSE_MEGA])
@pytest.mark.parametrize("plan_name", ["plan_unfused", "plan_fused_tfree",
                                       "plan_fused3", "plan_fused1"])
def test_dispatch_count_matches_reference(plan_name, fuse):
    mine = getattr(trda, plan_name)()
    theirs = getattr(jrda, plan_name)()
    jfuse = jplan.FUSE_MEGA if fuse == tplan.FUSE_MEGA else fuse
    assert tplan.plan_dispatch_count(mine, fuse) == \
        jplan.plan_dispatch_count(theirs, jfuse)


def test_fused3_compiled_filter_modes():
    pipe = P.build_pipeline(tcfg(), "fused3", device="cpu")
    assert [(s.phys_axis, s.filter_mode, s.kernel_kw["fwd"],
             s.kernel_kw["inv"]) for s in pipe.steps] == [
        (0, "none", True, False),
        (1, "shared_outer", True, True),
        (0, "outer", False, True)]
    assert pipe.steps[2].filter_kw["u"].shape == (N, 2)   # rank-2 phase


def test_reference_plan_json_compiles_to_same_image():
    plan = tplan.plan_from_json(jplan.plan_to_json(jrda.plan_fused3()))
    assert plan == trda.plan_fused3()
    assert tplan.plan_to_json(plan) == jplan.plan_to_json(jrda.plan_fused3())
    _, _, raw = jscene()
    x = torch.from_numpy(raw)
    loaded = tplan.compile_plan(plan, tcfg(), device="cpu").run(x)
    own = P.build_pipeline(tcfg(), "fused3", device="cpu").run(x)
    assert torch.equal(loaded, own)


FUSED_STEPS = [  # (name, kind, physical axis) in the reference's order
    ("range_compression", "spectral", 1),
    ("azimuth_fft_turn_in", "transpose", None),
    ("azimuth_fft", "spectral", 1),
    ("azimuth_fft_turn_out", "transpose", None),
    ("rcmc", "sinc_rcmc", None),
    ("azimuth_compression_turn_in", "transpose", None),
    ("azimuth_compression", "spectral", 1),
    ("azimuth_compression_turn_out", "transpose", None),
]


def test_megakernel_and_transpose_groups_are_not_ported_yet():
    """Both are ported now: a mega group compiles to one step, and the
    transposes of ``fused`` to one transpose step each, in the
    reference's order (the azimuth stages run on physical rows)."""
    pipe = tplan.compile_plan(trda.plan_fused3(), tcfg(), device="cpu",
                              fuse=tplan.FUSE_MEGA)
    assert [s.kind for s in pipe.steps] == ["mega"]
    assert pipe.dispatches == 1
    fused = tplan.compile_plan(trda.plan_fused(), tcfg(), device="cpu")
    assert [(s.name, s.kind, s.phys_axis) for s in fused.steps] == \
        FUSED_STEPS
    jfused = jplan.compile_plan(jrda.plan_fused(), jscene()[0], tune="off")
    assert [(s.name, s.kind, s.phys_axis) for s in jfused.steps] == \
        FUSED_STEPS


def test_unknown_filter_and_variant_raise():
    bad = tplan.SpectralPlan("bad", (tplan.Stage(
        "s", axis=1, fwd=True, inv=True, filters=("no_such_filter",)),))
    with pytest.raises(KeyError, match="no_such_filter"):
        tplan.compile_plan(bad, tcfg(), device="cpu")
    with pytest.raises(KeyError, match="'fused9'"):
        P.build_pipeline(tcfg(), "fused9", device="cpu")
    pipe = P.build_pipeline(tcfg(), "fused", device="cpu")
    assert [s.name for s in pipe.steps] == [n for n, _, _ in FUSED_STEPS]
    assert pipe.dispatches == P.documented_dispatches("fused") == 8


# ---------------------------------------------------------------------------
# Device default
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg()
    raw = torch.from_numpy(jscene()[2])
    with pytest.raises(RuntimeError, match="CUDA"):
        P.focus(raw, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.build_pipeline(cfg, "fused3")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.simulate(cfg, P.paper_targets(cfg))
    img = P.focus(raw, cfg, device="cpu")
    assert img.device.type == "cpu"
