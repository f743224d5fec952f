"""The compiler's streaming surface in the port, on the CPU:
``Pipeline.run_streamed`` (strips of each launch's free axis over host
memory), ``Pipeline.jitted`` / ``lower_sharded``, the strip arguments of
``rda.rcmc_sinc`` and the service's lane price
``tuning.cost.serve_batch_seconds``.

Inside the port the streamed image is held ``torch.equal`` to ``run``
(the reference claims and tests the same identity for its own routes).
Against the live JAX package the port is held by ``metrics`` on the SAME
numpy scene: the same peaks and |dSNR| <= 0.1 dB; ``rcmc_sinc`` within
2e-4 x max|want| (the reference's kernel tolerance).
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.sar import build_pipeline as jbuild
from repro.core.sar import metrics as jmetrics
from repro.core.sar import paper_targets as jtargets
from repro.core.sar import rda as jrda
from repro.core.sar import simulate_cached as jsimulate_cached
from repro.core.sar.geometry import test_scene as make_jscene
from repro.tuning import cost as jcost

import repro_torch.core.sar as P
from repro_torch.core import plan as tplan
from repro_torch.core.sar import rda as trda
from repro_torch.tuning import cost as tcost

N = 128
GATE_DB = 0.1
TOL = 2e-4
STREAMABLE = ["fused3", "fused_tfree", "unfused", "csa_fused", "omegak"]

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


def port_pipeline(variant, **kw):
    key = ("pipe", variant, tuple(sorted(kw.items())))
    if key not in _cache:
        _cache[key] = P.build_pipeline(tcfg(), variant, device="cpu", **kw)
    return _cache[key]


# ---------------------------------------------------------------------------
# run_streamed == run inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strips", [1, 3, 4])
@pytest.mark.parametrize("variant", STREAMABLE)
def test_run_streamed_equals_run(variant, strips):
    """Each launch cut into ``strips`` line strips (3 leaves ragged
    strips of 43/43/42 lines) gives the in-memory image bit for bit:
    every kernel treats its lines independently, the line-indexed filter
    payloads (FULL screens, the outer phase's u) are sliced to the strip,
    and ``unfused``'s sinc RCMC reads its shift table's rows lo..hi."""
    _, _, raw = jscene()
    pipe = port_pipeline(variant)
    want = pipe.run(torch.from_numpy(raw))
    got = pipe.run_streamed(raw, strips=strips)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    assert torch.equal(torch.from_numpy(got), want)


@pytest.mark.parametrize("precision", ["bs16", "bf16"])
def test_run_streamed_equals_run_at_narrow_precision(precision):
    """bs16's exponents are per line, so strips leave them as they are."""
    _, _, raw = jscene()
    pipe = port_pipeline("fused3", precision=precision)
    assert torch.equal(torch.from_numpy(pipe.run_streamed(raw, strips=3)),
                       pipe.run(torch.from_numpy(raw)))


def test_run_streamed_inflight_does_not_change_the_image():
    _, _, raw = jscene()
    pipe = port_pipeline("fused3")
    one = pipe.run_streamed(raw, strips=4, inflight=1)
    assert np.array_equal(one, pipe.run_streamed(raw, strips=4, inflight=4))


@pytest.mark.parametrize("variant", ["fused", "fused1", "batch"])
def test_run_streamed_refuses_what_the_reference_refuses(variant):
    """One (na, nr) scene only; a global transpose (``fused``) and a
    cross-axis megakernel step (``fused1``) need the whole scene — the
    reference's refusals and messages."""
    _, _, raw = jscene()
    if variant == "batch":
        with pytest.raises(ValueError, match=r"one \(na, nr\) scene"):
            port_pipeline("fused3").run_streamed(np.stack([raw, raw]))
        return
    with pytest.raises(ValueError, match="does not support streaming"):
        port_pipeline(variant).run_streamed(raw)


def test_custom_stage_without_stream_axis_refuses_to_stream():
    """``register_stage_impl``'s ``stream_axis`` defaults to None: a
    custom stage streams only where its implementation says along which
    axis it may be cut."""
    tplan.register_stage_impl(
        "_whole_scene_test", lambda x, cfg, opts, lo, hi: x * 2)
    plan = tplan.SpectralPlan("whole", (
        tplan.Stage("double", kind="_whole_scene_test"),))
    pipe = tplan.compile_plan(plan, tcfg(), device="cpu")
    x = torch.ones(4, 4, dtype=torch.complex64)
    assert torch.equal(pipe.run(x), 2 * x)
    with pytest.raises(ValueError, match="does not support streaming"):
        pipe.run_streamed(x.numpy())


def test_jitted_runs_the_steps_and_lower_sharded_is_refused():
    """``jitted`` is the pipeline's own eager ``run`` (no torch.compile:
    that would swap the kernels for a compiled plain version);
    ``lower_sharded`` names the queue item that ports it."""
    _, _, raw = jscene()
    pipe = port_pipeline("fused3")
    x = torch.from_numpy(raw)
    assert torch.equal(pipe.jitted()(x), pipe.run(x))
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        pipe.lower_sharded()


# ---------------------------------------------------------------------------
# Against the live JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["fused3", "unfused"])
def test_run_streamed_matches_the_reference_streamed(variant):
    cfg, targets, raw = jscene()
    want = np.asarray(jbuild(cfg, variant, tune="off").run_streamed(
        raw, strips=4))
    got = port_pipeline(variant).run_streamed(raw, strips=4)
    ours = jmetrics.analyze_scene(got, cfg, targets)
    theirs = jmetrics.analyze_scene(want, cfg, targets)
    assert [(r.row, r.col) for r in ours] == [(r.row, r.col)
                                              for r in theirs]
    c = jmetrics.compare_pipelines(got, want, cfg, targets)
    assert max(c["snr_delta_db"]) <= GATE_DB, c["snr_delta_db"]


@pytest.mark.parametrize("range_variant", [False, True])
@pytest.mark.parametrize("lo,hi", [(0, 128), (0, 43), (43, 86), (86, 128)])
def test_rcmc_sinc_strip_matches_reference(lo, hi, range_variant):
    """The row strip lo..hi of the scene through ``rcmc_sinc(lo, hi)``
    against the reference's on the same strip."""
    cfg, _, raw = jscene()
    rng = np.random.default_rng(7)
    x = (raw + 0.1 * (rng.standard_normal(raw.shape)
                      + 1j * rng.standard_normal(raw.shape))
         ).astype(np.complex64)[lo:hi]
    want = np.asarray(jrda.rcmc_sinc(jnp.asarray(x), cfg,
                                     range_variant=range_variant,
                                     lo=lo, hi=hi))
    got = trda.rcmc_sinc(torch.from_numpy(x), tcfg(),
                         range_variant=range_variant, lo=lo, hi=hi).numpy()
    assert got.shape == want.shape == (hi - lo, N)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_serve_batch_seconds_orders_keys_as_the_reference():
    """The lane price ranks a 1024^2 batch above a 256^2 one, a bigger
    batch above a smaller, and a streamed (staged) 128^2 scene above the
    same scene in memory (resident), as the reference's does."""
    for cost in (tcost, jcost):
        s = cost.serve_batch_seconds
        assert s(1024, 1024) > s(256, 256) > 0
        assert s(256, 256, batch=8) > s(256, 256, batch=1)
        assert s(128, 128, streamed=True) > s(128, 128)
        assert s(4096, 4096, streamed=True) >= s(4096, 4096)
    keys = [(256, 1), (256, 4), (1024, 1), (1024, 4), (4096, 1)]

    def order(cost):
        return sorted(keys, key=lambda k: cost.serve_batch_seconds(
            k[0], k[0], batch=k[1]))
    assert order(tcost) == order(jcost)
