"""Serving over a mesh of CPU slabs (``launch/steps.py``'s
``ShardedServing``, ``launch/serve.generate(..., mesh=...)``):

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_serve.py

- gemma3-12b smoke, seq 64, batch 1 (the reference's own test,
  ``tests/test_distributed.py``): a decode step with the KV cache's
  sequence over "data" on (4, 2) within 5e-3 of the live reference's
  single-device ``decode_step``;
- every architecture's batch-1 prefill and two decode steps on (4, 2)
  within 1e-5 x max|want| of the port's single-device ones at f32 (ring
  caches, sliding windows, recurrent states whole, whisper's cross
  caches cut too), and the cache's layout ``cache_shardings``';
- a batch-4 ``generate`` under (4, 1) gives the single-device tokens at
  f32 (MoE decode groups span the positions: lockstep).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import Model as RefModel
from repro_torch.configs import registry
from repro_torch.distributed.mesh import ShardedTensor
from repro_torch.launch import mesh as lm
from repro_torch.launch import serve
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import Model
from repro_torch.models.convert import params_from_reference

CPU = torch.device("cpu")
REF_TOL = 5e-3      # the reference's own bar (absolute, on the logits)
TOL = 1e-5          # x max|want|: the port sharded vs single at f32
ARCHS = list(registry.ARCHS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (restored after it): its many
    small ops run ~2x faster so, and ~10x under the suite's parallel
    workers, where the threads of every worker contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sharded(model, mesh):
    rules = lm.activation_rules(mesh)
    values = {n: p.detach() for n, p in model.named_parameters()}
    return steps.shard_params(values, shd.param_shardings(
        values, model.cfg, mesh, rules)), rules


def rel_err(got, want):
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    return float((got - want).abs().max() / want.abs().max())


@functools.lru_cache(maxsize=None)
def reference_decode():
    cfg = ref_registry.smoke("gemma3-12b", seq=64)
    model = RefModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int32)
    cache, _ = jax.jit(lambda p, b: model.prefill(p, b, 64))(
        params, {"tokens": jnp.asarray(toks[:, :63])})
    logits, _ = jax.jit(model.decode_step)(params, cache,
                                           jnp.asarray(toks[:, 63:64]))
    return jax.tree.map(np.asarray, params), toks, np.asarray(logits)


def test_seq_parallel_decode_matches_reference():
    ref_params, toks, want = reference_decode()
    cfg = registry.smoke("gemma3-12b", seq=64)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(ref_params))
    mesh = lm.make_host_mesh(2, [CPU] * 8)
    params, rules = sharded(model, mesh)
    toks = torch.from_numpy(toks)
    cache, _ = steps.build_prefill(model, 64, mesh, rules, params)(
        {"tokens": toks[:, :63]})
    # the KV sequence is cut over "data", the ring's slot positions whole
    entry = cache["layers"][0]
    assert isinstance(entry["k"], ShardedTensor)
    assert tuple(entry["k"].spec)[:2] == (None, "data")
    assert tuple(entry["pos"].spec) == (None, None)
    logits, _ = steps.build_decode(model, mesh, rules, params)(
        cache, toks[:, 63:64])
    want = torch.from_numpy(want.copy())
    assert float((logits - want).abs().max()) < REF_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_batch1_decode_matches_single_device(arch):
    cfg = registry.smoke(arch, seq=64)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 64),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :61]}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn(1, cfg.encoder.n_frames, cfg.d_model,
                                      generator=torch.Generator()
                                      .manual_seed(3))
    cache, pre = model.prefill(batch, 64)
    mesh = lm.make_host_mesh(2, [CPU] * 8)
    params, rules = sharded(model, mesh)
    scache, spre = steps.build_prefill(model, 64, mesh, rules, params)(batch)
    assert rel_err(spre, pre) <= TOL
    layout = shd.cache_shardings(scache, cfg, mesh, rules, 1)
    for (p, st), (_, lay) in zip(shd._flatten(scache), shd._flatten(layout)):
        if isinstance(st, ShardedTensor):
            assert st.sharding.spec == lay.spec, p
    decode = steps.build_decode(model, mesh, rules, params)
    for i in (61, 62):
        want, cache = model.decode_step(cache, toks[:, i:i + 1])
        got, scache = decode(scache, toks[:, i:i + 1])
        assert rel_err(got, want) <= TOL, i


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-12b",
                                  "granite-moe-3b-a800m",
                                  "recurrentgemma-9b", "whisper-tiny"])
def test_sharded_generate_gives_single_device_tokens(arch):
    cfg = registry.smoke(arch, seq=64)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    want = serve.generate(model, prompts, 6, 32)
    got = serve.generate(model, prompts, 6, 32,
                         mesh=lm.make_host_mesh(1, [CPU] * 4))
    assert torch.equal(got, want)


def test_serve_main_over_a_mesh(capsys):
    serve.main(["--device", "cpu", "--mesh", "4x1", "--max-new", "3",
                "--prompt-len", "8"])
    assert "generated 12 tokens" in capsys.readouterr().out
