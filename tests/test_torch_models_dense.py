"""The port's LM serving path against the live JAX reference, on the CPU:
the dense architectures (the others are in tests/test_torch_models_mixers.py,
test_torch_models_local.py and test_torch_models_moe.py, which use this
file's helpers):

    PYTHONPATH=src python -m pytest -q tests/test_torch_models_dense.py

Each architecture at ``registry.smoke(arch, seq=64)``, float32, with the
reference's ``Model.init(PRNGKey(0))`` parameters carried across by
``models.convert.params_from_reference``: the forward's hidden states,
the prefill logits and two decode steps' logits within 1e-4 x max|want|
of the reference's, ``generate``'s greedy tokens equal to
``repro.launch.serve.generate``'s, and the port's own prefill/decode ==
forward at the reference's 2e-3 (tests/test_archs_smoke.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import serve as ref_serve
from repro.models import Model as RefModel
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import logits_last

B, S = 2, 64
T = S // 2          # prompt tokens
NEW = 4             # generated tokens
TOL = 1e-4          # x max|want|
DECODE_ATOL = 2e-3  # the reference's own prefill/decode == forward bar
ARCHS = ["stablelm-1.6b", "minitron-4b", "yi-34b", "qwen2-vl-72b"]


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def smoke_cfgs(arch, **changes):
    """The reference's and the port's smoke config of ``arch``."""
    return (dataclasses.replace(ref_registry.smoke(arch, seq=S), **changes),
            dataclasses.replace(registry.smoke(arch, seq=S), **changes))


def prefix(batch, n):
    out = {k: v for k, v in batch.items() if k != "labels"}
    out["tokens"] = batch["tokens"][:, :n]
    return out


@functools.lru_cache(maxsize=None)
def reference(arch, **changes):
    """The reference's results on one smoke architecture: its parameters
    (numpy), the batch, the forward's hidden states, the prefill
    logits on T tokens and two decode steps' logits, generate's tokens."""
    cfg, _ = smoke_cfgs(arch, **changes)
    model = RefModel(cfg)
    # jitted: the same values as the eager calls, in a few compiles
    # instead of one a primitive
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    batch = make_batch(cfg, len(arch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x, _, _ = jax.jit(lambda p, b: model.forward(p, b, train=False))(
        params, jb)
    cache, pre = jax.jit(lambda p, b: model.prefill(p, b, S))(
        params, prefix(jb, T))
    decode = jax.jit(model.decode_step)
    logits = [pre]
    for i in range(2):
        step, cache = decode(params, cache, jb["tokens"][:, T + i:T + i + 1])
        logits.append(step)
    tokens = ref_serve.generate(model, params, jb["tokens"][:, :T], NEW, S)
    return dict(params=jax.tree.map(np.asarray, params), batch=batch,
                hidden=np.asarray(x), logits=[np.asarray(v) for v in logits],
                tokens=np.asarray(tokens), cfg=cfg)


def port(arch, ref, **changes):
    _, cfg = smoke_cfgs(arch, **changes)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(ref["params"]))
    return model


def on_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def check_forward(arch, tol=TOL, **changes):
    ref = reference(arch, **changes)
    model = port(arch, ref, **changes)
    with torch.no_grad():
        x, _, _ = model.forward(on_torch(ref["batch"]), train=False)
    assert torch.isfinite(x).all()
    assert rel(x.float(), ref["hidden"]) <= tol


def check_prefill_decode(arch, tol=TOL, **changes):
    ref = reference(arch, **changes)
    model = port(arch, ref, **changes)
    batch = on_torch(ref["batch"])
    cache, pre = model.prefill(prefix(batch, T), S)
    got = [pre]
    for i in range(2):
        step, cache = model.decode_step(
            cache, batch["tokens"][:, T + i:T + i + 1])
        got.append(step)
    for g, w in zip(got, ref["logits"]):
        assert g.dtype == torch.float32
        assert rel(g, w) <= tol


def check_generate(arch, **changes):
    ref = reference(arch, **changes)
    model = port(arch, ref, **changes)
    tokens = serve.generate(model, torch.from_numpy(
        ref["batch"]["tokens"][:, :T]), NEW, S)
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])


def check_decode_equals_forward(arch):
    """The port's own invariant: decode with the cache == full forward."""
    ref = reference(arch)
    model = port(arch, ref)
    batch = on_torch(ref["batch"])
    cache, logits_pre = model.prefill(prefix(batch, T), S)
    logits_dec, _ = model.decode_step(cache, batch["tokens"][:, T:T + 1])
    with torch.no_grad():
        x, _, _ = model.forward(prefix(batch, T + 1), train=False)
    table = (model.embed.table if model.cfg.tie_embeddings
             else model.lm_head.table)
    with torch.no_grad():
        want_pre = logits_last(x[:, T - 1], table)
        want_dec = logits_last(x[:, T], table)
    np.testing.assert_allclose(logits_pre.numpy(), want_pre.numpy(),
                               atol=DECODE_ATOL)
    np.testing.assert_allclose(logits_dec.numpy(), want_dec.numpy(),
                               atol=DECODE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_reference(arch):
    check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_reference(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(arch):
    check_decode_equals_forward(arch)


def test_query_chunks_match_reference():
    """Prefill's query chunking (24 of 64 positions a chunk, with a
    remainder) against the reference's scanned chunks."""
    check_forward("stablelm-1.6b", attn_q_chunk=24)


def test_loss_matches_reference():
    ref = reference("minitron-4b")
    cfg, _ = smoke_cfgs("minitron-4b")
    want = RefModel(cfg).loss(
        jax.tree.map(jnp.asarray, ref["params"]),
        {k: jnp.asarray(v) for k, v in ref["batch"].items()})
    model = port("minitron-4b", ref)
    with torch.no_grad():
        got = model.loss(on_torch(ref["batch"]))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_compute_copy_is_made_once_per_generate(monkeypatch):
    """``generate`` casts the weights once for the whole call, not once a
    decode step (bf16 compute)."""
    import repro_torch.models.model as model_mod
    _, cfg = smoke_cfgs("stablelm-1.6b", dtype="bfloat16")
    model = Model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    model.init(gen)
    calls = []
    real = model_mod.cast_params_for_compute

    def spy(params, dtype):
        calls.append(dtype)
        return real(params, dtype)

    monkeypatch.setattr(model_mod, "cast_params_for_compute", spy)
    tokens = serve.generate(model, torch.zeros((B, 8), dtype=torch.int64),
                            6, 16)
    assert tokens.shape == (B, 6) and calls == ["bfloat16"]
