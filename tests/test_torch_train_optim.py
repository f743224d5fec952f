"""The port's training substrate against the live JAX reference, on the
CPU: AdamW (``update``, ``cosine_schedule``, ``global_norm``,
``make_train_step``), int8 compression with error feedback, the token
stream and the checkpoint manager, with the reference's own property
tests (tests/test_substrate.py) restated for the port:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_optim.py

The same numpy trees go to both packages. AdamW's new weights, moments,
loss and gradient norm agree within 1e-6 relative (the sums run in
another order), the learning rate within 1e-7 (across the whole
schedule within 2 float32 ulps: the cos implementations differ), the
quantizer bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - see requirements-dev.txt
    from _hypothesis_fallback import given, settings, strategies as st

from repro.checkpoint import CheckpointManager as RefManager
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, TokenStream
from repro_torch.distributed.mesh import Mesh
from repro_torch.optim import AdamWConfig, adamw, compress

RTOL = 1e-6         # x max|want|: AdamW against the reference
LR_TOL = 1e-7       # relative


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def np_tree(seed, shapes=(("w", (16, 8)), ("b", (8,)), ("table", (32, 8)))):
    r = np.random.default_rng(seed)
    return {n: r.standard_normal(s).astype(np.float32) for n, s in shapes}


def as_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def as_torch(tree):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def opt_states(seed, step):
    """The same AdamW state for both packages: moments from numpy (nu
    non-negative), ``step`` steps taken."""
    mu = np_tree(seed)
    nu = {k: np.square(v) * 1e-2 for k, v in np_tree(seed + 1).items()}
    ref = {"mu": as_jax(mu), "nu": as_jax(nu),
           "step": jnp.asarray(step, jnp.int32)}
    port = {"mu": as_torch(mu), "nu": as_torch(nu),
            "step": torch.tensor(step, dtype=torch.int32)}
    return ref, port


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("step", [0, 7, 150])
def test_update_matches_reference(clip, step):
    kw = dict(warmup_steps=10, decay_steps=200, clip_norm=clip)
    params, grads = np_tree(0), np_tree(1)
    grads = {k: v * 3.0 for k, v in grads.items()}
    ref_state, state = opt_states(2, step)
    want_p, want_s, want_stats = ref_adamw.update(
        as_jax(params), as_jax(grads), ref_state, RefAdamWConfig(**kw))
    p = as_torch(params)
    got_p, got_s, stats = adamw.update(p, as_torch(grads), state,
                                       AdamWConfig(**kw))
    assert got_p is p and got_s is state          # written in place
    for k in params:
        assert rel(got_p[k], want_p[k]) <= RTOL
        assert rel(got_s["mu"][k], want_s["mu"][k]) <= RTOL
        assert rel(got_s["nu"][k], want_s["nu"][k]) <= RTOL
    assert int(got_s["step"]) == int(want_s["step"]) == step + 1
    assert got_s["step"].dtype == torch.int32
    assert rel(stats["grad_norm"], want_stats["grad_norm"]) <= RTOL
    assert rel(stats["lr"], want_stats["lr"]) <= LR_TOL


def test_first_step_lr_is_not_zero():
    """The step is counted before the schedule: step 1's lr is
    lr_peak / warmup_steps, as the reference's."""
    cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10)
    params = as_torch(np_tree(0))
    _, _, stats = adamw.update(params, as_torch(np_tree(1)),
                               adamw.init(params), cfg)
    assert float(stats["lr"]) == pytest.approx(1e-4, rel=1e-6)


@pytest.mark.parametrize("kw", [dict(warmup_steps=10, decay_steps=1000),
                                dict(),
                                dict(lr_peak=1e-3, lr_min=1e-4,
                                     warmup_steps=7, decay_steps=333)])
def test_cosine_schedule_matches_reference(kw):
    """Every 7th step to past the decay's end. torch's and XLA's float32
    cos differ by an ulp at some points (56 of 1001 on [0, pi]); through
    0.5 (lr_peak - lr_min) (1 + cos) that is (lr_peak - lr_min) 2^-24,
    up to 5 ulps of the lr where 1 + cos nears 0 (measured). The bar: that
    term and 2 ulps of the lr's own roundings. The warmup, and every lr
    the update tests read, agree within 1e-7."""
    cfg = AdamWConfig(**kw)
    lr, ref_lr = (adamw.cosine_schedule(cfg),
                  ref_adamw.cosine_schedule(RefAdamWConfig(**kw)))
    steps = np.arange(0, 12_000, 7, dtype=np.int32)
    got = np.array([float(lr(torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps])
    want = np.asarray(jax.vmap(ref_lr)(jnp.asarray(steps)), np.float64)
    ulp = np.spacing(want.astype(np.float32)).astype(np.float64)
    bar = 2 * ulp + (cfg.lr_peak - cfg.lr_min) * 2.0 ** -24
    assert (np.abs(got - want) <= bar).all()
    warm = steps < cfg.warmup_steps
    assert (np.abs(got - want)[warm] <= LR_TOL * want[warm]).all()
    assert float(lr(3)) == float(lr(torch.tensor(3)))   # int or tensor


def test_global_norm_matches_reference():
    tree = {k: v * 10 for k, v in np_tree(4).items()}
    assert rel(adamw.global_norm(as_torch(tree)),
               ref_adamw.global_norm(as_jax(tree))) <= RTOL


def test_update_does_not_depend_on_slicing(monkeypatch):
    """Leaves are updated in slices of ``_SLICE`` elements: elementwise,
    so the new weights and moments are the same bits at any slice size;
    the norm's partial sums may differ in the last place."""
    cfg = AdamWConfig(warmup_steps=0, clip_norm=None)
    outs = []
    for size in (1 << 24, 7):
        monkeypatch.setattr(adamw, "_SLICE", size)
        params = as_torch(np_tree(0))
        state = adamw.init(params)
        for i in range(3):
            adamw.update(params, as_torch(np_tree(10 + i)), state, cfg)
        outs.append((params, state))
    (p1, s1), (p2, s2) = outs
    for k in p1:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1["mu"][k], s2["mu"][k])
        assert torch.equal(s1["nu"][k], s2["nu"][k])


def mlp_loss_ref(p, batch):
    h = jnp.tanh(batch["x"] @ p["w"] + p["b"])
    return jnp.mean(jnp.square(h @ p["table"].T - batch["y"]))


def mlp_loss(p):
    def loss(batch):
        h = torch.tanh(batch["x"] @ p["w"] + p["b"])
        return torch.mean(torch.square(h @ p["table"].T - batch["y"]))
    return loss


@pytest.mark.parametrize("accum", [1, 4])
def test_make_train_step_matches_reference(accum):
    r = np.random.default_rng(5)
    batch = {"x": r.standard_normal((8, 16)).astype(np.float32),
             "y": r.standard_normal((8, 32)).astype(np.float32)}
    kw = dict(warmup_steps=3, decay_steps=50)
    params = np_tree(6)
    ref_state, state = opt_states(7, 2)
    step = ref_adamw.make_train_step(mlp_loss_ref, RefAdamWConfig(**kw),
                                     accum)
    want_p, want_s, want_stats = step(as_jax(params), ref_state,
                                      as_jax(batch))
    p = {k: torch.nn.Parameter(v) for k, v in as_torch(params).items()}
    train_step = adamw.make_train_step(mlp_loss(p), p, AdamWConfig(**kw),
                                       accum)
    state, stats = train_step(state, as_torch(batch))
    assert set(stats) == {"loss", "grad_norm", "lr"}
    assert all(v.dim() == 0 for v in stats.values())
    for k in params:
        assert rel(p[k].detach(), want_p[k]) <= RTOL
        assert rel(state["mu"][k], want_s["mu"][k]) <= RTOL
        assert rel(state["nu"][k], want_s["nu"][k]) <= RTOL
        assert p[k].grad is None
    assert rel(stats["loss"], want_stats["loss"]) <= RTOL
    assert rel(stats["grad_norm"], want_stats["grad_norm"]) <= RTOL
    assert rel(stats["lr"], want_stats["lr"]) <= LR_TOL


def test_make_train_step_refuses_a_ragged_batch():
    p = {"w": torch.nn.Parameter(torch.ones(4))}
    step = adamw.make_train_step(lambda b: (b["x"] @ p["w"]).mean(), p,
                                 AdamWConfig(), accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(adamw.init(p), {"x": torch.ones((8, 4))})


# ---------------------------------------------------------------------------
# AdamW: the reference's property tests (tests/test_substrate.py)
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    w = torch.nn.Parameter(torch.tensor([5.0, -3.0]))
    params = {"w": w}
    cfg = AdamWConfig(lr_peak=0.2, warmup_steps=0, decay_steps=200,
                      weight_decay=0.0, clip_norm=None)
    step = adamw.make_train_step(lambda _: torch.sum(w ** 2), params, cfg)
    state = adamw.init(params)
    for _ in range(150):
        state, _ = step(state, {"x": torch.zeros(1)})
    assert float(w.detach().abs().max()) < 1e-2


def test_grad_accumulation_equivalence():
    """accum_steps microbatching == full-batch gradients (linear loss)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 4)).astype(np.float32))
    cfg = AdamWConfig(warmup_steps=0, clip_norm=None, weight_decay=0.0)
    out = []
    for accum in (1, 4):
        w = torch.nn.Parameter(torch.ones(4))
        step = adamw.make_train_step(lambda b, w=w: torch.mean(b["x"] @ w),
                                     {"w": w}, cfg, accum_steps=accum)
        _, stats = step(adamw.init({"w": w}), {"x": x})
        out.append((w.detach().clone(), float(stats["loss"])))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               atol=1e-6)
    assert abs(out[0][1] - out[1][1]) <= 1e-6


def test_clip_norm():
    params = {"w": torch.zeros(3)}
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, weight_decay=0.0)
    g = {"w": torch.tensor([30.0, 40.0, 0.0])}
    _, _, stats = adamw.update(params, g, adamw.init(params), cfg)
    assert abs(float(stats["grad_norm"]) - 50.0) < 1e-3


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10,
                      decay_steps=100)
    lr = adamw.cosine_schedule(cfg)
    assert float(lr(torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(lr(torch.tensor(10))), 1e-3, rtol=1e-5)
    np.testing.assert_allclose(float(lr(torch.tensor(100))), 1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(float(lr(torch.tensor(1000))), 1e-4,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# Int8 compression with error feedback
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.floats(1e-3, 1e3))
def test_quantize_matches_reference_bit_for_bit(seed, scale):
    """The reference's ``test_quantize_roundtrip_bound`` draws: the same
    ``q`` and ``scale`` bits, and its round-trip bound."""
    x = np.random.default_rng(seed).standard_normal(256).astype(np.float32)
    x = x * scale
    q, s = compress.quantize_int8(torch.from_numpy(x))
    want_q, want_s = ref_compress.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    assert s.numpy().tobytes() == np.asarray(want_s).tobytes()
    err = np.abs(compress.dequantize_int8(q, s).numpy() - x)
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, s = compress.quantize_int8(x)
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


def test_error_feedback_unbiased_over_time():
    """Sum of compressed updates tracks the sum of true gradients: the
    residual never escapes (it is bounded by one quantization step)."""
    rng = np.random.default_rng(0)
    err = torch.zeros(64)
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        total_true += g.numpy()
        x = g + err
        q, s = compress.quantize_int8(x)
        deq = compress.dequantize_int8(q, s)
        err = x - deq
        total_sent += deq.numpy()
        assert float(err.abs().max()) <= float(s) * 0.5 + 1e-6
    resid = np.abs(total_true - total_sent).max()
    assert resid <= float(err.abs().max()) + 1e-5


def test_compressed_bytes():
    p = {"a": torch.zeros((10, 10)), "b": torch.zeros((5,))}
    assert compress.compressed_bytes(p) == 100 + 4 + 5 + 4
    assert compress.init_error(p)["a"].dtype == torch.float32


def psum_numpy(grads, errors):
    """The reference's arithmetic in float32 numpy: each slab's g + e
    quantized (round half to even), the dequantized slabs summed in mesh
    order, divided by n; each slab's residual."""
    n = len(grads)
    total, new_err = None, []
    for g, e in zip(grads, errors):
        x = g + e
        scale = np.float32(max(np.abs(x).max(), np.float32(1e-30))
                           / np.float32(127.0))
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        deq = q.astype(np.float32) * scale
        new_err.append(x - deq)
        total = deq if total is None else total + deq
    return total / np.float32(n), new_err


@pytest.mark.parametrize("n", [1, 4])
def test_compressed_psum_matches_numpy(n):
    mesh = Mesh(["cpu"] * n, ("dp",))
    r = np.random.default_rng(n)
    shapes = {"w": (16, 8), "b": (8,)}
    g = [{k: r.standard_normal(s).astype(np.float32) for k, s in
          shapes.items()} for _ in range(n)]
    e = [{k: 1e-2 * r.standard_normal(s).astype(np.float32) for k, s in
          shapes.items()} for _ in range(n)]
    mean, new_err = compress.compressed_psum(
        [as_torch(t) for t in g], [as_torch(t) for t in e], mesh, "dp")
    assert len(mean) == len(new_err) == n
    for k in shapes:
        want, want_err = psum_numpy([t[k] for t in g], [t[k] for t in e])
        for i in range(n):
            np.testing.assert_array_equal(mean[i][k].numpy(), want)
            np.testing.assert_array_equal(new_err[i][k].numpy(),
                                          want_err[i])
    if n == 1:   # quantize -> dequantize -> residual
        x = as_torch(g[0])["w"] + as_torch(e[0])["w"]
        d = compress.dequantize_int8(*compress.quantize_int8(x))
        assert torch.equal(mean[0]["w"], d)
        assert torch.equal(new_err[0]["w"], x - d)


def test_compressed_psum_refuses_a_slab_count_off_the_mesh():
    mesh = Mesh(["cpu"] * 4, ("dp",))
    t = {"w": torch.zeros(3)}
    with pytest.raises(ValueError, match="4 slabs"):
        compress.compressed_psum([t] * 2, [t] * 2, mesh, "dp")


# ---------------------------------------------------------------------------
# The token stream
# ---------------------------------------------------------------------------

def test_data_deterministic_and_seekable():
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=3)
    s1, s2 = TokenStream(cfg, "cpu"), TokenStream(cfg, "cpu")
    b5 = s1.batch(5)
    torch.manual_seed(123)   # the global generator plays no part
    for step, b in s2.batches(start_step=5):
        assert step == 5
        assert torch.equal(b["tokens"], b5["tokens"])
        assert torch.equal(b["labels"], b5["labels"])
        break
    assert not torch.equal(s1.batch(6)["tokens"], b5["tokens"])
    other = TokenStream(DataConfig(128, 32, 4, seed=4), "cpu").batch(5)
    assert not torch.equal(other["tokens"], b5["tokens"])


def test_data_is_learnable_structure():
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, noise=0.0)
    b = TokenStream(cfg, "cpu").batch(0)
    t, y = b["tokens"].numpy(), b["labels"].numpy()
    assert t.dtype == y.dtype == np.int32 and t.shape == (4, 32)
    np.testing.assert_array_equal(t[:, 1:], y[:, :-1])   # shifted by one
    seq = np.concatenate([t, y[:, -1:]], axis=1)
    d = np.diff(seq, axis=1) % 128
    assert (d == d[:, :1]).all()                  # affine progressions
    assert ((d[:, 0] >= 1) & (d[:, 0] < 64)).all()


def test_data_corruption_rate():
    """At noise 0.05 the corrupted positions (against the same stream at
    noise 0, which draws the same progressions) sit within 4 sigma of the
    rate, a corrupted token equal to the clean one by chance excepted."""
    v, noise = 1000, 0.05
    kw = dict(vocab_size=v, seq_len=255, global_batch=64, seed=1)
    clean = TokenStream(DataConfig(**kw, noise=0.0), "cpu")
    noisy = TokenStream(DataConfig(**kw, noise=noise), "cpu")
    hits, n = 0, 0
    for step in range(4):
        a, b = clean.batch(step), noisy.batch(step)
        sa = torch.cat([a["tokens"], a["labels"][:, -1:]], dim=1)
        sb = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
        hits += int((sa != sb).sum())
        n += sa.numel()
    p = noise * (1 - 1 / v)
    assert abs(hits / n - p) <= 4 * np.sqrt(p * (1 - p) / n)


def test_token_stream_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenStream(DataConfig(16, 8, 2))


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

def make_tree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(r.standard_normal((8, 4)).astype(
            np.float32)),
            "scale": torch.from_numpy(r.standard_normal(4).astype(
                np.float32))},
        "opt": {"mu": {"w": torch.zeros((8, 4))},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = make_tree()
    mgr.save(3, tree)
    like = {"params": {k: torch.zeros_like(v) for k, v in
                       tree["params"].items()},
            "opt": {"mu": {"w": torch.ones((8, 4))},
                    "step": torch.tensor(0, dtype=torch.int32)}}
    out, step = mgr.restore(like)
    assert step == 3
    for a, b in zip(leaves(out), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, make_tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    out, _ = mgr.restore(make_tree(), step=3)
    assert torch.equal(out["params"]["w"], make_tree(3)["params"]["w"])


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_checkpoint_atomic_no_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, make_tree())
    names = os.listdir(tmp_path)
    assert names == ["step_000000005"]
    assert "manifest.json" in os.listdir(tmp_path / "step_000000005")


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(make_tree())


def test_checkpoint_layout_is_the_reference(tmp_path):
    """The same tree through both managers: the same files and the same
    manifest (leaf paths, shard keys, shapes, dtypes)."""
    tree = make_tree()
    ref_tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    RefManager(str(tmp_path / "ref")).save(2, ref_tree)
    CheckpointManager(str(tmp_path / "port")).save(2, tree)
    dirs = [tmp_path / k / "step_000000002" for k in ("ref", "port")]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    manifests = [json.loads((d / "manifest.json").read_text())
                 for d in dirs]
    assert manifests[0] == manifests[1]
    # and the reference restores what the port wrote
    out, _ = RefManager(str(tmp_path / "port")).restore(ref_tree)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_bf16_leaf_roundtrips(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.randn((5, 3), generator=torch.Generator().manual_seed(0))
    tree = {"w": x.to(torch.bfloat16), "v": x}
    mgr.save(1, tree)
    manifest = json.loads((tmp_path / "step_000000001" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["['w']"]["dtype"] == "bfloat16"
    out, _ = mgr.restore({"w": torch.zeros((5, 3), dtype=torch.bfloat16),
                          "v": torch.zeros((5, 3))})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], tree["w"]) and torch.equal(out["v"], x)


def test_checkpoint_restores_onto_another_device(tmp_path):
    """One device for every leaf, or a tree of devices matching ``like``
    ("meta" stands in for a second device here)."""
    mgr = CheckpointManager(str(tmp_path))
    tree = make_tree()
    mgr.save(1, tree)
    out, _ = mgr.restore(tree, device="meta")
    assert all(t.device.type == "meta" for t in leaves(out))
    devs = {"params": {"w": "meta", "scale": "cpu"},
            "opt": {"mu": {"w": "cpu"}, "step": "meta"}}
    out, _ = mgr.restore(tree, device=devs)
    assert out["params"]["w"].device.type == "meta"
    assert torch.equal(out["params"]["scale"], tree["params"]["scale"])
    assert out["opt"]["step"].device.type == "meta"
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({**tree, "params": {**tree["params"],
                                        "w": torch.zeros(3)}})


def test_async_save_holds_the_values_of_its_call(tmp_path):
    """Training updates the tensors in place right after an async save:
    the checkpoint holds what they were when ``save`` was called."""
    mgr = CheckpointManager(str(tmp_path))
    tree = make_tree()
    before = [t.clone() for t in leaves(tree)]
    mgr.save(1, tree, blocking=False)
    with torch.no_grad():
        for t in leaves(tree):
            t.add_(1)
    mgr.wait()
    out, _ = mgr.restore(tree)
    for got, want in zip(leaves(out), before):
        assert torch.equal(got, want)
