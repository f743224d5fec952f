"""The port's LM configs and the model scaffolding around them, against
the live reference on the CPU:

    PYTHONPATH=src python -m pytest -q tests/test_torch_configs.py

``registry.get`` / ``smoke`` / ``SHAPES`` / ``cells()`` field for field
equal to the reference's for every architecture, ``param_count`` and
``active_param_count`` equal; the parameter names and shapes the weight
carrier produces equal to the port's ``state_dict``; the compute copy's
float32 set equal to the reference's; the single-device sharding rules,
the serving entry points and their CLI; the entry points refusing to
guess a device.
"""
import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch.configs import registry
from repro_torch.distributed.mesh import Mesh
from repro_torch.launch import serve, steps
from repro_torch.models import Model, layers, sharding
from repro_torch.models import model as model_mod
from repro_torch.models.attention import NEG_INF, sdpa
from repro_torch.models.convert import params_from_reference, reference_layers

ARCHS = sorted(ref_registry.ARCHS)
DERIVED = ("resolved_head_dim", "layer_kinds", "n_periods", "remainder_kinds",
           "is_encoder_decoder", "attention_free", "sub_quadratic")


def same_config(got, want):
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in DERIVED:
        assert getattr(got, name) == getattr(want, name), name
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_registry_lists_the_same_architectures():
    assert list(registry.ARCHS) == list(ref_registry.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_equals_reference(arch):
    same_config(registry.get(arch), ref_registry.get(arch))


@pytest.mark.parametrize("seq", [64, 256])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_equals_reference(arch, seq):
    same_config(registry.smoke(arch, seq=seq),
                ref_registry.smoke(arch, seq=seq))


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in registry.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_registry.SHAPES.items()}
    assert registry.LONG_OK == ref_registry.LONG_OK
    assert registry.SKIP_REASONS == ref_registry.SKIP_REASONS
    for skipped in (False, True):
        assert registry.cells(skipped) == ref_registry.cells(skipped)
    assert len(registry.cells(include_skipped=True)) == 40


def reference_tree(cfg):
    """The reference's parameter tree of ``cfg`` as zeros of its shapes
    (``jax.eval_shape``: nothing is drawn)."""
    shapes = jax.eval_shape(RefModel(cfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_carried_names_and_shapes_equal_state_dict(arch):
    """Every parameter of the reference's tree lands on a parameter of the
    port's model of the same shape, and the port has no other."""
    carried = params_from_reference(reference_tree(
        ref_registry.smoke(arch)))
    model = Model(registry.smoke(arch), device="cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in carried.items()} == want


def test_carrier_unstacks_periods_in_order():
    """Period p, sub-layer j of the scanned stack is layer p*len(pattern)+j,
    and the remainder follows the periods."""
    period, periods = 3, 2
    tree = {"embed": {"table": np.zeros((4, 2), np.float32)},
            "scan": {f"sub{j}": {"w": np.stack(
                [np.full((2,), 10 * p + j, np.float32)
                 for p in range(periods)])} for j in range(period)},
            "rem": [{"w": np.full((2,), 99, np.float32)}]}
    layers_ = reference_layers(tree)
    assert [float(t["w"][0]) for t in layers_] == [0, 1, 2, 10, 11, 12, 99]
    sd = params_from_reference(tree)
    assert float(sd["layers.4.w"][0]) == 11 and float(sd["layers.6.w"][0]) \
        == 99 and sd["embed.table"].shape == (4, 2)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "falcon-mamba-7b",
                                  "llama4-scout-17b-a16e", "whisper-tiny"])
def test_compute_copy_keeps_the_reference_float32_set(arch):
    """At bf16 compute the same parameters stay float32 on both sides
    (decay rates, norm scales, the skip, the dt bias)."""
    ref_cfg = dataclasses.replace(ref_registry.smoke(arch),
                                  scan_layers=False, dtype="bfloat16")
    tree = jax.tree.map(jnp.asarray, reference_tree(ref_cfg))
    ref_cast = ref_model.cast_params_for_compute(tree, "bfloat16")
    want = {k for k, v in params_from_reference(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype ==
        jnp.float32 else np.zeros(a.shape, np.float16), ref_cast)).items()
        if v.dtype == torch.float32}
    cfg = dataclasses.replace(registry.smoke(arch), dtype="bfloat16")
    model = Model(cfg, device="cpu")
    copy = model_mod.cast_params_for_compute(model, "bfloat16")
    got = {k for k, v in params_from_reference(jax.tree.map(
        lambda t: t.detach().float().numpy() if t.dtype == torch.float32
        else np.zeros(t.shape, np.float16), copy)).items()
        if v.dtype == torch.float32}
    assert got == want and got
    # float32 compute holds the parameters themselves: no copy
    same = model_mod.cast_params_for_compute(model, "float32")
    assert same["embed"]["table"] is model.embed.table


def test_model_without_a_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(registry.smoke("stablelm-1.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--max-new", "1"])


def test_init_draws_from_the_generator():
    cfg = registry.smoke("recurrentgemma-9b")
    gen = torch.Generator()
    a = Model(cfg, device="cpu").init(gen.manual_seed(0))
    b = Model(cfg, device="cpu").init(gen.manual_seed(0))
    c = Model(cfg, device="cpu").init(gen.manual_seed(1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.table"], sc["embed.table"])
    assert all(torch.isfinite(v).all() for v in sa.values())
    # truncated at two standard deviations, as the reference draws
    assert float(sa["embed.table"].abs().max()) <= 2.0
    with pytest.raises(ValueError):
        Model(cfg, device="meta").init(gen)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    got = layers.ACTS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), atol=1e-6)
    assert np.abs(got - np.asarray(jax.nn.gelu(x, approximate=False))
                  ).max() > 1e-4


@pytest.mark.parametrize("chunk,remainder", [(8, False), (24, True)])
def test_lm_loss_chunked_matches_reference(chunk, remainder):
    rng = np.random.default_rng(chunk)
    b, s, d, v = 2, 64, 16, 50
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    want = ref_layers.lm_loss_chunked(jnp.asarray(x), jnp.asarray(table),
                                      jnp.asarray(labels), jnp.asarray(mask),
                                      chunk=chunk, z_loss=1e-3)
    got = layers.lm_loss_chunked(torch.from_numpy(x), torch.from_numpy(table),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask), chunk=chunk,
                                 z_loss=1e-3)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert (s % chunk != 0) == remainder


def test_fully_masked_row_stays_finite():
    """A ring slot with no valid key gets NEG_INF logits, not -inf: its
    softmax is uniform, not NaN (as the reference's)."""
    q = torch.randn(1, 1, 2, 4)
    k = torch.randn(1, 3, 2, 4)
    mask = torch.zeros(1, 1, 3, dtype=torch.bool)
    out = sdpa(q, k, k, mask)
    assert torch.isfinite(out).all() and NEG_INF == -1e30
    torch.testing.assert_close(out[0, 0], k[0].mean(0))


def test_sharding_is_identity_on_one_device():
    x = torch.randn(2, 3)
    assert sharding.shard(x, "batch", None) is x
    assert sharding.gather_for_compute(x, None, "ff") is x
    assert sharding.current_rules() is None and sharding.axis_size("ff") == 1
    mesh = Mesh([torch.device("cpu")], ("model",))
    rules = dict(sharding.DEFAULT_RULES, batch=None)
    with sharding.use_mesh_rules(mesh, rules):
        assert sharding.current_rules() == (mesh, rules)
        assert sharding.axis_size("ff") == 1
        assert sharding.resolve_spec(rules, "batch", "heads", None) == \
            (None, "model", None)
        assert sharding.shard(x, "batch", "ff") is x
    assert sharding.current_rules() is None


def test_sharding_refuses_a_mesh_of_more_than_one_device():
    """A mesh of more than one device is taken (``launch/steps.py`` runs
    it), but only with rules naming its own axes: DEFAULT_RULES name
    "pod" and "data", which a ("model",) mesh lacks."""
    mesh = Mesh([torch.device("cpu")] * 2, ("model",))
    with pytest.raises(ValueError, match="lacks"):
        with sharding.use_mesh_rules(mesh, sharding.DEFAULT_RULES):
            pass
    with sharding.use_mesh_rules(mesh, {"heads": "model"}):
        assert sharding.axis_size("heads") == 2


def test_steps_are_the_model_entry_points():
    cfg = registry.smoke("gemma3-12b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    cache, logits = steps.build_prefill(model, 24)({"tokens": tokens})
    cache2, logits2 = model.prefill({"tokens": tokens}, 24)
    assert torch.equal(logits, logits2) and cache["step"] == 20
    step, cache = steps.build_decode(model)(cache, tokens[:, :1])
    step2, _ = model.decode_step(cache2, tokens[:, :1])
    assert torch.equal(step, step2) and cache["step"] == 21
    empty = model.init_cache(2, 24)
    assert empty["step"] == 0 and len(empty["layers"]) == cfg.n_layers


def test_generate_samples_from_the_generator():
    cfg = registry.smoke("stablelm-1.6b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    draws = [serve.generate(model, prompts, 5, 16, temperature=1.0,
                            generator=torch.Generator().manual_seed(s))
             for s in (7, 7, 8)]
    assert draws[0].shape == (2, 5)
    assert torch.equal(draws[0], draws[1])
    greedy = serve.generate(model, prompts, 5, 16)
    assert torch.equal(greedy[:, :1], draws[0][:, :1])   # from the prefill
    assert int(draws[0].max()) < cfg.vocab_size


def test_serve_cli():
    args = serve.parse_args([])
    assert args.smoke and args.device is None and args.arch == \
        "stablelm-1.6b"
    assert serve.parse_args(["--no-smoke"]).smoke is False
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                    "--max-new", "3", "--arch", "falcon-mamba-7b"])
    assert "generated 6 tokens" in out.getvalue()


@pytest.mark.parametrize("arch,kind,cross", [
    ("stablelm-1.6b", "global", False), ("gemma3-12b", "local", False),
    ("falcon-mamba-7b", "mamba", False), ("recurrentgemma-9b", "rglru", False),
    ("granite-moe-3b-a800m", "global", False),
    ("llama4-scout-17b-a16e", "local", False),
    ("whisper-tiny", "global", True)])
def test_init_layer_matches_reference_layout(arch, kind, cross):
    """``init_layer`` draws one block with the reference's parameter names
    and shapes, for every mixer and FFN kind."""
    ref_cfg, cfg = ref_registry.smoke(arch), registry.smoke(arch)
    shapes = jax.eval_shape(lambda k: ref_model.init_layer(
        k, ref_cfg, kind, cross), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in params_from_reference(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    layer = model_mod.init_layer(torch.Generator().manual_seed(0), cfg,
                                 kind, cross)
    got = {k: tuple(v.shape) for k, v in layer.state_dict().items()}
    assert got == want
    assert all(torch.isfinite(v).all() for v in layer.state_dict().values())


def test_layer_functions_take_the_module_or_the_tree():
    """``layer_forward`` / ``layer_decode`` read a block's weights as
    ``p["name"]`` from the module itself or from the compute copy."""
    cfg = registry.smoke("whisper-tiny")
    layer = model_mod.init_layer(torch.Generator().manual_seed(0), cfg,
                                 "global", cross=True)
    tree = model_mod.cast_params_for_compute(layer, "float32")
    x = torch.randn(2, 8, cfg.d_model)
    enc = torch.randn(2, 5, cfg.d_model)
    pos = torch.arange(8)[None].expand(2, 8)
    with torch.no_grad():
        a = model_mod.layer_forward(layer, cfg, "global", x, pos,
                                    enc_out=enc)
        b = model_mod.layer_forward(tree, cfg, "global", x, pos,
                                    enc_out=enc)
    assert a[2] is not None and torch.equal(a[0], b[0])
