"""Model assembly: init / forward / prefill / decode for every assigned
architecture family.

Layers follow `cfg.pattern` cycled over n_layers, held as one flat
``nn.ModuleList`` (the reference stacks full pattern periods for its
``lax.scan``; ``models.convert`` unstacks them: period p, sub-layer j is
layer p * len(pattern) + j).

Caches (one entry a layer, in ``cache["layers"]``):
  'global' mixers -> full KV cache (B, max_len, K, Dh)
  'local'  mixers -> ring KV cache (B, window, K, Dh) + slot positions
  'mamba'/'rglru' -> O(1) recurrent state
Decode writes the KV caches in place.

Compute dtype: the weights are float32; ``cast_params_for_compute`` makes
the compute copy (the recurrences' decay rates, norm scales, the skip and
the dt bias stay float32). ``forward`` / ``prefill`` / ``decode_step`` make
it on every call, as the reference does, unless the caller holds one
across calls with ``Model.compute_cast()`` — ``launch.serve.generate``
does, so a prompt batch is cast once and not once a token.

Training: ``loss`` is differentiable through the compute copy to the
float32 parameters; with ``cfg.remat`` the layers are rematerialised in
groups as the reference's ``jax.checkpoint`` does (``_layer_groups``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ModelConfig, RGLRUConfig, SSMConfig
from repro_torch.models.layers import (
    MLP,
    Embedding,
    ParamModule,
    RMSNorm,
    as_dtype,
    embed,
    lm_loss_chunked,
    logits_last,
    mlp,
    param_tree,
    rmsnorm,
    sinusoidal_positions,
)
from repro_torch.models.moe import MoE, moe_ffn
from repro_torch.models.sharding import carry_context, shard

KINDS_ATTN = ("global", "local")
KINDS_REC = ("mamba", "rglru")

# parameters that must stay float32 regardless of compute dtype (recurrence
# decay rates, norm scales, dt bias — bf16 here visibly hurts numerics)
_NO_CAST = ("a_log", "lambda", "scale", "d_skip")


def _keep_f32(path: tuple) -> bool:
    return any(k in _NO_CAST for k in path) or (
        "dt_proj" in path and path[-1] == "b")


def cast_params_for_compute(params, dtype: str):
    """The compute copy: a module's (or a parameter tree's) weights as a
    tree of tensors, float32 leaves cast to ``dtype`` but for ``_NO_CAST``
    and the dt bias. At float32 the tree holds the parameters themselves.
    With gradients enabled each cast leaf stays on the autograd graph, so
    ``Model.loss`` reaches every float32 parameter through it, as
    ``jax.grad`` reaches every leaf through ``astype``."""
    if isinstance(params, nn.Module):
        params = param_tree(params)
    if as_dtype(dtype) == torch.float32:
        return params
    dt = as_dtype(dtype)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path) for v in node]
        if _keep_f32(path) or node.dtype != torch.float32:
            return node
        return node.to(dt)

    return walk(params, ())


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, kind: str, q_chunk=None,
               encoder: bool = False, cross: bool = False) -> attn.AttnSpec:
    return attn.AttnSpec(
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        causal=not (encoder or cross),
        window=cfg.window if kind == "local" else None,
        theta=cfg.rope_theta,
        sections=cfg.mrope_sections,
        use_rope=cfg.encoder is None,     # whisper: absolute sinusoid instead
        q_chunk=q_chunk,
    )


class Layer(ParamModule):
    """One block: norm1 + mixer, [norm_x + cross-attention], [norm2 + FFN]
    (no FFN after a Mamba mixer)."""

    def __init__(self, cfg: ModelConfig, kind: str, cross: bool = False,
                 device=None):
        super().__init__(device)
        d = cfg.d_model
        self.norm1 = RMSNorm(d, device)
        if kind in KINDS_ATTN:
            self.mixer = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, device)
        elif kind == "mamba":
            self.mixer = rec.Mamba(d, cfg.ssm or SSMConfig(), device)
        elif kind == "rglru":
            self.mixer = rec.RGLRU(d, cfg.rglru or RGLRUConfig(), device)
        else:
            raise ValueError(kind)
        if cross:
            self.norm_x = RMSNorm(d, device)
            self.cross = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, device)
        if kind != "mamba":
            self.norm2 = RMSNorm(d, device)
            if cfg.ffn == "mlp":
                self.ffn = MLP(d, cfg.d_ff, device)
            elif cfg.ffn == "moe":
                self.ffn = MoE(d, cfg.d_ff, cfg.moe, device)

    def reset_parameters(self, generator: torch.Generator):
        for m in self.children():
            m.reset_parameters(generator)


def init_layer(generator: torch.Generator, cfg: ModelConfig, kind: str,
               cross: bool = False) -> Layer:
    layer = Layer(cfg, kind, cross, generator.device)
    layer.reset_parameters(generator)
    return layer


# ---------------------------------------------------------------------------
# Per-layer forward (training / prefill): returns (x, cache_entry, aux)
# ---------------------------------------------------------------------------

def layer_forward(p, cfg: ModelConfig, kind: str, x, positions,
                  q_chunk=None, enc_out=None, train: bool = True):
    spec = _attn_spec(cfg, kind, q_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in KINDS_ATTN:
        y, entry = attn.attn_forward(p["mixer"], spec, h, positions)
    elif kind == "mamba":
        y, entry = rec.mamba_forward(p["mixer"], h, cfg.ssm or SSMConfig())
    else:  # rglru
        y, entry = rec.rglru_forward(p["mixer"], h, cfg.rglru or RGLRUConfig())
    y = shard(y, "batch", "seq", None)
    x = x + y

    if "cross" in p and enc_out is not None:
        hq = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                               device=x.device)[None].expand(
                                   *enc_out.shape[:2])
        cspec = dataclasses.replace(spec, causal=False, window=None,
                                    use_rope=False)
        yx, centry = attn.attn_forward(p["cross"], cspec, hq,
                                       positions, k_pos=enc_pos, xkv=enc_out)
        x = x + yx
    else:
        centry = None

    if kind != "mamba":
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if cfg.ffn == "moe":
            y2, aux = moe_ffn(p["ffn"], h2, cfg.moe, cfg.act, train)
        else:
            y2 = mlp(p["ffn"], h2, cfg.act)
        y2 = shard(y2, "batch", "seq", None)
        x = x + y2
    return x, entry, centry, aux


# ---------------------------------------------------------------------------
# Per-layer decode: returns (x, new_cache_entry)
# ---------------------------------------------------------------------------

def layer_decode(p, cfg: ModelConfig, kind: str, x, cache_entry, pos: int,
                 cross_cache=None):
    spec = _attn_spec(cfg, kind)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in KINDS_ATTN:
        y, new_entry = attn.attn_decode(p["mixer"], spec, h, cache_entry, pos)
    elif kind == "mamba":
        y, new_entry = rec.mamba_step(p["mixer"], h, cfg.ssm or SSMConfig(),
                                      cache_entry)
    else:
        y, new_entry = rec.rglru_step(p["mixer"], h,
                                      cfg.rglru or RGLRUConfig(), cache_entry)
    x = x + y
    if "cross" in p and cross_cache is not None:
        hq = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        cspec = dataclasses.replace(spec, causal=False, window=None,
                                    use_rope=False)
        x = x + attn.cross_decode(p["cross"], cspec, hq, cross_cache)
    if kind != "mamba":
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if cfg.ffn == "moe":
            y2, _ = moe_ffn(p["ffn"], h2, cfg.moe, cfg.act, train=False)
        else:
            y2 = mlp(p["ffn"], h2, cfg.act)
        x = x + y2
    return x, new_entry


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Encoder(nn.Module):
    """Whisper-style encoder over precomputed frame embeddings (stub)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(cfg, "global", cross=False, device=device)
            for _ in range(cfg.encoder.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device)


class Model(nn.Module):
    """The LM of one ``ModelConfig``: its float32 weights on ``device``
    (``None``: the CUDA card, raising without one; pass ``"cpu"`` to run
    the plain PyTorch path here), allocated empty — ``init(generator)``
    draws them, ``load_state_dict(convert.params_from_reference(tree))``
    takes the reference's."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        cross = cfg.is_encoder_decoder
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dev)
        self.final_norm = RMSNorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg.vocab_size, cfg.d_model, dev)
        self.layers = nn.ModuleList(
            Layer(cfg, kind, cross, dev) for kind in cfg.layer_kinds)
        if cross:
            self.encoder = Encoder(cfg, dev)
        self._pinned = None

    # ---- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator`` (on the model's device), in
        place. Returns the model."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        self.embed.reset_parameters(generator)
        if not self.cfg.tie_embeddings:
            self.lm_head.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        if self.cfg.is_encoder_decoder:
            for layer in self.encoder.layers:
                layer.reset_parameters(generator)
        return self

    @contextlib.contextmanager
    def compute_cast(self):
        """Hold one compute copy of the weights for the calls inside."""
        prev = self._pinned
        with torch.no_grad():
            self._pinned = cast_params_for_compute(self, self.cfg.dtype)
        try:
            yield self._pinned
        finally:
            self._pinned = prev

    def _params(self, params=None):
        if params is not None:
            return params
        if self._pinned is not None:
            return self._pinned
        return cast_params_for_compute(self, self.cfg.dtype)

    def compute_params(self, values: dict):
        """The compute copy of other weights than the model's own:
        ``values`` is ``{state_dict name: tensor}`` (a data position's
        gathered weights); on the autograd graph of those tensors when
        gradients are enabled. The ``params`` argument of ``loss``,
        ``forward``, ``prefill`` and ``decode_step`` takes it."""
        return cast_params_for_compute(param_tree(self, values),
                                       self.cfg.dtype)

    def _table(self, params):
        return (params["embed"]["table"] if self.cfg.tie_embeddings
                else params["lm_head"]["table"])

    # ---- encoder (whisper; frames are precomputed stub embeddings) ----------
    def encode(self, frames, params=None):
        return self._encode(self._params(params), frames)

    def _encode(self, params, frames):
        cfg = self.cfg
        x = frames.to(_device_of(params), as_dtype(cfg.dtype))
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)
        pos = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device)[None].expand(*x.shape[:2])
        spec = _attn_spec(cfg, "global", encoder=True)
        for p in params["encoder"]["layers"]:
            h = rmsnorm(p["norm1"], x, cfg.norm_eps)
            y, _ = attn.attn_forward(p["mixer"], spec, h, pos)
            x = x + y
            h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
            x = x + mlp(p["ffn"], h2, cfg.act)
        return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)

    # ---- backbone forward ---------------------------------------------------
    def _inputs_to_x(self, params, batch):
        """tokens (+ stub frontend embeddings) -> initial hidden states."""
        cfg = self.cfg
        dt = as_dtype(cfg.dtype)
        dev = _device_of(params)
        tokens = batch["tokens"].to(dev)
        x = embed(params["embed"], tokens, dt)
        if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(dev, dt)
            n = pe.shape[1]
            x = torch.cat([x[:, :n] + pe, x[:, n:]], dim=1)
        if cfg.is_encoder_decoder:
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                         x.device).to(x.dtype)
        if "positions" in batch:
            positions = batch["positions"].to(dev)
        else:
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)[None].expand(
                                         *x.shape[:2])
            if cfg.mrope_sections is not None:
                positions = positions[..., None].repeat(
                    1, 1, len(cfg.mrope_sections))
        return x, positions

    def forward(self, batch, collect_cache: bool = False,
                train: bool = True, params=None):
        """Returns (final hidden states, aux_loss, cache entries): one
        (entry, cross entry) a layer when ``collect_cache``. ``params``:
        a compute copy (``compute_params``) instead of the model's own."""
        return self._forward(self._params(params), batch, collect_cache,
                             train)

    def _forward(self, params, batch, collect_cache, train):
        cfg = self.cfg
        x, positions = self._inputs_to_x(params, batch)
        s = x.shape[1]
        q_chunk = cfg.attn_q_chunk or (1024 if s >= 4096 else None)
        enc_out = None
        if cfg.is_encoder_decoder:
            enc_out = self._encode(params, batch["frames"])
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        entries = []

        def run_group(x, group):
            aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
            out = []
            for p, kind in group:
                x, e, ce, aux = layer_forward(p, cfg, kind, x, positions,
                                              q_chunk, enc_out, train)
                aux_g = aux_g + aux
                out.append((e, ce))
            return x, aux_g, out

        remat = cfg.remat and torch.is_grad_enabled()
        enter = carry_context()     # the recomputation's thread

        def remat_group(x, group):
            with enter():
                return run_group(x, group)[:2]

        for group, body in self._layer_groups(params["layers"]):
            if body and remat:
                x, aux_g = checkpoint(remat_group, x, group,
                                      use_reentrant=False)
                out = []
            else:
                x, aux_g, out = run_group(x, group)
            aux_total = aux_total + aux_g
            if collect_cache:
                entries += out
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x, aux_total, entries

    def _layer_groups(self, layers):
        """The flat layer list as the reference runs it: ``(group, body)``
        pairs in order, ``group`` a list of (params, kind). With
        ``scan_layers`` and more than one full period, each full pattern
        period is one group (the reference's scanned, rematerialised
        body); otherwise each of those layers is a group of its own (the
        reference's per-layer ``jax.checkpoint``). The remainder layers
        come last, one a group, with ``body`` False: never
        rematerialised."""
        cfg = self.cfg
        pairs = list(zip(layers, cfg.layer_kinds))
        n_body = cfg.n_periods * len(cfg.pattern)
        span = (len(cfg.pattern) if cfg.scan_layers and cfg.n_periods > 1
                else 1)
        groups = [(pairs[i:i + span], True) for i in range(0, n_body, span)]
        return groups + [([pr], False) for pr in pairs[n_body:]]

    # ---- training loss ------------------------------------------------------
    def loss(self, batch, params=None, denom=None):
        """Mean next-token cross-entropy plus the MoE aux loss: a 0-d
        float32 tensor on the autograd graph of the float32 parameters
        (through the compute copy). With ``cfg.remat`` and gradients
        enabled, each full pattern period (or layer, ``_layer_groups``) is
        recomputed in backward, and so is each loss chunk.

        ``params``: a compute copy (``compute_params``) instead of the
        model's own; ``denom``: the count the summed NLL is divided by
        (``lm_loss_chunked``) — a data position's share of a global batch
        passes the global mask's sum."""
        cfg = self.cfg
        params = self._params(params)
        x, aux, _ = self._forward(params, batch, False, True)
        mask = batch.get("loss_mask")
        nll = lm_loss_chunked(x, self._table(params),
                              batch["labels"].to(x.device),
                              None if mask is None else mask.to(x.device),
                              cfg.loss_chunk, denom=denom)
        return nll + aux

    # ---- serving ------------------------------------------------------------
    def _entry_to_cache(self, kind, entry, max_len, cache_dtype):
        """A prefill (k, v) / state entry as a decode cache entry."""
        cfg = self.cfg
        if kind in KINDS_REC:
            return entry  # (h_last, conv_buf) already the decode state
        k, v = entry
        b, s = k.shape[0], k.shape[1]
        dev = k.device
        if kind == "local":
            w = min(cfg.window, max_len)
            pos0 = torch.arange(s, dtype=torch.int32, device=dev)
            if s >= w:
                # keep the last w positions; ring slot of position p is
                # p % w, so the contiguous tail is rolled by (s - w) % w.
                shift = (s - w) % w
                kk = torch.roll(k[:, s - w:], shift, dims=1)
                vv = torch.roll(v[:, s - w:], shift, dims=1)
                ppos = torch.roll(pos0[s - w:].expand(b, w), shift, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, w - s)
                kk = torch.nn.functional.pad(k, pad)
                vv = torch.nn.functional.pad(v, pad)
                ppos = torch.cat([pos0.expand(b, s), torch.full(
                    (b, w - s), -1, dtype=torch.int32, device=dev)], dim=1)
            return {"k": kk.to(cache_dtype).contiguous(),
                    "v": vv.to(cache_dtype).contiguous(),
                    "pos": ppos.contiguous()}
        # global: place [0:s] into a max_len buffer
        shape = (b, max_len, *k.shape[2:])
        kk = torch.zeros(shape, dtype=cache_dtype, device=dev)
        vv = torch.zeros(shape, dtype=cache_dtype, device=dev)
        kk[:, :s] = k
        vv[:, :s] = v
        return {"k": kk, "v": vv}

    @torch.no_grad()
    def prefill(self, batch, max_len: int, params=None):
        """Run the prompt; return (cache, last-position logits)."""
        cfg = self.cfg
        params = self._params(params)
        x, _, entries = self._forward(params, batch, True, False)
        cdt = as_dtype(cfg.dtype)
        cache: dict[str, Any] = {"step": int(batch["tokens"].shape[1])}
        cache["layers"] = [
            self._entry_to_cache(kind, e, max_len, cdt)
            for kind, (e, _) in zip(cfg.layer_kinds, entries)]
        if cfg.is_encoder_decoder:
            cache["cross"] = [{"k": ce[0], "v": ce[1]} for _, ce in entries]
        return cache, logits_last(x[:, -1], self._table(params))

    @torch.no_grad()
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device=None) -> dict:
        """Empty decode cache on ``device`` (the model's when None;
        ``"meta"`` lays out its shapes without allocating)."""
        cfg = self.cfg
        cdt = as_dtype(dtype or cfg.dtype)
        hd, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
        dev = self.device if device is None else torch.device(device)

        def one(kind):
            if kind == "global":
                return attn.init_full_cache(batch, max_len, nkv, hd, cdt, dev)
            if kind == "local":
                return attn.init_ring_cache(batch, min(cfg.window, max_len),
                                            nkv, hd, cdt, dev)
            if kind == "mamba":
                return rec.init_mamba_state(batch, cfg.d_model,
                                            cfg.ssm or SSMConfig(), dev)
            return rec.init_rglru_state(batch, cfg.d_model,
                                        cfg.rglru or RGLRUConfig(), dev)

        cache: dict[str, Any] = {"step": 0,
                                 "layers": [one(k) for k in cfg.layer_kinds]}
        if cfg.is_encoder_decoder:
            cache["cross"] = [
                attn.init_full_cache(batch, cfg.encoder.n_frames, nkv, hd,
                                     cdt, dev) for _ in cfg.layer_kinds]
        return cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: Optional[int] = None,
                    params=None):
        """One token for the whole batch. tokens: (B, 1). Returns
        (logits (B, V) float32, new cache); the KV caches are written in
        place."""
        cfg = self.cfg
        pos = int(cache["step"] if pos is None else pos)
        params = self._params(params)
        x = embed(params["embed"], tokens.to(_device_of(params)),
                  as_dtype(cfg.dtype))
        if cfg.is_encoder_decoder:
            # absolute sinusoid at the runtime position
            x = x + _sinusoid_at(pos, cfg.d_model, x.device).to(x.dtype)
        cross = cache.get("cross")
        layers = []
        for i, (p, kind) in enumerate(zip(params["layers"], cfg.layer_kinds)):
            cc = cross[i] if cross is not None else None
            x, ne = layer_decode(p, cfg, kind, x, cache["layers"][i], pos, cc)
            layers.append(ne)
        new_cache = dict(cache, step=pos + 1, layers=layers)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return logits_last(x[:, 0], self._table(params)), new_cache


def _device_of(params) -> torch.device:
    """The device a compute copy lives on (its embedding table's)."""
    return params["embed"]["table"].device


def _sinusoid_at(pos: int, d: int, device=None):
    """Single-position sinusoidal embedding at runtime index `pos`."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    t = torch.tensor(float(pos), dtype=torch.float32, device=device) * freq
    return torch.cat([torch.sin(t), torch.cos(t)])[None, None, :]
