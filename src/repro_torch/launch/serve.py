"""Serving: prefill a batch of prompts, then decode with batched
single-token steps against the KV caches (full / ring / recurrent state).

    python -m repro_torch.launch.serve --arch stablelm-1.6b --no-smoke

runs the full configuration on the card with weights drawn from seed 0;
``--smoke`` (the default) a reduced one, and ``--device cpu`` the plain
PyTorch path on the CPU. ``--mesh 4x1`` serves over a (data, model) mesh
of slabs of that one device (``launch/steps.py``: the batch cut over
"data", the weights and the KV caches stored in the reference's
layout).
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import torch

from repro_torch.configs import registry
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import activation_rules, make_host_mesh
from repro_torch.launch.steps import (ShardedServing, build_decode,
                                      build_prefill, shard_params)
from repro_torch.models import Model


def generate(model: Model, prompts: torch.Tensor, max_new: int,
             max_len: int, mesh=None, rules: Optional[dict] = None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompts: (B, S) int -> (B, max_new) int64 greedy tokens, or tokens
    sampled at ``temperature`` from ``generator`` when both are given.

    The weights are cast to the compute dtype once for the whole call.
    The step after the last token is not run: its logits would choose a
    token that is not returned.

    ``mesh``: serve over it (``rules`` defaulting to
    ``activation_rules(mesh)``), the model's weights laid out by
    ``param_shardings``."""
    cfg = model.cfg
    if mesh is not None:
        rules = rules or activation_rules(mesh)
        values = dict(model.named_parameters())
        params = shard_params(values, shd.param_shardings(values, cfg, mesh,
                                                          rules))
        serving = ShardedServing(model, mesh, rules, params)
        device = serving.devices[0]
        prefill = lambda b: serving.prefill(b, max_len)  # noqa: E731
        decode = serving.decode
        cast = contextlib.nullcontext()
    else:
        device = model.device
        prefill = build_prefill(model, max_len)
        decode = build_decode(model)
        cast = model.compute_cast()
    prompts = prompts.to(device)
    batch = {"tokens": prompts}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros(
            (prompts.shape[0], cfg.encoder.n_frames, cfg.d_model),
            dtype=torch.float32, device=device)
    outs = []
    with torch.inference_mode(), cast:
        cache, logits = prefill(batch)
        tok = torch.argmax(logits, dim=-1)[:, None]
        for i in range(max_new):
            outs.append(tok)
            if i == max_new - 1:
                break
            logits, cache = decode(cache, tok)
            if temperature > 0.0 and generator is not None:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = torch.argmax(logits, dim=-1)[:, None]
    return torch.cat(outs, dim=1)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when not given")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: serve over a mesh of that many slabs "
                    "of the device")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    model = Model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    model.init(gen)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=model.device)
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else (lambda: None))
    mesh = None
    if args.mesh:
        data, mdl = (int(v) for v in args.mesh.split("x"))
        mesh = make_host_mesh(mdl, [model.device] * (data * mdl))
    sync()
    t0 = time.perf_counter()
    toks = generate(model, prompts, args.max_new,
                    args.prompt_len + args.max_new, mesh=mesh)
    sync()
    dt = time.perf_counter() - t0
    n = args.batch * args.max_new
    print(f"arch={cfg.name} device={model.device}: generated {n} tokens in "
          f"{dt:.3f}s ({n / dt:.1f} tok/s, first call)")
    print("sample:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
