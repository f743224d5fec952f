"""Tiled corner turn (used by the paper-faithful ``fused`` RDA variant).

``transpose`` turns ``(R, C) -> (C, R)`` or a batch ``(B, R, C) ->
(B, C, R)`` in ONE launch. Where it runs is decided by the tensor alone:

* a CUDA tensor launches the hand-written kernel ``csrc/transpose.cu``
  (float32 or complex64, counted in ``TRANSPOSE_LAUNCHES``), or raises —
  there is no fallback;
* a CPU tensor runs the plain PyTorch version ``transpose_plain``, which
  pads ragged dims to the tile grid, swaps the last two axes and slices
  back, as the JAX package's Pallas kernel does (any dtype).

A transpose is exact, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# Launches of the CUDA transpose kernel in this process (one per call on a
# CUDA tensor, counted where the launch succeeds and nowhere else).
TRANSPOSE_LAUNCHES = 0

KERNEL_NAME = "transpose"
_ELEM_BYTES = {torch.float32: 4, torch.complex64: 8}


def _check(x: torch.Tensor, tile: int) -> None:
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    if x.ndim not in (2, 3):
        raise ValueError(f"transpose takes (R, C) or (B, R, C), got shape "
                         f"{tuple(x.shape)}")


def transpose_plain(x: torch.Tensor, *, tile: int = 256) -> torch.Tensor:
    """The plain version on any device: pad (R, C) to the ``tile`` grid,
    swap the last two axes, slice back to (C, R)."""
    _check(x, tile)
    r, c = x.shape[-2:]
    t = min(tile, r, c)
    pr, pc = (-r) % t, (-c) % t
    if pr or pc:
        x = F.pad(x, (0, pc, 0, pr))
    y = x.transpose(-1, -2)
    if pr or pc:
        y = y[..., :c, :r]
    return y.contiguous()


def _bind():
    lib = _build.load(KERNEL_NAME)
    fn = lib.transpose_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.transpose_error_string.argtypes = [i]
        lib.transpose_error_string.restype = ctypes.c_char_p
    return lib


def _launch_cuda(x: torch.Tensor) -> torch.Tensor:
    global TRANSPOSE_LAUNCHES
    elem = _ELEM_BYTES.get(x.dtype)
    if elem is None:
        raise ValueError(f"the CUDA transpose kernel takes float32 or "
                         f"complex64, got {x.dtype}")
    x = x.contiguous()
    b, r, c = x.shape if x.ndim == 3 else (1, *x.shape)
    y = torch.empty((*x.shape[:-2], c, r), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.transpose_launch(x.data_ptr(), y.data_ptr(), b, r, c, elem,
                                   stream)
    if err != 0:
        msg = lib.transpose_error_string(err).decode()
        raise RuntimeError(f"transpose kernel launch failed ({err}): {msg}")
    TRANSPOSE_LAUNCHES += 1
    return y


def transpose(x: torch.Tensor, *, tile: int = 256) -> torch.Tensor:
    """Tiled (R, C) -> (C, R) transpose; (B, R, C) -> (B, C, R) batched,
    one launch. ``tile`` is validated and used by the plain version (the
    CUDA kernel keeps its own 32 x 32 tile and masks ragged edges)."""
    if x.device.type == "cpu":
        return transpose_plain(x, tile=tile)
    _check(x, tile)
    if x.device.type == "cuda":
        return _launch_cuda(x)
    raise ValueError(f"no transpose kernel for device {x.device}")
