"""The weight carrier: the reference's parameter trees as the port's
``state_dict``.

``params_from_reference(tree)`` takes a tree of nested dicts and lists of
numpy arrays — the JAX package's ``Model.init`` tree, or its
``init_fftconv`` dict, with every leaf made a numpy array — and returns
the ``state_dict`` of ``models.Model`` (or of ``FFTConvMixer``): a dict
path joined with dots is the parameter's name. The reference stacks the
layers of full pattern periods under ``params["scan"]["sub{j}"]`` with a
leading period axis; period p, sub-layer j is the port's layer
p * len(pattern) + j, and the unrolled remainder ``params["rem"][r]``
follows the periods.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(node, prefix: str, out: dict) -> dict:
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = torch.from_numpy(np.array(node, copy=True))
    return out


def _unstack(stacked):
    """A scan-stacked sub-layer tree (leading axis P) -> P trees."""
    if isinstance(stacked, dict):
        parts = {k: _unstack(v) for k, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    arr = np.asarray(stacked)
    return [arr[i] for i in range(arr.shape[0])]


def reference_layers(tree) -> list:
    """The reference's decoder layers in order, one tree each."""
    layers = list(tree.get("layers", []))
    if "scan" in tree:
        subs = tree["scan"]
        period = len(subs)
        per_sub = [_unstack(subs[f"sub{j}"]) for j in range(period)]
        for p in range(len(per_sub[0])):
            layers += [per_sub[j][p] for j in range(period)]
    return layers + list(tree.get("rem", []))


def params_from_reference(tree) -> dict:
    """The port's ``state_dict`` of a reference parameter tree (module
    docstring)."""
    out: dict = {}
    rest = {k: v for k, v in tree.items() if k not in ("scan", "layers",
                                                       "rem")}
    _flatten(rest, "", out)
    if any(k in tree for k in ("scan", "layers", "rem")):
        _flatten(reference_layers(tree), "layers.", out)
    return out


def opt_state_from_reference(state) -> dict:
    """The port's AdamW state of a reference AdamW state (``mu`` and
    ``nu`` parameter-shaped trees of numpy arrays, ``step`` a scalar)."""
    return {"mu": params_from_reference(state["mu"]),
            "nu": params_from_reference(state["nu"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}
