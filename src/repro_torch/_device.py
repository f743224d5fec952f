"""Where the port's entry points run: the card unless the caller says so."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the CUDA card and raises when there is none; any
    explicit device (``"cpu"``, ``"cuda:1"``) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch version")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
