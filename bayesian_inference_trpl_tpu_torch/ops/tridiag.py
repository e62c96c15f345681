"""Lane shifts along the spatial (last) axis, the building block of the
PCR sweeps and of the nearest-neighbour coupling in models/newton.py."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def shift_right(x: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """y[..., i] = x[..., i-k] for i >= k else fill (k > 0)."""
    return F.pad(x[..., :-k], (k, 0), value=fill)


def shift_left(x: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """y[..., i] = x[..., i+k] for i < L-k else fill (k > 0)."""
    return F.pad(x[..., k:], (0, k), value=fill)
