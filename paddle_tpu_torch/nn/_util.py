"""Helpers shared by the low-precision linears (``amp.fp8``, ``nn.quant``,
``quantization``): swapping a submodule by its dotted name, and zero
padding a matrix up to the shapes the card's GEMMs take."""
from __future__ import annotations

import torch


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` ([R, C]) in the top-left corner of zeros ``[rows, cols]``
    (``t`` itself when nothing is added)."""
    if tuple(t.shape) == (rows, cols):
        return t
    out = t.new_zeros((rows, cols))
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _swap(model, name: str, new) -> None:
    """Set ``model``'s submodule at dotted ``name`` to ``new``."""
    parent = model
    parts = name.split(".")
    for p in parts[:-1]:
        parent = getattr(parent, p)
    setattr(parent, parts[-1], new)
