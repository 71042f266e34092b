"""Lanes: independent problems stacked along leading batch dimensions and
advanced together, as ``vmap`` advances a batched ``lax.while_loop``. A
lane that has stopped keeps its values while the others go on."""

from __future__ import annotations

import torch


def lane_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v``, whose dimensions are the leading batch dimensions of ``like``,
    with trailing ones so that it broadcasts against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def keep(run: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` in the lanes where ``run`` holds, else ``old``."""
    return torch.where(lane_view(run, new), new, old)


def keep_all(run: torch.Tensor, new: tuple, old: tuple) -> tuple:
    """:func:`keep` over two tuples (or named tuples) of tensors of the same
    type."""
    vals = [keep(run, a, b) for a, b in zip(new, old)]
    return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)
