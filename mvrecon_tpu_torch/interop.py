"""Carry state between the JAX package and the port as numpy arrays and
plain dicts, so that both can be fed the same starting point. Nothing
here knows a JAX type: the caller converts with ``np.asarray`` and
``dataclasses.asdict`` on its side.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import LMConfig, as_tensor
from .models.bundle_adjustment import BAState


def ba_state_from_numpy(X, f, u, t, R, device, dtype) -> BAState:
    """A ``BAState`` of tensors on ``device`` from numpy arrays."""
    dev = torch.device(device)
    return BAState(*(as_tensor(a, dev, dtype) for a in (X, f, u, t, R)))


def distortion_from_numpy(dist, like: torch.Tensor) -> torch.Tensor:
    """A numpy (F, n) distortion of any family as the port's tensor, in the
    dtype and on the device of ``like`` (the problem's observations or
    state)."""
    return as_tensor(dist, like.device, like.dtype)


def lm_config_from_fields(fields: dict) -> LMConfig:
    """The port's ``LMConfig`` from the fields of the JAX one
    (``dataclasses.asdict``); unknown fields raise."""
    known = {f.name for f in dataclasses.fields(LMConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"fields the port's LMConfig lacks: {sorted(unknown)}")
    return LMConfig(**fields)


def results_to_numpy(result) -> dict:
    """A result tuple of the port (``BAResult``, ``CalibrationResult``,
    ``ReconstructionResult``) -> dict of numpy arrays and Python scalars
    (a ``BAResult``'s ``distortion`` too, None for a pinhole run); nested
    dicts (the logs) are converted the same way."""

    def conv(v):
        if torch.is_tensor(v):
            return v.detach().cpu().numpy()
        if isinstance(v, dict):
            return {k: conv(w) for k, w in v.items()}
        return v

    return {k: conv(v) for k, v in result._asdict().items()}
