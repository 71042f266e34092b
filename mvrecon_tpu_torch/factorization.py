"""Reference-named ``factorization`` module (counterpart of
``mvrecon_tpu/factorization.py``)."""

from __future__ import annotations

import torch

from .config import as_tensor, resolve_device, result_dtype
from .ops.factorization import factorization_method as _factorization_method


def factorization_method(W, n_rank: int = 4, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor the observation matrix W (M, P) into motion (M, n_rank) and
    shape (n_rank, P) by the SVD. W is a numpy array or a tensor; runs on
    the card unless ``device`` says otherwise."""
    return _factorization_method(as_tensor(W, resolve_device(device), result_dtype(W)),
                                 n_rank=n_rank)
