"""Numerics, device and hyperparameter configuration of the PyTorch port.

Counterpart of ``mvrecon_tpu/config.py``. The working dtype comes from the
inputs: float64 arrays give the reference's float64 semantics (the CPU
parity tests), float32 arrays run the fast path on the card.

Precision policy: where the JAX package pins ``Precision.HIGHEST`` the port
runs full fp32. A float32 matrix product on the card must not drop to TF32,
so :func:`resolve_device` turns both TF32 switches off on the CUDA path
(``chip_smoke.py`` asserts that they are off).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. With no CUDA device this raises instead of
    falling back: the CPU runs only when the caller asks for it
    (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def result_dtype(*arrays) -> torch.dtype:
    """Floating dtype of the inputs; float32 when none is floating."""
    dt = None
    for a in arrays:
        if a is not None:
            d = a.dtype if torch.is_tensor(a) else _numpy_dtype(np.asarray(a).dtype)
            dt = d if dt is None else torch.promote_types(dt, d)
    return dt if dt is not None and dt.is_floating_point else torch.float32


def _numpy_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


def as_numpy(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def as_tensor(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """numpy array, scalar or tensor -> tensor on ``device`` in ``dtype``."""
    if not torch.is_tensor(a):
        a = np.asarray(a)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    return a.to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Levenberg–Marquardt hyperparameters (fields and defaults of the JAX
    package's ``LMConfig``; see there for what each one does). Every BA
    core of the port takes the robust losses (``robust``: None, "huber",
    "cauchy", "soft_l1" or "arctan", at scale ``huber_delta``) and the six
    distortion models (``distortion_model`` "auto", "radial", "opencv",
    "fisheye", "full_opencv", "fov" or "thin_prism", with
    ``distortion_rounds`` of refit, ``distortion_shared`` to tie them
    across cameras)."""

    scale_factor: float = 10.0
    delta_tol: float = 1e-8
    max_iter: int = 100
    init_damping: float = 1e-4
    max_inner_retries: int = 64
    record_log: bool = False
    accept_divisor: float | None = None
    damping: str = "reference"
    robust: str | None = None
    huber_delta: float = 0.05
    distortion_rounds: int = 0
    distortion_shared: bool = False
    distortion_model: str = "auto"
    jacobi_scaling: bool = False

    @property
    def divisor(self) -> float:
        return self.scale_factor if self.accept_divisor is None else self.accept_divisor


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    """Projective-depth iteration hyperparameters."""

    tolerance: float = 0.01
    max_iter: int = 200


@dataclasses.dataclass(frozen=True)
class UpgradeConfig:
    """Euclidean upgrading loop: stops on median cost < ``j_tol`` or when
    the median stops decreasing."""

    j_tol: float = 1e-8
    max_iter: int = 100
