"""Reference-named ``bundle_adjustment`` module (counterpart of
``mvrecon_tpu/bundle_adjustment.py``): the ``BundleAdjuster`` class, with
``optimize(scale_factor, delta_tol, max_iter, is_debug)`` and
``get_log()``, over the port's BA cores.
"""

from __future__ import annotations

from .config import LMConfig, as_tensor, resolve_device, result_dtype
from .models.bundle_adjustment import bundle_adjust
from .models.bundle_adjustment_chunked import bundle_adjust_chunked
from .runtime.logging import device_log_to_records, scalar_log_to_records


class BundleAdjuster:
    """The reference's bundle adjuster: x (P, F, 2), a start (X, K, R, t),
    an optional (P, F) visibility mask and the gauge ``axis``. Inputs are
    numpy arrays or tensors, moved to the card unless ``device`` says
    otherwise; the working dtype is x's."""

    # Above this many bytes of the (P, F, 27) coupling blocks the dense
    # core does not fit, and ``optimize`` runs the chunked core (class
    # attribute, so that a test can lower it).
    CHUNKED_THRESHOLD_BYTES = 1_500_000_000

    def __init__(self, x, init_X, init_K, init_R, init_t, f0: float = 1.0,
                 visibility_index=None, axis: str = "x-right_z-forward", device=None):
        dev = resolve_device(device)
        dt = result_dtype(x)
        self._x = as_tensor(x, dev, dt)
        self._init = tuple(as_tensor(a, dev, dt) for a in (init_X, init_K, init_R, init_t))
        self._f0 = float(f0)
        self._axis = axis
        self._vis = None if visibility_index is None else as_tensor(visibility_index, dev, dt)
        self._log: list[dict] = []

    def optimize(self, scale_factor: float = 10.0, delta_tol: float = 1e-8,
                 max_iter: int = 100, is_debug: bool = False):
        """Run LM and return (X, K, R, t) in the input's frame. With
        ``is_debug`` the per-iteration log is kept for ``get_log``."""
        config = LMConfig(scale_factor=float(scale_factor), delta_tol=float(delta_tol),
                          max_iter=int(max_iter), record_log=bool(is_debug))
        npts, nf = self._x.shape[0], self._init[2].shape[0]
        use_chunked = npts * nf * 27 * self._x.element_size() > self.CHUNKED_THRESHOLD_BYTES
        ba = bundle_adjust_chunked if use_chunked else bundle_adjust
        res = ba(self._x, *self._init, f0=self._f0, visibility=self._vis, axis=self._axis,
                 config=config, device=self._x.device)
        if is_debug:
            to_records = scalar_log_to_records if use_chunked else device_log_to_records
            self._log = to_records(res.log, res.n_iter)
        self.result = res
        return res.X, res.K, res.R, res.t

    def get_log(self) -> list[dict]:
        """The records of the last ``optimize(is_debug=True)``: points,
        basis, pos (in the normalized gauge frame, as the reference logs
        them) and reprojection_error per iteration; above the chunked
        threshold only reprojection_error, since the chunked core keeps
        no state trajectory."""
        return self._log
