"""Convergence logs as host records.

Counterpart of ``mvrecon_tpu/runtime/logging.py``. The BA cores record
their log stacked on the device, one row per LM iteration
(``LMConfig.record_log``): the dense core's ``points``, ``basis``, ``pos``
and ``reprojection_error`` (``models/bundle_adjustment.py``), the chunked
core's ``reprojection_error`` alone. These functions copy a log to the
host once and turn it into per-iteration records of numpy arrays and
Python floats, which ``json`` and ``viz.animate`` take.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from ..config import as_numpy


def device_log_to_records(log: dict, n_iter: int) -> list[dict[str, Any]]:
    """The dense core's stacked log -> one dict per executed iteration
    (n_iter + 1 of them, the start included), with the keys of the
    reference's ``BundleAdjuster.get_log``."""
    n = int(n_iter) + 1
    cols = {k: as_numpy(log[k])[:n] for k in ("points", "basis", "pos", "reprojection_error")}
    return [
        {
            "points": cols["points"][i],
            "basis": cols["basis"][i],
            "pos": cols["pos"][i],
            "reprojection_error": float(cols["reprojection_error"][i]),
        }
        for i in range(n)
    ]


def scalar_log_to_records(log: dict, n_iter: int) -> list[dict[str, Any]]:
    """The chunked core's log -> per-iteration records holding only
    ``reprojection_error``: that core keeps no state trajectory, whose
    (max_iter, P, 3) rows would not fit at its scale."""
    errs = convergence_curve(log, n_iter)
    return [{"reprojection_error": float(e)} for e in errs]


def convergence_curve(log: dict, n_iter: int) -> np.ndarray:
    """(n_iter + 1,) reprojection-error trajectory."""
    return as_numpy(log["reprojection_error"])[: int(n_iter) + 1]


def format_convergence(log: dict, n_iter: int) -> str:
    """One line per iteration with |E_i - E_{i-1}|, the reference's
    printout reproduced after the run."""
    errs = convergence_curve(log, n_iter)
    return "\n".join(
        f"Iteration {i}: reprojection_error_delta = {abs(errs[i] - errs[i - 1]):.3e}"
        for i in range(1, len(errs))
    )


def dump_jsonl(path: str, records: list[dict[str, Any]]) -> None:
    """Append records as JSON lines: the iteration, its E and the number
    of points (the arrays themselves are left out)."""
    with open(path, "a") as f:
        for i, rec in enumerate(records):
            f.write(json.dumps({
                "iter": i,
                "reprojection_error": rec["reprojection_error"],
                "n_points": int(np.asarray(rec["points"]).shape[0]),
            }) + "\n")
