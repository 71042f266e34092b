#!/usr/bin/env python3
"""Which batch sizes ``torch.linalg.eigh`` takes on the CUDA card.

Builds float32 (B, n, n) symmetric positive definite batches on the card
for n = 4 (the triangulation's Grams) and n = 12 (the dual depth step's
Khatri–Rao Grams) and prints, for each B, whether one batched ``eigh``
call succeeds. ``mvrecon_tpu_torch.ops.linalg.EIGH_BATCH`` is set below
the smallest B refused here.

    python3 scripts/eigh_batch_limit.py
"""

from __future__ import annotations

import sys

import torch

BATCHES = (1000, 4096, 16384, 16385, 24576, 32768)


def main() -> int:
    if not torch.cuda.is_available():
        print("eigh_batch_limit: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for n in (4, 12):
        for b in BATCHES:
            a = torch.randn(b, n, n, device="cuda")
            a = a @ a.transpose(-1, -2) + n * torch.eye(n, device="cuda")
            try:
                v = torch.linalg.eigh(a)[1]
                torch.cuda.synchronize()
                print(f"eigh n={n} batch={b}: ok, finite={bool(torch.isfinite(v).all())}",
                      flush=True)
            except torch.linalg.LinAlgError as e:
                print(f"eigh n={n} batch={b}: refused: {str(e)[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
