"""h2d_gbps.streamed: the streamed feed's host-to-device rate, in GB/s:
the bytes of the window's chunk copies over their "h2d" spans (CUDA
events on the copy stream). A copy moves one padded chunk of
observations, (chunk, F, 2), and its visibility, (chunk, 1) without a
mask, in the working dtype."""

import numpy as np


def read(run):
    spans = run.spans.get("h2d")
    if not spans:
        return None
    cell = run.cell
    per_copy = (cell.kw["chunk_size"] * (cell.n_cams * 2 + 1)
                * np.dtype(cell.x_host.dtype).itemsize)
    return len(spans) * per_copy / 1e9 / (sum(spans) / 1e3)
