"""Scene plots and the BA convergence animation (matplotlib, on the host).

Counterpart of ``mvrecon_tpu/viz/plotting.py``: small ``draw_*``
primitives over axes the caller owns, figure-level helpers
(``plot_scene``, ``plot_overlay``, ``animate``, ``show_*``) and the
reference's stateful ``ThreeDimensionalPlotter`` and
``TwoDimensionalMatrixPlotter`` over them. The reference's conventions
hold: world X is drawn up (display axes Y, Z, X), camera bases are the
columns of R in red, green and blue, observed points are blue over
translucent red reprojections, and image plots are x-up / y-right.

Inputs may be tensors (on any device) or numpy arrays; each is copied to
the host first. matplotlib is imported inside the functions that draw, so
this module imports without it.
"""

from __future__ import annotations

import numpy as np

from ..config import as_numpy

# World (x, y, z) components are drawn on display axes (y, z, x) so that
# world X points up in the rendered figure.
_DISPLAY = (1, 2, 0)
_DISPLAY_LABELS = ("Y", "Z", "X")
_BASIS_COLORS = ("red", "green", "blue")


def _display_coords(a):
    """Split an (..., 3) world array into its three display-axis components."""
    a = as_numpy(a)
    return tuple(a[..., k] for k in _DISPLAY)


# ---------------------------------------------------------------------------
# Functional drawing primitives
# ---------------------------------------------------------------------------


def new_axes3d(figsize=None, title=None):
    """Create a 3D figure/axes pair in the X-up display convention."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(projection="3d")
    if title is not None:
        ax.set_title(title)
    for setter, lab in zip((ax.set_xlabel, ax.set_ylabel, ax.set_zlabel), _DISPLAY_LABELS):
        setter(lab)
    ax.set_box_aspect((1.0, 1.0, 1.0))
    return fig, ax


def set_world_limits(ax, xlim=(-5.0, 5.0), ylim=(-5.0, 5.0), zlim=(-5.0, 5.0)):
    """Set axis limits given in *world* coordinates (remapped to display)."""
    world = (xlim, ylim, zlim)
    ax.set_xlim3d(world[_DISPLAY[0]])
    ax.set_ylim3d(world[_DISPLAY[1]])
    ax.set_zlim3d(world[_DISPLAY[2]])


def draw_points3d(ax, X, color=None):
    """Scatter an (N, 3) world point cloud."""
    u, v, w = _display_coords(X)
    ax.scatter(u, v, w, c=color if color is not None else "black", marker=".")


def draw_camera(ax, R, t, label=None):
    """Draw one camera: its basis (columns of R) as r/g/b arrows at t."""
    origin = [c.item() for c in _display_coords(as_numpy(t))]
    for axis_col, color in zip(as_numpy(R).T, _BASIS_COLORS):
        du, dv, dw = (axis_col[k] for k in _DISPLAY)
        ax.quiver(*origin, du, dv, dw, color=color)
    if label is not None:
        ax.text(*origin, str(label))


def draw_scene(ax, X=None, R=None, t=None, color=None, labels=None):
    """Draw points and/or a stack of cameras onto existing 3D axes."""
    if X is not None:
        draw_points3d(ax, X, color=color)
    if R is not None and t is not None:
        R, t = as_numpy(R), as_numpy(t)
        for i in range(len(R)):
            name = labels[i] if labels is not None else i
            draw_camera(ax, R[i], t[i], label=name)


def draw_points2d(ax, x, color="black", label=None, alpha=1.0):
    """Scatter (N, 2) image points in the x-up / y-right image convention."""
    x = as_numpy(x)
    ax.scatter(x[:, 1], x[:, 0], c=color, marker=".", label=label, alpha=alpha)


# ---------------------------------------------------------------------------
# Figure-level helpers (the API the examples / CLI use)
# ---------------------------------------------------------------------------


def plot_scene(X, R=None, t=None, color=None, labels=None, figsize=(10, 10), show=True):
    """Render a 3D scene (points + cameras); optionally show it."""
    import matplotlib.pyplot as plt

    fig, ax = new_axes3d(figsize=figsize)
    set_world_limits(ax)
    draw_scene(ax, X=X, R=R, t=t, color=color, labels=labels)
    if show:
        plt.show()
        plt.close(fig)
    return fig, ax


def plot_overlay(
    observed,
    reprojected=None,
    n_col=6,
    xlim=(-1.0, 1.0),
    ylim=(-1.0, 1.0),
    labels=None,
    show=True,
):
    """Per-camera grid of observed (blue) vs reprojected (red, alpha 0.3).

    ``observed``/``reprojected`` are sequences of (N, 2) image-point arrays,
    one per camera.
    """
    import matplotlib.pyplot as plt

    n_images = len(observed)
    n_row = -(-n_images // n_col)
    fig, axes = plt.subplots(n_row, n_col, figsize=(3.2 * n_col, 3.4 * n_row))
    axes = np.atleast_1d(axes).ravel()
    for idx, ax in enumerate(axes):
        if idx >= n_images:
            ax.set_axis_off()
            continue
        name = labels[idx] if labels is not None else idx
        ax.set_title(f"Camera {name}")
        ax.set_aspect("equal")
        # image x is up, image y is right
        ax.set_xlim(ylim)
        ax.set_ylim(xlim)
        ax.grid(True)
        draw_points2d(ax, observed[idx], color="blue", label="Projection")
        if reprojected is not None:
            draw_points2d(ax, reprojected[idx], color="red", label="Reprojection", alpha=0.3)
        ax.legend()
    if show:
        plt.show()
        plt.close(fig)
    return fig, axes


def animate(log, frame_seconds=0.05):
    """Replay a BA iteration log as a looping animation.

    ``log`` is a sequence of dicts with keys ``points`` (P, 3), ``basis``
    (F, 3, 3) and ``pos`` (F, 3) — the structure produced by
    ``BundleAdjuster.get_log`` (reference ``bundle_adjustment.py:204-206``).
    Loops until the window is closed.
    """
    import matplotlib.pyplot as plt

    fig, ax = new_axes3d()
    while plt.fignum_exists(fig.number):
        for frame in log:
            set_world_limits(ax)
            draw_scene(ax, X=frame["points"], R=frame["basis"], t=frame["pos"])
            plt.pause(frame_seconds)
            ax.cla()


def show_3d_scene_data(X, R, t, color=None, camera_id_list=None):
    """Points + camera poses (capability of reference ``visualization.py:105-121``)."""
    plot_scene(X, R, t, color=color, labels=camera_id_list)


def show_2d_projection_data(
    x_list, reproj_x_list=None, n_col=6, xlim=(-0.5, 0.5), ylim=(-0.5, 0.5), camera_id_list=None
):
    """Observed-vs-reprojected overlays (reference ``visualization.py:124-160``)."""
    plot_overlay(
        x_list,
        reprojected=reproj_x_list,
        n_col=n_col,
        xlim=xlim,
        ylim=ylim,
        labels=camera_id_list,
    )


# ---------------------------------------------------------------------------
# Reference-API compatibility shims (stateful wrappers over the layer above)
# ---------------------------------------------------------------------------


class ThreeDimensionalPlotter:
    """Stateful shim over ``new_axes3d``/``draw_*`` for reference-API users."""

    def __init__(self, figsize=None, title=None):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig, self.ax = new_axes3d(figsize=figsize, title=title)

    def set_lim(self, xlim=(-5.0, 5.0), ylim=(-5.0, 5.0), zlim=(-5.0, 5.0)):
        set_world_limits(self.ax, xlim, ylim, zlim)

    def plot_basis(self, basis, pos, label=None):
        draw_camera(self.ax, basis, pos, label=label)

    def plot_points(self, X, color="black"):
        draw_points3d(self.ax, X, color=color)

    def show(self):
        self.plt.show()

    def close(self):
        self.plt.close(self.fig)

    def pause(self, s=0.1):
        self.plt.pause(s)


class TwoDimensionalMatrixPlotter:
    """Stateful shim for grid-of-image-scatter plots (reference-API users)."""

    def __init__(self, n_row, n_col, figsize=None, is_grid=True):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig = plt.figure(figsize=figsize)
        self.n_row, self.n_col = n_row, n_col
        self.is_grid = is_grid
        self.current_ax = None

    def select(self, plot_id):
        self.current_ax = self.fig.add_subplot(self.n_row, self.n_col, plot_id + 1)

    def set_property(self, title, xlim=(-1.0, 1.0), ylim=(-1.0, 1.0)):
        ax = self.current_ax
        ax.set_title(title)
        ax.set_aspect("equal")
        ax.set_xlim(ylim)  # image x-up / y-right convention
        ax.set_ylim(xlim)
        if self.is_grid:
            ax.grid(True)

    def plot_points(self, x, color="black", label=None, alpha=1.0):
        draw_points2d(self.current_ax, x, color=color, label=label, alpha=alpha)
        if label is not None:
            self.current_ax.legend()

    def show(self):
        self.plt.show()

    def close(self):
        self.plt.close(self.fig)
