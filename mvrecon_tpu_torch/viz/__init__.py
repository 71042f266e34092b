"""Host-side visualization (matplotlib, imported only when a plot is drawn);
counterpart of ``mvrecon_tpu/viz``."""

from .plotting import (  # noqa: F401
    ThreeDimensionalPlotter,
    TwoDimensionalMatrixPlotter,
    animate,
    draw_camera,
    draw_points2d,
    draw_points3d,
    draw_scene,
    new_axes3d,
    plot_overlay,
    plot_scene,
    set_world_limits,
    show_2d_projection_data,
    show_3d_scene_data,
)
