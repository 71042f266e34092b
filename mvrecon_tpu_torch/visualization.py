"""Reference-named ``visualization`` module (counterpart of
``mvrecon_tpu/visualization.py``)."""

from .viz.plotting import (  # noqa: F401
    ThreeDimensionalPlotter,
    TwoDimensionalMatrixPlotter,
    animate,
    show_2d_projection_data,
    show_3d_scene_data,
)
