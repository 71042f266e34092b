"""geometry of the PyTorch port (counterpart of mvrecon_tpu/geometry):
pinhole cameras, projections, synthetic scenes."""

from .camera import (  # noqa: F401
    camera_matrix,
    intrinsics,
    look_at,
    project_points,
    project_points_orthographic,
)
from .scenes import (  # noqa: F401
    curved_tube_points,
    make_synthetic_scene,
    sample_hemisphere_points,
)
