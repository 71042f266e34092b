"""parallel of the PyTorch port (counterpart of mvrecon_tpu/parallel): the
scene-batched pipelines on one device, the meshes of ranks, and point-
sharded bundle adjustment (the dense and the chunked core over the
``points`` axis). The sharded covariance, calibration, affine, 2D and
sparse paths and the sharded pipelines are not ported yet."""

from .mesh import hybrid_scene_point_mesh, make_mesh, scene_point_mesh  # noqa: F401
from .batched import batched_affine_reconstruction, batched_euclidean_reconstruction  # noqa: F401
from .sharded_ba import (  # noqa: F401
    sharded_bundle_adjust,
    sharded_bundle_adjust_chunked,
    sharded_lm_step,
)
