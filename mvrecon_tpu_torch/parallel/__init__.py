"""parallel of the PyTorch port (counterpart of mvrecon_tpu/parallel): the
scene-batched pipelines on one device and their scene sharding
(``shard_scenes``), the meshes of ranks, point-sharded bundle adjustment
(the dense, chunked and sparse cores over the ``points`` axis), the
point-sharded covariance, perspective and affine calibrations, and the
point-sharded perspective and affine pipelines, and the 2D (points x
cameras) BA, ``sharded_ba_2d``, which is imported from its module (the
JAX package does not re-export it either)."""

from .mesh import hybrid_scene_point_mesh, make_mesh, scene_point_mesh  # noqa: F401
from .batched import batched_affine_reconstruction, batched_euclidean_reconstruction  # noqa: F401
from .sharded_ba import (  # noqa: F401
    sharded_bundle_adjust,
    sharded_bundle_adjust_chunked,
    sharded_lm_step,
)
from .sharded_affine import sharded_affine_self_calibration  # noqa: F401
from .sharded_covariance import sharded_ba_covariance  # noqa: F401
from .pipelines import (  # noqa: F401
    sharded_affine_reconstruction,
    sharded_euclidean_reconstruction,
)
