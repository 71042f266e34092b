"""parallel of the PyTorch port (counterpart of mvrecon_tpu/parallel): the
scene-batched pipelines on one device, the meshes of ranks, point-sharded
bundle adjustment (the dense and the chunked core over the ``points``
axis), the point-sharded covariance and perspective calibration, and the
point-sharded perspective pipeline. The sharded affine, 2D and sparse
paths are not ported yet."""

from .mesh import hybrid_scene_point_mesh, make_mesh, scene_point_mesh  # noqa: F401
from .batched import batched_affine_reconstruction, batched_euclidean_reconstruction  # noqa: F401
from .sharded_ba import (  # noqa: F401
    sharded_bundle_adjust,
    sharded_bundle_adjust_chunked,
    sharded_lm_step,
)
from .sharded_covariance import sharded_ba_covariance  # noqa: F401
from .pipelines import sharded_euclidean_reconstruction  # noqa: F401
