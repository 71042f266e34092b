"""models of the PyTorch port (counterpart of mvrecon_tpu/models): affine
and perspective self-calibration, the BA cores, the covariance and the
end-to-end pipelines."""

from .affine import (  # noqa: F401
    affine_self_calibration,
    observation_matrix,
    orthographic_self_calibration,
    paraperspective_self_calibration,
    symmetric_affine_self_calibration,
)
from .covariance import (  # noqa: F401
    BACovariance,
    ba_covariance,
    ba_covariance_chunked,
    ba_covariance_streamed,
)
