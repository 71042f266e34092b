"""ops of the PyTorch port (counterpart of mvrecon_tpu/ops): rotations,
small-matrix linear algebra, fourth-moment forms, the SVD factorization,
triangulation, Procrustes alignment, and the hand-written kernels' wrappers
(``syrk``, ``fused_schur``; imported by name, not re-exported here)."""

from .rotations import rodrigues, rodrigues_batched, unit_vec  # noqa: F401
from .factorization import factorization_method  # noqa: F401
from .linalg import (  # noqa: F401
    inv3x3,
    max_eigvec_sym,
    min_eigvec_sym,
    orthonormalize,
    solve3x3,
)
from .moments import fourth_moment_matrix  # noqa: F401
from .moments import sym_expand as sym_unpack  # noqa: F401
from .moments import sym_reduce as sym_pack  # noqa: F401
from .triangulation import triangulate, triangulate_sparse  # noqa: F401
from .procrustes import aligned_rmse, apply_similarity, umeyama  # noqa: F401
