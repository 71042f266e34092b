"""mvrecon_tpu_torch — the PyTorch/CUDA port of mvrecon_tpu.

The JAX package ``mvrecon_tpu`` is the reference; this package computes
the same functions with PyTorch, and every kernel that the JAX package
wrote in Pallas for the TPU becomes a kernel hand-written for an NVIDIA
Hopper card (``csrc/``, built at first use into ``build/kernels/``).
Module layout and function names follow ``mvrecon_tpu`` so each
counterpart is easy to find; array layouts at the public functions are
the JAX package's.

Entry points run on the card unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
Importing the package builds no kernel and touches no CUDA device.

Ported so far, on one device:

- every entry point of ``models/pipelines.py`` (the affine pipeline, the
  dense perspective pipeline, the large one with the camera bootstrap) and
  scene batching (``parallel/batched.py``);
- the four BA cores: dense (one problem or lanes), chunked (the fused
  build on the accumulating SYRK kernel, the non-fused one on the packed
  SYRK kernel), host-streamed (packed SYRK) and the sparse observation
  list, each with the robust losses and the six distortion families,
  fixed or refit; ``models/covariance.py``; triangulation, point
  (un)distortion;
- ``runtime/``: I/O (npz, BAL, COLMAP, PLY), npz checkpoints and the
  resumable drivers, convergence logging, trace capture and timers, and
  the native (C++) MST;
- the command line (``cli.py``: ``euclidean``, ``euclidean-large``,
  ``affine``, ``batch``, ``reconstruct``, ``bal``, ``bench-ba``);
- the reference-named API: ``bundle_adjustment.BundleAdjuster``,
  ``camera``, ``factorization``, ``affine_camera_calibration``,
  ``perspective_camera_calibration``, ``utils``, ``minimum_spanning_tree``
  and ``visualization`` (matplotlib, imported only to draw).

Over several ranks (``runtime/distributed.py``: one process per device,
NCCL between cards, gloo on the CPU): the meshes (``parallel/mesh.py``),
point-sharded BA through the dense and the chunked core
(``parallel/sharded_ba.py``), the point-sharded covariance, perspective
calibration and perspective pipeline (``parallel/sharded_covariance.py``,
``sharded_calibration.py``, ``pipelines.py``; the large pipeline's
``mesh``), and ``--shard-points`` of ``euclidean``, ``reconstruct`` and
``bal``. Not ported yet: the sharded affine, 2D and sparse paths.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
