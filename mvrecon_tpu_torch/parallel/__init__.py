"""parallel of the PyTorch port (counterpart of mvrecon_tpu/parallel): the
scene-batched pipelines on one device. The device meshes and the sharded
cores are not ported yet."""

from .batched import batched_affine_reconstruction, batched_euclidean_reconstruction  # noqa: F401
