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

Ported so far: every entry point of ``models/pipelines.py`` on one
device (the affine pipeline, the dense perspective pipeline and the large
one with the fused chunked BA core and its accumulating SYRK kernel),
scene batching (``parallel/batched.py``), and the host-streamed BA with
the packed SYRK kernel.
"""

__version__ = "0.1.0"
