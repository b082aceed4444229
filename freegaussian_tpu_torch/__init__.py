"""PyTorch + CUDA port of FreeGaussian, beside the JAX package `freegaussian_tpu`.

This package imports torch, numpy and the standard library only; it never
imports JAX or anything of `freegaussian_tpu` (its tests hold the two side
by side). The first slice is the stage-1 serving path: a reference-format
checkpoint -> `forward(train=False)` -> the HTTP viewer, with the tile
compositor as a hand-written CUDA kernel (`csrc/rasterize_fwd.cu`). The
second is the stage-1 training step (`engine/train_step.py`), whose
backward runs the compositor's backward as a hand-written CUDA kernel
(`csrc/rasterize_bwd.cu`).

Entry points default to ``device="cuda"`` and raise when no GPU is present;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
