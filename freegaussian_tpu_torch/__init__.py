"""PyTorch + CUDA port of FreeGaussian, beside the JAX package `freegaussian_tpu`.

This package imports torch, numpy, PyYAML (for the configs) and the
standard library only; it never imports JAX or anything of `freegaussian_tpu` (its tests hold the two side
by side). The first slice is the stage-1 serving path: a reference-format
checkpoint -> `forward(train=False)` -> the HTTP viewer, with the tile
compositor as a hand-written CUDA kernel (`csrc/rasterize_fwd.cu`). The
second is the stage-1 training step (`engine/train_step.py`), whose
backward runs the compositor's backward as a hand-written CUDA kernel
(`csrc/rasterize_bwd.cu`). The third is the stage-2 control path: the
slider viewer over a `ControlModel` (`models/control_model.py`) and the
control training step (`engine/control_train_step.py`), whose deform and
control trunks run on the field-trunk kernels of `csrc/deform_field.cu`.
The fourth is the `train` and `train-control` CLI verbs
(`engine/trainer.py`, `engine/control_trainer.py`) with their config
overlay, dataparsers, datamanager and checkpoints; with it come the
compositor's forward-walk backward (`rasterize_cuda.BWD_WALK = "fwd"`) and
the trunk on a precomputed embedding (the deform field with per-point
times) as kernels. The fifth is the `cluster`, `eval`, `render` and `export`
verbs (`preprocess/clustering.py`, `models/metrics.py`,
`preprocess/render_offline.py`, `data/splat_export.py`), which complete the
two-stage pipeline.

Entry points default to ``device="cuda"`` and raise when no GPU is present;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
