"""Stage-2 trainer (twin of `freegaussian_tpu/engine/control_trainer.py`): the
`train-control` verb. It starts from a stage-1 checkpoint, loads the cluster
mask `gaussian_mask_NxM.npy`, takes the first train camera's time as the
init time (freegaussian_pipeline.py:41-50), and trains the control field and
the Gaussian groups (no deform group, no densification) under the stage-1
trainer's cadence loop, its `scan_chunk` chunks (the stage-2 step as the
chunk runner's step, one graph per phase: stage 2 has no step variants)
and its capacity tuner.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..models.control_model import control_forward
from ..models.splat_model import sh_degree_to_use
from ..preprocess.clustering import load_gaussian_mask
from .checkpoints import cross_load_stage1
from .control_train_step import make_control_train_step
from .train_step import create_train_state
from .trainer import Trainer, TrainerConfig, downscale_phase


class ControlTrainer(Trainer):
    def __init__(
        self,
        config: TrainerConfig,
        *,
        load_deformable_checkpoint: Optional[Path] = None,
        gaussian_mask_path: Optional[Path] = None,
        device="cuda",
    ):
        super().__init__(config, device=device)
        st = self.state
        # stage 2 trains the Gaussian groups and the control field; the deform
        # field only sets the control state
        self.state = create_train_state(
            st.params, st.alive, st.deform.requires_grad_(False), self.optimizers,
            generator=self.generator, control=self.control.requires_grad_(True),
        )
        if load_deformable_checkpoint:
            cross_load_stage1(Path(load_deformable_checkpoint), self.state)

        mask_path = gaussian_mask_path
        if mask_path is None and config.data:
            candidates = sorted(Path(config.data).glob("gaussian_mask_*.npy"))
            if candidates:
                mask_path = candidates[0]
        if mask_path is None:
            raise FileNotFoundError(
                "stage 2 needs a gaussian_mask_NxM.npy (run the clustering preprocess first; "
                "ref: freegaussian_pipeline.py:45-47)"
            )
        self.gaussian_mask = load_gaussian_mask(Path(mask_path), config.capacity, self.state.alive)
        # init camera := first train camera (freegaussian_pipeline.py:41-42)
        self.init_time = float(self.datamanager.frames[0].camera.time)
        self._rebuild_step_fn()

    def _rebuild_step_fn(self) -> None:
        if not hasattr(self, "gaussian_mask"):
            # called from Trainer.__init__, before the stage-2 state exists
            super()._rebuild_step_fn()
            return
        self.control_step_fn = make_control_train_step(self.config.splat, self.optimizers, self.gaussian_mask, self.init_time)
        self._runners = {}

    def _step_variant(self, step: int) -> tuple:
        return ()

    def _step_core(self, camera, camera0, batch, sh_deg: int, frame, variant: tuple, scalars):
        del camera0, frame, variant  # stage 2 has no flow supervision and no per-camera state
        return self.control_step_fn.core(self.state, camera, batch, sh_deg, {}, scalars)

    def _metric_groups(self):
        return self.control_step_fn.groups(self.state)

    def _refine_at(self, step: int, last_size):
        return None  # stage 2 has no densification

    def _dispatch_step(self, i, idx, camera, batch):
        """One stage-2 step under the shared cadence loop."""
        cfg = self.config
        camera, batch = self._downscale_batch(camera, batch, downscale_phase(cfg.splat, i))
        return self.control_step_fn(self.state, camera, batch, sh_degree_to_use(cfg.splat, i))

    @torch.no_grad()
    def _render_rgb(self, camera) -> torch.Tensor:
        """Stage-2 single-image render (the train-mode control state: the
        deform field's displacement between the init time and the frame's),
        so the inherited eval cadences render through the control model (the
        JAX package's `_control_eval_render`)."""
        st = self.state
        return control_forward(
            self.config.splat, st.params, st.alive, self.gaussian_mask, camera, st.control,
            deform=st.deform, init_time=self.init_time, sh_degree_now=self.config.splat.sh_degree, train=False,
        )["rgb"]

    def viewer_num_attributes(self) -> int:
        # the mask is (N, M): attribute channels only (knn_gaussian.py:128)
        m = int(self.gaussian_mask.shape[1])
        if m == 0:
            raise ValueError(
                "gaussian_mask has no attribute columns: re-run clustering (an (N, 0) mask usually means every "
                "key frame was skipped)"
            )
        return m

    def viewer_render_fn(self):
        """Stage-2 viewer: the attribute sliders drive the control field."""
        num_attributes = self.viewer_num_attributes()

        def render_fn(camera, atrb_values=None):
            if atrb_values is None:
                atrb_values = np.zeros((num_attributes, 3), np.float32)
            return self.render_with_control(camera, np.asarray(atrb_values, np.float32).reshape(-1, 3))["rgb"]

        return render_fn

    @torch.no_grad()
    def render_with_control(self, camera, atrb_values) -> Dict[str, torch.Tensor]:
        """Inference with injected attribute 3-vectors (M, 3): the slider path."""
        st = self.state
        return control_forward(
            self.config.splat, st.params, st.alive, self.gaussian_mask, camera, st.control,
            atrb_values=torch.as_tensor(np.asarray(atrb_values, np.float32), device=self.device),
            sh_degree_now=self.config.splat.sh_degree, train=False,
        )
