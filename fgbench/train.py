"""The training cells: set-up, the first steps that the reference follows,
warm-up, the measured window, the traced window and the comparison.

The program is driven through its own trainer (`Trainer` from the shipped
config as the `train` verb reads it), so the window runs `Trainer.train`:
the chunk runner's CUDA-graph replays with `scan_chunk` > 1, the per-step
loop without, with refinement, the capacity tuner and the eval cadences.
The benchmark writes its seeded state into the trainer in place (a state
past densification, at the state's step: zero first moments, and second
moments from the reference where the traffic gives `moment_frames`), so
that nothing is written to disk but the dataset.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

import checks
import scene
from reference import core, stage1

HERE = Path(__file__).resolve().parent


def scratch_dir() -> Path:
    """A fresh directory for the run's dataset and trainer output: under
    TMPDIR, else in the checkout's `.fgbench_tmp/`."""
    base = Path(os.environ["TMPDIR"]) if os.environ.get("TMPDIR") else HERE.parent / ".fgbench_tmp"
    base.mkdir(parents=True, exist_ok=True)
    return Path(tempfile.mkdtemp(prefix="fgbench_", dir=base))


class Inputs:
    """Everything the run makes from its seed: the true scene, the
    trainer's start, the field weights, the frames and their supervision."""

    def __init__(self, cfg: dict, seed: int, device):
        sc = cfg["scene"]
        self.stage2 = cfg["stage"] == "stage2"
        self.field = "control" if self.stage2 else "deform"  # the trained field's Adam group
        self.n = sc["gaussians"]
        self.truth = scene.gaussians(self.n, seed, device, sc["sh_degree"])
        self.start = scene.perturbed(self.truth, seed)
        self.deform = scene.deform_weights(seed, device)
        if self.stage2:
            self.control = scene.control_weights(seed, device)
            self.cluster = scene.control_mask(self.truth["means"], seed)
        self.frames = scene.frames_of(sc["frames"], sc["width"], sc["height"], sc["focal"], sc["interval"])
        self.depth, self.flow, self.mask = scene.frame_arrays(self.frames, seed, device)
        bg = torch.zeros(3, device=device)
        imgs = [stage1.render(self.truth, self.deform, fr, bg) for fr in self.frames]
        self.images8 = torch.stack([torch.clamp(im * 255, 0, 255).to(torch.uint8) for im in imgs])
        self.i_train, self.i_eval = scene.split(sc["frames"], sc["train_fraction"])
        self.bg_seed = (int(seed) * 7919 + 17) % (1 << 62)
        self.nu = None  # Adam's second moments at the start, by leaf (`second_moments`)


def merged(base: dict, over: dict) -> dict:
    """`over`'s settings on `base`'s, group by group."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def trainer_config(cfg: dict, traffic: dict, data: Path, out: Path, seed: int):
    """The program's TrainerConfig from the configuration's settings, read
    as the `train` verb reads its YAML (JSON is YAML)."""
    from freegaussian_tpu_torch.engine.config import trainer_config_from_yaml

    settings = merged(cfg["settings"], traffic.get("settings", {}))
    settings.update(data=str(data), output_dir=str(out), seed=int(seed) % (1 << 31))
    out.mkdir(parents=True, exist_ok=True)
    path = out / "settings.json"
    path.write_text(json.dumps(settings))
    return trainer_config_from_yaml(path)


def install(trainer, inputs: Inputs, step: int) -> None:
    """The seeded state written into the trainer's own tensors, in place:
    a captured step graph reads them at their addresses."""
    st = trainer.state
    n = inputs.n
    with torch.no_grad():
        for k, v in st.params.items():
            v.zero_()
            v[:n].copy_(inputs.start[k])
        st.alive.zero_()
        st.alive[:n] = True
        st.deform.load_state_dict({k: v.float() for k, v in inputs.deform.items()}, strict=True)
        if inputs.stage2:
            st.control.load_state_dict({k: v.float() for k, v in inputs.control.items()}, strict=True)
        for g, s in st.opt_states.items():
            s.count = step
            for moments in (s.mu, s.nu):
                for v in moments.values():
                    v.zero_()
            for k, v in s.nu.items():
                leaf = k if g == k else f"{g}.{k}"
                if inputs.nu is not None and leaf in inputs.nu:
                    (v[:n] if g == k else v).copy_(inputs.nu[leaf])
        st.densify.reset_()
    st.step = step
    st.generator.manual_seed(inputs.bg_seed)
    # the capacity tuner's state: its capacity (the settings') last set at
    # this step, no readings yet
    trainer._isect_last_rebuild = step
    trainer._isect_low_streak = 0
    trainer._isect_recent = []


def install_mask(trainer, inputs: Inputs) -> None:
    """Stage 2: the cluster mask on the seeded state's live rows, and the
    step rebuilt over it."""
    alive = trainer.state.alive
    mask = torch.zeros((alive.shape[0], inputs.cluster.shape[1]), dtype=torch.bool, device=alive.device)
    mask[: inputs.n] = inputs.cluster
    trainer.gaussian_mask = mask
    trainer._rebuild_step_fn()
    trainer._eval_sweep_cache = None


class Recorder:
    """Each step's frame and loss as the trainer runs them (a wrapper over
    the chunk runner's `run` and the per-step `_dispatch_step`)."""

    def __init__(self, trainer):
        from freegaussian_tpu_torch.engine import trainer as tmod

        self.steps: List[tuple] = []
        self.trainer, self.tmod = trainer, tmod
        self._run = tmod._ChunkRunner.run
        self._dispatch = trainer._dispatch_step
        rec = self

        def run(runner, start, frames):
            out = rec._run(runner, start, frames)
            rec.steps += [(start + j, int(f), float(out["loss"][j])) for j, f in enumerate(frames)]
            return out

        def dispatch(i, idx, camera, batch):
            state, metrics = rec._dispatch(i, idx, camera, batch)
            rec.steps.append((i, int(idx), float(metrics["loss"])))
            return state, metrics

        tmod._ChunkRunner.run = run
        trainer._dispatch_step = dispatch

    def close(self):
        self.tmod._ChunkRunner.run = self._run
        self.trainer._dispatch_step = self._dispatch


class TunerReadings:
    """The intersection counts that the program's capacity tuner reads
    (one a chunk, or one a logged step), kept beside the capacity."""

    def __init__(self, trainer):
        self.readings: List[tuple] = []
        inner = trainer._maybe_grow_isect_capacity

        def read(metrics):
            if "num_isects" in metrics:
                self.readings.append((float(metrics["num_isects"]), trainer.config.splat.isect_capacity))
            inner(metrics)

        trainer._maybe_grow_isect_capacity = read

    def since(self, k: int) -> str:
        got = self.readings[k:]
        if not got:
            return "no readings"
        nums, caps = [n for n, _ in got], sorted({c for _, c in got})
        return f"{len(got)} readings {min(nums):.0f}..{max(nums):.0f} at capacity {caps}"


def field_weights(inputs: Inputs) -> Dict[str, torch.Tensor]:
    return inputs.control if inputs.stage2 else inputs.deform


def start_leaves(inputs: Inputs) -> Dict[str, torch.Tensor]:
    return {**inputs.start, **{f"{inputs.field}.{k}": v for k, v in field_weights(inputs).items()}}


def snapshot_moments(trainer, n: int) -> Dict[str, torch.Tensor]:
    """Each trained leaf's first moment: the live rows of the Gaussian
    groups, the field group's weights."""
    out = {}
    for g, s in trainer.state.opt_states.items():
        for k, v in s.mu.items():
            gaussian = g == k
            out[k if gaussian else f"{g}.{k}"] = (v[:n] if gaussian else v).detach().clone()
    return out


def snapshot_params(trainer, n: int, field: str) -> Dict[str, torch.Tensor]:
    st = trainer.state
    out = {k: v[:n].detach().clone() for k, v in st.params.items()}
    out.update({f"{field}.{k}": v.detach().clone() for k, v in getattr(st, field).state_dict().items()})
    return out


def prepare(cfg: dict, traffic: dict, seed: int, dev, work: Path):
    """The inputs, the dataset on disk and the program's trainer holding
    the seeded state."""
    t0 = time.perf_counter()
    inputs = Inputs(cfg, seed, dev)
    inputs.nu = second_moments(cfg, traffic, inputs, dev)
    if dev.type == "cuda":  # the program's peak, not the set-up reference's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    data = scene.write_dataset(work / "data", inputs.frames, inputs.images8.cpu().numpy(), inputs.depth,
                               inputs.flow, inputs.mask, cfg["scene"]["interval"])
    t2 = time.perf_counter()
    tcfg = trainer_config(cfg, traffic, data, work / "out", seed)
    if inputs.stage2:
        from freegaussian_tpu_torch.engine.control_trainer import ControlTrainer

        # the trainer reads a mask file at build, over its random init's rows;
        # `install` puts the seeded mask on the seeded rows
        np.save(data / f"gaussian_mask_1x{inputs.cluster.shape[1]}.npy", inputs.cluster[:1].cpu().numpy())
        trainer = ControlTrainer(tcfg, device=dev)
    else:
        from freegaussian_tpu_torch.engine.trainer import Trainer

        trainer = Trainer(tcfg, device=dev)
    if inputs.stage2:
        install_mask(trainer, inputs)
    install(trainer, inputs, traffic["start_step"])
    print(f"set-up: inputs {t1 - t0:.2f} s, dataset written {t2 - t1:.2f} s, trainer built "
          f"{time.perf_counter() - t2:.2f} s", flush=True)
    return inputs, trainer


def first_steps(trainer, inputs: Inputs, traffic: dict):
    """The checked steps through the window's own call, each a replay of
    the step's CUDA graph on the card, as every step of the window is: one
    unchecked step from the seeded state captures the graph (a variant's
    first step runs eagerly), the seeded state is written back in place,
    and the checked steps replay the graph from it. Returns (each step's
    (step, frame, loss), the first moments after the first step, the
    parameters after the last)."""
    trainer.train(1)
    install(trainer, inputs, traffic["start_step"])
    before = trainer.graph_stats["replays"]
    rec = Recorder(trainer)
    try:
        trainer.train(1)
        mu1 = snapshot_moments(trainer, inputs.n)
        trainer.train(traffic["check_steps"] - 1)
        p_end = snapshot_params(trainer, inputs.n, inputs.field)
    finally:
        rec.close()
    replayed = trainer.graph_stats["replays"] - before
    if trainer.device.type == "cuda" and trainer.config.scan_chunk > 1 and replayed != traffic["check_steps"]:
        raise RuntimeError(f"{replayed} of the {traffic['check_steps']} checked steps replayed the step's graph")
    return list(rec.steps), mu1, p_end


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, t_process: float,
        device="cuda") -> dict:
    dev = torch.device(device)
    work = scratch_dir()
    try:
        inputs, trainer = prepare(cfg, traffic, seed, dev, work)
        tuner = TunerReadings(trainer)
        t0 = time.perf_counter()
        checked, mu1, p_end = first_steps(trainer, inputs, traffic)
        t1 = time.perf_counter()

        # warm-up: past a refinement, the tuner's readings, both evals
        trainer.train(traffic["warm_steps"])
        t2 = time.perf_counter()
        trainer.eval_all(max_images=trainer.config.eval_all_max_images)
        trainer.eval_one(int(trainer.state.step))
        _sync(dev)
        print(f"set-up: checked steps {t1 - t0:.2f} s, warm-up steps {t2 - t1:.2f} s, evals "
              f"{time.perf_counter() - t2:.2f} s", flush=True)
        print(f"tuner before the window: {tuner.since(0)}", flush=True)
        live_start = int(trainer.state.alive.sum())
        graphs_before = dict(trainer.graph_stats)
        tuned = len(tuner.readings)
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_process

        steps, failed, window_s, trace_data = 0, 0, 0.0, None
        chunk = max(traffic["chunk_steps"], 1)
        if not trace:
            ends = [t_w0]  # each chunk ends with its metrics on the host
            try:
                while True:
                    trainer.train(chunk)
                    steps += chunk
                    ends.append(time.perf_counter())
                    if ends[-1] - t_w0 >= seconds:
                        break
            except FloatingPointError as e:
                failed = chunk
                steps += chunk
                print(f"non-finite step in the window: {e}", flush=True)
            _sync(dev)
            window_s = time.perf_counter() - t_w0
            per_step = np.diff(ends) * 1e3 / chunk
            if per_step.size:
                q = np.percentile(per_step, [10, 50, 90])
                print(f"window: ms a step by chunk, p10 {q[0]:.3f}, p50 {q[1]:.3f}, p90 {q[2]:.3f}, "
                      f"first third {per_step[: per_step.size // 3].mean():.3f}, "
                      f"last third {per_step[-(per_step.size // 3 or 1):].mean():.3f}", flush=True)
        else:
            import tracing

            with tracing.Window(dev) as tw:
                for _ in range(traffic["trace_steps"] // chunk):
                    trainer.train(chunk)
                    steps += chunk
            window_s = tw.window_s
            trace_data = tw.result()
        live_end = int(trainer.state.alive.sum())
        gs = trainer.graph_stats
        print(
            f"window: {steps} steps in {window_s:.3f} s from step {int(trainer.state.step) - steps}; live "
            f"{live_start} -> {live_end}; graph captures in the window {gs['captures'] - graphs_before['captures']}, "
            f"replays {gs['replays'] - graphs_before['replays']}; tuner {tuner.since(tuned)}",
            flush=True,
        )
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the reference, after the window and with the program's state freed
        ref = follow(cfg, traffic, inputs, checked, dev, count_walk=trace)
        verdict = checks.training(ref, mu1, p_end, start_leaves(inputs), traffic["limits"])
        result = {
            "attempted": steps, "failed": failed, "setup_s": setup_s, "window_s": window_s,
            "train_step_ms": window_s * 1e3 / max(steps, 1), "memory_peak_bytes": int(peak),
            "verdict": verdict, "steps": steps,
        }
        if trace:
            result["trace"] = trace_data
            result["counts"] = {
                "live": live_start, "walked_pairs": ref["walked_pairs"], "isects": ref["isects"],
                "width": cfg["scene"]["width"], "height": cfg["scene"]["height"],
                "tile": cfg["settings"]["pipeline"]["model"]["tile_size"],
            }
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference_step(cfg: dict, traffic: dict, inputs: Inputs, *, quant=None, half: bool = False, nu=None):
    """The reference's training step from the seeded start state at the
    traffic's start step."""
    from reference import stage2

    model = cfg["settings"]["pipeline"]["model"]
    rcfg = {
        "ssim_lambda": model.get("ssim_lambda", 0.2), "flow_loss_weight": model.get("flow_loss_weight", 0.0),
        "flow_3d_loss_weight": model.get("flow_3d_loss_weight", 0.0), "flow_px_ref": model.get("flow_px_ref", 0.0),
        "sh_degree": model["sh_degree"],
    }
    opt = dict(cfg["optimizer"], spatial_lr_scale=cfg["settings"]["spatial_lr_scale"])
    groups = stage1.GAUSSIAN_GROUPS + (inputs.field,)
    loss = None
    if inputs.stage2:
        init_time = inputs.frames[int(inputs.i_train[0])]["time"]
        loss = stage2.make_loss(inputs.deform, inputs.cluster, init_time)
    return stage1.Step(inputs.start, field_weights(inputs), {g: traffic["start_step"] for g in groups},
                       stage1.learning_rates(opt), cfg["settings"]["max_num_iterations"], rcfg, quant, half,
                       inputs.field, loss, nu)


def second_moments(cfg: dict, traffic: dict, inputs: Inputs, dev):
    """Adam's second moments of the start state, by leaf: the reference's
    squared gradient at the start state, averaged over `moment_frames`
    training frames spread over the sequence (None without the key).
    Training that reaches this step holds such moments; from zero ones at a
    late count, Adam's bias correction is ~1 and its first hundreds of steps
    move every element by several times its rate, whatever its gradient."""
    k = traffic.get("moment_frames", 0)
    if not k:
        return None
    step = reference_step(cfg, traffic, inputs)
    gen = torch.Generator(device=dev).manual_seed((inputs.bg_seed * 31 + 7) % (1 << 62))
    picks = inputs.i_train[:: max(len(inputs.i_train) // k, 1)][:k]
    nu = {}
    for i in picks:
        frame = inputs.frames[int(i)]
        batch = stage1.batch_of(frame, inputs.images8, inputs.depth, inputs.flow)
        _, grads = step.grads(frame, batch, torch.rand(3, generator=gen, device=dev))
        for name, g in grads.items():
            sq = g.detach().float() ** 2 / len(picks)
            nu[name] = nu[name] + sq if name in nu else sq
    return nu


def follow(cfg: dict, traffic: dict, inputs: Inputs, checked, dev, *, quant=None, count_walk: bool = False,
           tf32: bool = False, half: bool = False) -> dict:
    """The reference's run of the checked steps from the seeded state, on
    the frames the trainer drew: each step's loss, the first step's
    gradients, the parameters after the last."""
    step = reference_step(cfg, traffic, inputs, quant=quant, half=half, nu=inputs.nu)
    gen = torch.Generator(device=dev).manual_seed(inputs.bg_seed)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    losses, grads, walked = [], None, []
    try:
        for _, idx, _ in checked:
            frame = inputs.frames[int(inputs.i_train[idx])]
            bg = torch.rand(3, generator=gen, device=dev)
            batch = stage1.batch_of(frame, inputs.images8, inputs.depth, inputs.flow)
            parts, g = step.run(frame, batch, bg, count_walk=count_walk)
            losses.append(parts["loss"])
            if count_walk:
                walked.append(parts["walked_pairs"])
            if grads is None:
                grads = g
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    out = {"losses": losses, "grads": grads, "params": {k: v.detach() for k, v in step.leaves().items()},
           "prog_losses": [l for _, _, l in checked]}
    if count_walk:
        out["walked_pairs"] = float(np.mean(walked))
        out["isects"] = isect_count(cfg, inputs, checked, dev)
    return out


def isect_count(cfg: dict, inputs: Inputs, checked, dev) -> float:
    """(Gaussian, tile) pairs of the program's binning at its tile size, on
    the first checked frame from the seeded state."""
    frame = inputs.frames[int(inputs.i_train[checked[0][1]])]
    tile = cfg["settings"]["pipeline"]["model"].get("tile_size", 32)
    with torch.no_grad():
        _, vm, K = stage1.camera(frame, dev)
        if inputs.stage2:  # the canonical Gaussians: the control deltas are small and masked
            p = inputs.start
            means, scales = p["means"], torch.exp(p["scales"])
            quats = p["quats"] / core.safe_norm(p["quats"], keepdim=True)
        else:
            means, scales, quats = stage1.deformed(inputs.start, inputs.deform, frame["time"])
        opac = torch.sigmoid(inputs.start["opacities"][:, 0])
        m2d, _, _, radii = core.project(means, quats, scales, vm, K, frame["width"], frame["height"])
        return float(core.count_pairs(m2d, core.tight_radii(radii, opac), frame["width"], frame["height"], tile))

