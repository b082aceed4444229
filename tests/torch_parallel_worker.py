"""One rank of the port's multi-GPU step over gloo on the CPU, for
tests/test_torch_parallel.py (spawned as `python torch_parallel_worker.py
<case dir> <rank> <world size> <port>`).

The case directory holds `case.pt` (the case's settings, cameras, images,
flows and per-step random draws) and `ckpt/` (the starting state as a port
checkpoint). Each rank joins the group, builds the (data, tile) mesh, loads
and replicates the state, takes the steps, and writes `rank<r>.pt`: the
parameters, alive mask, densification statistics and Adam moments after
the last step (sharded moments gathered), and every step's metrics. The
test reads those files; it imports no JAX here. A case of kind
"collectives" checks the gather and halo collectives alone; one of kind
"guard" takes one step with the deform field on its fused kernel path
(the plain versions here) and records, for each call of the field, the
`live` mask it got and the cotangent of its output (tests/test_torch_field_live.py).
"""

import sys
from pathlib import Path

import torch
import torch.distributed as dist

from freegaussian_tpu_torch.data.cameras import Camera
from freegaussian_tpu_torch.engine.checkpoints import load_checkpoint
from freegaussian_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizers
from freegaussian_tpu_torch.engine.train_step import GAUSSIAN_GROUPS, create_train_state
from freegaussian_tpu_torch.models.densify import DensifyConfig
from freegaussian_tpu_torch.models.splat_model import SplatConfig, make_deform_field
from freegaussian_tpu_torch.parallel.distributed import ensure_distributed, host_shard_info, local_device_count
from freegaussian_tpu_torch.parallel.sharding import make_mesh, make_parallel_train_step, replicate_state, stack_cameras


def _cameras(arrs):
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return stack_cameras([
        Camera(c2w=t(a["c2w"]), fx=t(a["fx"]), fy=t(a["fy"]), cx=t(a["cx"]), cy=t(a["cy"]), time=t(a["time"]),
               width=a["width"], height=a["height"]) for a in arrs
    ])


def _gathered(x, capacity, world):
    """A zero1 moment shard -> the full moment (replicated ones as they are)."""
    if x.shape[0] == capacity:
        return x
    out = x.new_empty((x.shape[0] * world,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous())
    return out


def collectives(case_dir, rank, world):
    """`all_gather_rows` and the halo exchange, forward and backward, on
    seeded inputs every rank draws alike."""
    import numpy as np

    from freegaussian_tpu_torch.parallel.distributed import all_gather_rows
    from freegaussian_tpu_torch.parallel.sharding import _all_reduce, _halo_rows

    mesh = make_mesh(1, world)
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(world)]
    ws = [rng.normal(size=(6 * world, 3)).astype(np.float32) for _ in range(world)]
    bands = [rng.normal(size=(8, 2, 3)).astype(np.float32) for _ in range(world)]
    vs = [rng.normal(size=(18, 2, 3)).astype(np.float32) for _ in range(world)]
    x = torch.tensor(xs[rank], requires_grad=True)
    gathered = all_gather_rows(x, mesh.tile_group)
    torch.sum(gathered * torch.tensor(ws[rank])).backward()
    band = torch.tensor(bands[rank], requires_grad=True)
    halo = _halo_rows(band, 5, mesh)
    torch.sum(halo * torch.tensor(vs[rank])).backward()
    strided = torch.arange(12.0).reshape(3, 4).t()  # dense but not contiguous: clone() keeps its strides
    torch.save({"gathered": gathered.detach(), "x_grad": x.grad, "halo": halo.detach(), "band_grad": band.grad,
                "strided_sum": _all_reduce(strided)}, case_dir / f"rank{rank}.pt")


def guard(case_dir, case, rank, world):
    """One (1, world) step with primitive sharding and both flow losses
    from `case`'s state, each deform-field call's `live` and output
    cotangent saved."""
    from freegaussian_tpu_torch.models import fields

    calls, cots = [], []
    real = fields.deform_field

    def hooked(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(kwargs.get("live"))
        out.register_hook(lambda g: cots.append(g.detach().clone()))
        return out

    fields.deform_field = hooked
    mesh = make_mesh(1, world)
    cfg = SplatConfig(**case["model"])
    optimizers = make_optimizers(OptimizersConfig(max_steps=1000))
    deform = make_deform_field(cfg).reset_parameters(torch.Generator().manual_seed(case["seed"]))
    state = create_train_state(case["params"], case["alive"], deform.requires_grad_(True), optimizers,
                               generator=torch.Generator().manual_seed(case["seed"]))
    replicate_state(state, mesh)
    step = make_parallel_train_step(cfg, DensifyConfig(refine_start=10**9), optimizers, 1, mesh, case["hw"],
                                    with_flow=True, with_refine=False)
    _, metrics = step(state, _cameras(case["cams"]), case["images"], _cameras(case["cams0"]), case["flows"],
                      case["depth0s"], sh_degree_now=3)
    torch.save({"live": calls, "cotangents": cots, "loss": float(metrics["loss"])}, case_dir / f"rank{rank}.pt")


def main(case_dir, rank, world, port):
    case = torch.load(case_dir / "case.pt", weights_only=False)
    assert ensure_distributed(f"tcp://127.0.0.1:{port}", world, rank, device="cpu") == (rank, world)
    assert host_shard_info() == (rank, world) and local_device_count() == 1
    if case.get("kind") in ("collectives", "guard"):
        if case["kind"] == "collectives":
            collectives(case_dir, rank, world)
        else:
            guard(case_dir, case, rank, world)
        dist.destroy_process_group()
        return
    mesh = make_mesh(case["data"], case["tile"])
    cfg = SplatConfig(**case["model"])
    optimizers = make_optimizers(OptimizersConfig(max_steps=1000))
    saved = torch.load(next((case_dir / "ckpt").glob("*/state.pt")), weights_only=True)
    deform = make_deform_field(cfg, depth=case["deform_depth"], width=case["deform_width"])
    state = create_train_state(
        {k: torch.zeros_like(v) for k, v in saved["params"].items()}, saved["alive"], deform, optimizers,
        generator=torch.Generator().manual_seed(1000 + rank),  # replaced by rank 0's below
    )
    if rank == 0:
        load_checkpoint(case_dir / "ckpt", state)
    replicate_state(state, mesh)

    cams, imgs = _cameras(case["cams"]), case["images"]
    flow_args = (_cameras(case["cams0"]), case["flows"], case["depth0s"]) if case["with_flow"] else ()
    results = {}
    for variant, kw in case["variants"].items():
        step_state = state if len(case["variants"]) == 1 else _copy_state(state, deform, optimizers)
        step = make_parallel_train_step(
            cfg, DensifyConfig(**case["densify"]), optimizers, case["num_train_data"], mesh, case["hw"],
            with_flow=case["with_flow"], with_refine=case["with_refine"], **kw,
        )
        metrics = []
        for i in range(case["steps"]):
            draws = case["draws"][i] if case["draws"] else None
            step_state, m = step(step_state, cams, imgs, *flow_args, sh_degree_now=3, draws=draws)
            metrics.append({k: (float(v) if k != "refine" else {a: int(b) for a, b in v.items()}) for k, v in m.items()})
        cap = step_state.alive.shape[0]
        results[variant] = {
            "metrics": metrics,
            "params": {k: v.detach().clone() for k, v in step_state.params.items()},
            "deform": {k: v.detach().clone() for k, v in step_state.deform.state_dict().items()},
            "alive": step_state.alive.clone(),
            "densify": {k: getattr(step_state.densify, k).clone() for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
            "mu": {g: _gathered(step_state.opt_states[g].mu[g], cap, world) for g in GAUSSIAN_GROUPS},
            "nu": {g: _gathered(step_state.opt_states[g].nu[g], cap, world) for g in GAUSSIAN_GROUPS},
            "step": step_state.step,
        }
    torch.save(results, case_dir / f"rank{rank}.pt")
    dist.destroy_process_group()


def _copy_state(state, deform, optimizers):
    """An independent copy of a replicated state (two variants from one start)."""
    import copy

    out = copy.copy(state)
    out.params = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
    out.alive = state.alive.clone()
    out.deform = copy.deepcopy(deform)
    out.opt_states = copy.deepcopy(state.opt_states)
    out.densify = copy.deepcopy(state.densify)
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    out.generator = gen
    return out


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
