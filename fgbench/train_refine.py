"""The training cells whose window refines (`kind` "train_refine"):
`train.py`'s flow unchanged (set-up, the checked steps, warm-up, the
window, the reference's steps after it), and one more check, of the first
refinement after the checked steps, against the reference's density
control (`reference/densify.py`) on the program's own inputs to it.

`RefineCheck` wraps the trainer's `_refine_at` (as `train.Recorder` wraps
the chunk runner) from the end of the checked steps on. At the first
refinement it keeps what the program refines from: the statistics, the
parameters and `alive` of the whole table, Adam's moments, the step, the
frame size, and the state of the generator that the split samples are
drawn from. Once the program has refined, it runs the reference on those
inputs, with the normal draws made from the kept generator state as the
program makes them, compares, and frees what it kept. In a traced run the
program's own counters of the window's refinements (`refine.split`,
`refine.dup`, `refine.culled`, `refine.alive`, `refine.dropped`) are
printed after it.

The check's numbers, each beside its limit in `checks` where the traffic
gives one:
  - `refine_rows`: the slots whose state after the refinement differs
    from the reference's in kind (live or not, Adam's row restarted or
    kept, a kept row's parameters bit for bit), over the live rows before;
  - `refine_counts`: the largest gap between the program's and the
    reference's split, duplicated, culled, live and dropped counts, over
    the reference's count (or 1);
  - `refine_children`: the children's parameters: the largest, over the six
    leaves, of the norm of the program's minus the reference's values over
    the reference's norm, on the slots the reference gave a child (0 where
    no row splits or is duplicated: a traffic whose checked refinement
    gives no child sets no limit on it).

A program whose refinement does not count its dropped rows cannot be
checked, and the run refuses at once (`counts_dropped`).
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch

import train
from reference import densify

REFINE_KEYS = ("refine_rows", "refine_counts", "refine_children")
COUNTS = ("num_split", "num_dup", "num_culled", "num_alive", "num_dropped")


def counts_dropped() -> bool:
    """Whether the program's `refine` reports the rows it could not place
    (`num_dropped`), on a 4-slot table on the CPU."""
    from freegaussian_tpu_torch.models.densify import DensifyConfig, DensifyState, refine

    n = 4
    z = lambda *s: torch.zeros((n,) + s)  # noqa: E731
    params = {"means": z(3), "scales": z(3), "quats": z(4) + torch.tensor([1.0, 0, 0, 0]), "features_dc": z(3),
              "features_rest": z(15, 3), "opacities": z(1)}
    alive = torch.zeros(n, dtype=torch.bool)
    info = refine(DensifyConfig(), params, alive, DensifyState.create(n), 0, (8, 8), 1, split_eps=(z(3), z(3)))[3]
    return "num_dropped" in info


def normal_draws(state: torch.Tensor, shape, device, k: int) -> tuple:
    """`k` standard-normal arrays of `shape`, drawn one after the other
    from a generator at `state`, as the program draws its split samples."""
    g = torch.Generator(device=device)
    g.set_state(state)
    return tuple(torch.randn(shape, generator=g, device=device) for _ in range(k))


class RefineCheck:
    """The first refinement's comparison (`numbers`, `detail`). With
    `control` (a dtype), also the reference computed in that precision in
    the program's place (`control_numbers`)."""

    def __init__(self, trainer, settings: dict, num_train: int, control=None):
        self.trainer = weakref.ref(trainer)  # the run frees the trainer before the reference follows
        self.settings, self.num_train, self.control = settings, num_train, control
        self.numbers: Optional[Dict[str, float]] = None
        self.control_numbers: Optional[Dict[str, float]] = None
        self.detail: dict = {}
        inner = trainer._refine_at
        cadence = trainer.config.densify

        def refine_at(step, last_size):
            if self.numbers is not None or not (step >= cadence.refine_start and step % cadence.refine_every == 0):
                return inner(step, last_size)
            kept = self._keep(step, last_size)
            got = inner(step, last_size)
            if got is not None:
                self._compare(kept, got)
            return got

        trainer._refine_at = refine_at

    def _keep(self, step: int, last_size) -> dict:
        st = self.trainer().state
        moments = {}
        for g in densify.GROUPS:
            s = st.opt_states[g]
            for which, table in (("mu", s.mu), ("nu", s.nu)):
                for k, v in table.items():
                    if v.shape == st.params[g].shape:
                        moments[(g, which, k)] = v.detach().clone()
        d = st.densify
        return {
            "step": step, "last_size": tuple(last_size), "alive": st.alive.clone(),
            "params": {k: st.params[k].detach().clone() for k in densify.GROUPS},
            "stats": {"xys_grad_norm": d.xys_grad_norm.clone(), "vis_counts": d.vis_counts.clone(),
                      "max_2dsize": d.max_2dsize.clone()},
            "moments": moments, "generator": st.generator.get_state(),
        }

    @torch.no_grad()
    def _compare(self, kept: dict, got: dict) -> None:
        st = self.trainer().state
        ref = self.reference(kept)
        moments = {key: getattr(st.opt_states[key[0]], key[1])[key[2]] for key in kept["moments"]}
        prog_counts = {k: int(got[k]) for k in COUNTS}
        self.numbers, self.detail = numbers(kept, ref, st.alive, st.params, moments, prog_counts)
        print(f"refinement check at step {kept['step']}: program {prog_counts}, reference "
              f"{self.detail['reference']}, differing slots {self.detail['rows']}, children's gaps "
              f"{self.detail['children']}", flush=True)
        if self.control is not None:
            ctrl = self.reference(kept, self.control)
            after = {key: restarted(before, ctrl, key[0]) for key, before in kept["moments"].items()}
            self.control_numbers = numbers(kept, ref, ctrl["alive"], ctrl["params"], after,
                                           {k: ctrl[k] for k in COUNTS})[0]

    def reference(self, kept: dict, dtype=torch.float32) -> dict:
        """The reference's refinement of the kept inputs, its normal draws
        made from the kept generator state as the program makes them."""
        shape, dev = kept["params"]["means"].shape, kept["alive"].device
        eps = normal_draws(kept["generator"], shape, dev, self.settings["n_split_samples"])
        return densify.refine(self.settings, kept["params"], kept["alive"], kept["stats"], kept["step"],
                              kept["last_size"], self.num_train, eps, dtype)


def restarted(before: torch.Tensor, ref: dict, group: str) -> torch.Tensor:
    """A moment tensor as the reference leaves it: its rows of
    `moment_zero` zeroed, and every row of the opacities' at a reset."""
    rows = ref["moment_zero"] | (group == "opacities" and ref["reset_opacity_moments"])
    return torch.where(rows.reshape((-1,) + (1,) * (before.ndim - 1)), torch.zeros_like(before), before)


@torch.no_grad()
def numbers(kept: dict, ref: dict, alive: torch.Tensor, params, moments, counts: Dict[str, int]):
    """(the check's numbers, their detail) for a state after the
    refinement (`alive`, `params`, the moment tensors by (group, mu|nu,
    name), the counts) against the reference's."""
    rows = alive != ref["alive"]
    for key, before in kept["moments"].items():
        rows |= (moments[key] != restarted(before, ref, key[0])).reshape(before.shape[0], -1).any(-1)
    kept_rows = ref["alive"] & ~ref["placed"]
    gaps = {}
    for k in densify.GROUPS:
        got, want = params[k].detach(), ref["params"][k]
        rows |= kept_rows & (got != want).reshape(got.shape[0], -1).any(-1)
        a, b = got[ref["placed"]].double(), want[ref["placed"]].double()
        gaps[k] = float((a - b).norm() / max(float(b.norm()), 1e-30)) if a.numel() else 0.0
    ref_counts = {k: ref[k] for k in COUNTS}
    out = {
        "refine_rows": float(rows.sum()) / max(int(kept["alive"].sum()), 1),
        "refine_counts": max(abs(counts[k] - ref_counts[k]) / max(ref_counts[k], 1) for k in COUNTS),
        "refine_children": max(gaps.values()),
    }
    detail = {"step": kept["step"], "program": counts, "reference": ref_counts, "children": gaps,
              "rows": int(rows.sum())}
    return out, detail


def print_window_refinements() -> None:
    """The program's counters of the traced window's refinements, by step
    (nothing where the program keeps none)."""
    try:
        from freegaussian_tpu_torch.utils import profiling

        counters = profiling.recorded()["counters"]
    except (ImportError, AttributeError, KeyError):
        return
    names = ("split", "dup", "culled", "alive", "dropped")
    for step in sorted(counters.get("refine.alive", {}), key=int):
        print(f"refinement at step {step}: " + ", ".join(f"{k} {counters[f'refine.{k}'][step]}" for k in names),
              flush=True)


def split_limits(traffic: dict):
    """(the training numbers' limits, the refinement check's)."""
    limits = traffic["limits"]
    return ({k: v for k, v in limits.items() if k not in REFINE_KEYS},
            {k: v for k, v in limits.items() if k in REFINE_KEYS})


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, t_process: float,
        device="cuda") -> dict:
    if not counts_dropped():
        raise SystemExit("fgbench: the program's refinement does not count the rows it drops (`num_dropped`); "
                         "the refinement check needs it")
    train_limits, refine_limits = split_limits(traffic)
    settings = densify.settings_of(cfg["settings"]["pipeline"]["model"])
    checks: list = []
    first_steps = train.first_steps

    def first_steps_then_watch(trainer, inputs, tr):
        out = first_steps(trainer, inputs, tr)
        checks.append(RefineCheck(trainer, settings, len(inputs.i_train)))
        return out

    train.first_steps = first_steps_then_watch
    try:
        res = train.run(cell, cfg, dict(traffic, limits=train_limits), seed, seconds, trace, t_process,
                        device=device)
    finally:
        train.first_steps = first_steps
    if trace:
        print_window_refinements()
    check = checks[0]
    if check.numbers is None:
        raise RuntimeError("no refinement came after the checked steps: the traffic's warm-up must hold one")
    verdict = res["verdict"]
    for k, limit in refine_limits.items():
        verdict["numbers"][k] = check.numbers[k]
        verdict["limits"][k] = limit
    verdict["correct"] = all(v == v and v <= verdict["limits"][k] for k, v in verdict["numbers"].items())
    res["refine"] = check.detail
    return res
