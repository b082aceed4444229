"""The comparison that decides `correct`: each number beside its limit.

Training: each checked step's loss against the reference's (relative gap;
`loss` the widest over the steps, `loss_first` the first step's); the
first step's gradient as the program's Adam holds it (its first moment
after one step from zero moments is 0.1 g), leaf by leaf; each leaf's
change over the checked steps. Norms are compared, not the norm of the
difference: the gap between the program's norm of a leaf and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger; `grad` and `change` take the worst leaf,
`grad_median` and `change_median` the median leaf's gap. Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change (they move by round-off alone under Adam). A cell compares
the numbers its traffic file gives a limit.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import core

ADAM_B1 = 0.9


def _gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> Dict[str, float]:
    norms = {k: float(ref[k].double().norm()) for k in keys}
    med = core.median(list(norms.values()))
    return {k: core.norm_gap(prog[k], ref[k]) / max(norms[k], med, 1e-30) for k in keys}


def _worst(gaps: Dict[str, float]) -> tuple:
    which = max(gaps, key=gaps.get)
    return gaps[which], which


def training_numbers(ref: dict, mu1: Dict[str, torch.Tensor], p_end: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]):
    """(numbers, worst leaves): loss, grad and change readings."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(ref["prog_losses"], ref["losses"])]
    g_prog = {k: v / (1.0 - ADAM_B1) for k, v in mu1.items()}
    g_ref = ref["grads"]
    keys = sorted(g_ref)
    grad_gaps = _gaps(g_prog, g_ref, keys)
    grad, grad_leaf = _worst(grad_gaps)
    gnorm = {k: float(g_ref[k].double().norm()) for k in keys}
    med = core.median(list(gnorm.values()))
    moved = [k for k in keys if gnorm[k] >= 1e-3 * med]
    d_prog = {k: p_end[k].double() - start[k].double() for k in moved}
    d_ref = {k: ref["params"][k].double() - start[k].double() for k in moved}
    change_gaps = _gaps(d_prog, d_ref, moved)
    change, change_leaf = _worst(change_gaps)
    detail = {"grad": grad_leaf, "change": change_leaf, "loss_steps": losses, "grad_gaps": grad_gaps,
              "change_gaps": change_gaps}
    numbers = {
        "loss": max(losses), "loss_first": losses[0], "grad": grad, "grad_median": core.median(grad_gaps.values()),
        "change": change, "change_median": core.median(change_gaps.values()),
    }
    return numbers, detail


def training(ref: dict, mu1, p_end, start, limits: Dict[str, float]) -> dict:
    """The cell's numbers (those its traffic gives a limit) and the verdict."""
    every, leaves = training_numbers(ref, mu1, p_end, start)
    print(f"numbers: {every}; worst leaves: grad {leaves['grad']}, change {leaves['change']}", flush=True)
    numbers = {k: every[k] for k in limits}
    ok = all(numbers[k] == numbers[k] and numbers[k] <= limits[k] for k in numbers)
    return {"correct": ok, "numbers": numbers, "limits": dict(limits)}

