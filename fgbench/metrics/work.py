"""The work of one training step, counted from shapes and the reference's
counts (never from the program's outputs), for the rooflines and
`mfu.train`.

The field calls of a step and the compositor's channels are the
configuration's (`work` in `configs/<config>.json`): each call as [in_ch,
backward, heads, sources, calls a step]. The compositor runs forward and
backward once a step. Left out of the counts: SSIM, projection, SH, the
binning's sort, the reduction and Adam.
"""

from __future__ import annotations

import bounds

def calls(ctx):
    return ctx["config"]["work"]["field_calls"]


def channels(ctx) -> int:
    return ctx["config"]["work"]["channels"]


def kernel_ms_per_step(ctx, names) -> float:
    tr = ctx["trace"]
    total = sum(s for k, s in tr["kernel_s"].items() if any(n in k for n in names))
    return total * 1e3 / max(ctx["steps"], 1)


def field_bound_ms(ctx) -> float:
    n = ctx["counts"]["live"]
    return sum(bounds.field_bound(n, i, True, b, h, s)[0] * c for i, b, h, s, c in calls(ctx))


def compositor_bound_ms(ctx) -> float:
    c = ctx["counts"]
    tiles = -(-c["width"] // c["tile"]) * -(-c["height"] // c["tile"])
    ch = channels(ctx)
    args = (c["live"], ch, int(c["isects"]), tiles, c["width"] * c["height"], int(c["walked_pairs"]))
    return bounds.compositor_bound(*args)[0] + bounds.backward_bound(*args)[0]


def least_ms(ctx) -> float:
    """The step's counted operations at the peaks: bf16 tensor-core
    products over 989 TFLOP/s, f32 over 67 TFLOP/s."""
    c = ctx["counts"]
    bf16 = f32 = 0.0
    for i, b, h, s, k in calls(ctx):
        t, hd = bounds.field_ops(c["live"], i, b, h)
        bf16 += t * k
        f32 += hd * k
    ch = channels(ctx)
    f32 += bounds.compositor_ops(ch, int(c["walked_pairs"])) + bounds.backward_ops(ch, int(c["walked_pairs"]))
    return (bf16 / bounds.PEAK_BF16_OPS + f32 / bounds.PEAK_F32_OPS) * 1e3


def idle_share(ctx):
    """100 - the device's busy share of the traced window; None without
    device events."""
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["device_events"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
