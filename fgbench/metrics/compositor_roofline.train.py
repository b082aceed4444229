"""compositor_roofline.train: the compositor's and its backward's share of
their roofline in a training step: the frozen `compositor_bound` +
`backward_bound` at the live rows, the binning's pairs at the program's
tile and the pairs a 16-px walk takes (both counted by the reference on the
checked steps' frames), over the device time of the kernels named in
`KERNELS` a step. None when the trace holds none of them."""

from metrics import work

KERNELS = ("rasterize_fwd_kernel", "rasterize_bwd_walk", "rasterize_bwd_combine")  # csrc/rasterize_*.cu


def read(ctx):
    if not ctx.get("trace"):
        return None
    ms = work.kernel_ms_per_step(ctx, KERNELS)
    if ms <= 0:
        return None
    return 100.0 * work.compositor_bound_ms(ctx) / ms
