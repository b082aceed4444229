"""field_roofline.train: the field kernels' share of their roofline in a
training step: the frozen `field_bound` at the live rows for each of the
step's field calls (`metrics/work.py`), over the device time of the
kernels named in `KERNELS` a step in the traced window. None
when the trace holds none of them (a renamed or fused kernel: a benchmark
change repoints the names)."""

from metrics import work

KERNELS = ("field_fwd_kernel", "field_dgrad_kernel", "field_wgrad_kernel")  # csrc/deform_field.cu


def read(ctx):
    if not ctx.get("trace"):
        return None
    ms = work.kernel_ms_per_step(ctx, KERNELS)
    if ms <= 0:
        return None
    return 100.0 * work.field_bound_ms(ctx) / ms
