"""mfu.train: the whole step's share of the card's peak: the least time of
the step's counted operations at the published peaks (`work.least_ms`:
the field products on the bf16 tensor cores, the compositor's f32 work)
over the traced window's wall time a step. Work that is not counted (SSIM,
projection, SH, the sort, the reduction, Adam) is listed in `work.py`."""

from metrics import work


def read(ctx):
    tr = ctx.get("trace")
    if not tr or ctx["steps"] <= 0:
        return None
    return 100.0 * work.least_ms(ctx) / (tr["window_s"] * 1e3 / ctx["steps"])
