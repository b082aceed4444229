"""field.live_block_fill.train: the share of the rows the field kernels
run over that are live, at the window's chunk ends: the live rows over
the rows of the 128-row blocks holding a live row (the kernels' own
rule), from the program's counters `field.live_rows` and
`field.block_rows` (`metrics/program.py`)."""

from metrics import program


def read(ctx):
    rec = program.recorded(ctx)
    if rec is None:
        return None
    rows = rec["counters"].get("field.block_rows", 0)
    if not rows:
        return None
    return 100.0 * rec["counters"].get("field.live_rows", 0) / rows
