"""step.bookkeeping_ms.train: device ms a step after Adam: the
densification statistics, the loss metrics, `state_metrics`' finiteness
checks, the metrics row and the cursor, read from the program's phase
counters (`metrics/program.py`)."""

from metrics import program


def read(ctx):
    return program.phase_ms(ctx, "bookkeeping")
