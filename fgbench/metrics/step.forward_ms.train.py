"""step.forward_ms.train: device ms a step in the training step's forward
(from the step's first phase mark to the mark after `forward` /
`control_forward` returns: the frame's tables, the background, the fields,
projection, SH, binning and the compositor), read from the program's
phase counters (`metrics/program.py`)."""

from metrics import program


def read(ctx):
    return program.phase_ms(ctx, "forward")
