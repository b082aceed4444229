"""step.loss_ms.train: device ms a step in the loss (L1 + SSIM, the flow
losses and the regularizers, to the complete total), read from the
program's phase counters (`metrics/program.py`)."""

from metrics import program


def read(ctx):
    return program.phase_ms(ctx, "loss")
