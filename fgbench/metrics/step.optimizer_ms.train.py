"""step.optimizer_ms.train: device ms a step from the gradients to the
end of `apply_group_updates`: the dead-slot `torch.where` on the Gaussian
gradients and Adam over every group, read from the program's phase
counters (`metrics/program.py`)."""

from metrics import program


def read(ctx):
    return program.phase_ms(ctx, "optimizer")
