"""step.backward_ms.train: device ms a step in `torch.autograd.grad` (the
compositor's backward, the reduction, the fields' backward kernels),
read from the program's phase counters (`metrics/program.py`)."""

from metrics import program


def read(ctx):
    return program.phase_ms(ctx, "backward")
