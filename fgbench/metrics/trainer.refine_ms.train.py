"""trainer.refine_ms.train: device ms a step of refinement in the traced
window: the program's `refine.device_ms` counters (one a refinement inside
a chunk, by its step: the device time between two events around it) summed
over the window's steps (`metrics/program.py`). None where the window holds
no refinement, or the program keeps no such counter."""

from metrics import program


def read(ctx):
    rec = program.recorded(ctx)
    if rec is None:
        return None
    ms = rec["counters"].get("refine.device_ms")
    if not ms:
        return None
    return sum(ms.values()) / ctx["steps"]
