"""step.kernels.train: the kernel nodes of the step graph that the window
replayed most (counted at its capture in the graph itself), read from the
program's counters `step.replays` and `step.kernel_nodes`
(`metrics/program.py`)."""

from metrics import program


def read(ctx):
    rec = program.recorded(ctx)
    if rec is None:
        return None
    replays = rec["counters"].get("step.replays", {})
    nodes = rec["counters"].get("step.kernel_nodes", {})
    graphs = [g for g in replays if nodes.get(g) is not None]
    if not graphs:
        return None
    return nodes[max(graphs, key=lambda g: replays[g])]
