"""trainer.boundary_ms.train: host ms a step between chunks: from the end
of each chunk's `chunk.collect` span (its metrics' copy to the host, which
drains the device) to the start of the next chunk's first step
(`chunk.step`, or `chunk.capture` where it captures), over the steps of the
chunks that end at such a boundary (the `steps` of their `chunk.collect`;
the window's last chunk has no next one). The device is idle there by
construction: logging, the capacity tuner, the next chunk's frame and
Adam-scalar tables. Read from the program's spans (`metrics/program.py`)."""

from metrics import program

STEPS = ("chunk.step", "chunk.capture")


def read(ctx):
    rec = program.recorded(ctx)
    if rec is None:
        return None
    chunks = []
    for spans in program.top_level(rec).values():
        first = next((s["start_ns"] for s in spans if s["name"] in STEPS), None)
        collects = [s for s in spans if s["name"] == "chunk.collect"]
        if first is not None and collects and collects[-1]["attrs"].get("steps"):
            chunks.append((first, collects[-1]["end_ns"], collects[-1]["attrs"]["steps"]))
    if len(chunks) < 2:
        return None
    chunks.sort()
    ns = sum(nxt[0] - prev[1] for prev, nxt in zip(chunks, chunks[1:]))
    return ns * 1e-6 / sum(steps for _, _, steps in chunks[:-1])
