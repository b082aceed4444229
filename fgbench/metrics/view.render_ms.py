"""view.render_ms: the model forward of a request (the verb's render
function: `Trainer.viewer_render_fn` -> `models/splat_model.py:forward`),
timed by the harness's wrapper around the server's `render_fn` with a
device synchronisation on each side, mean over the traced requests."""


def read(ctx):
    return ctx.get("render_ms")
