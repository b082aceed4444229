"""view.host_ms: what a traced request costs outside the model forward
(the orbit camera, `to_rgb8`'s copy and quantize, `encode_jpeg`, HTTP on
localhost): the mean request latency less the mean `view.render_ms`."""


def read(ctx):
    if ctx.get("render_ms") is None or ctx.get("request_ms") is None:
        return None
    return ctx["request_ms"] - ctx["render_ms"]
