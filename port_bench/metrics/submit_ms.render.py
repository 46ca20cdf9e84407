"""``submit_ms.render`` (ms a frame, harness span): time in the call into
``animation.render_frames`` until it returns (the host's packing, the
large-scene tables and the launches), summed over the window's batches and
divided by its frames."""


def read(ctx):
    return 1e3 * sum(ctx.spans) / ctx.units if ctx.units else None
