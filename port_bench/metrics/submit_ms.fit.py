"""``submit_ms.fit`` (ms a step, harness span): time in the train step's call
(``make_train_step``'s ``step()``: the host's packing, the fused launch, the
gradient's unpacking and Adam) until it returns, before the loss is read,
averaged over the window's steps."""


def read(ctx):
    return 1e3 * sum(ctx.spans) / ctx.units if ctx.units else None
