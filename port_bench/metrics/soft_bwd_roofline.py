"""``soft_bwd_roofline`` (%, device trace): the traced steps' bound of the
fused soft loss and gradient (frozen ``soft_work``, mode "fused", of each
step's scene and tau) over the soft backward's device time for them
(``soft_bwd_kernel`` and its ``reduce_rows_kernel``)."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = (ctx.trace.kernel_seconds("soft_bwd_kernel")
         + ctx.trace.kernel_seconds("reduce_rows_kernel"))
    bound = ctx.bound_seconds("soft_bwd") if t > 0 else None
    return None if bound is None else 100.0 * bound / t
