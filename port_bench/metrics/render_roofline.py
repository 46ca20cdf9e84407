"""``render_roofline`` (%, device trace): the traced frames' lower bound of
work (``port_bench.bounds.render_bound_s``, a lower bound: a hit's sphere
tests beyond one and every shadow ray's are not counted) over the render
kernel's (``render_fwd_kernel``) device time for them."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_seconds("render_fwd_kernel")
    bound = ctx.bound_seconds("render_fwd") if t > 0 else None
    return None if bound is None else 100.0 * bound / t
