"""``device_idle.fit`` (%, device trace): the share of the traced stretch of
steps in which no kernel, copy or memset ran on the card."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
