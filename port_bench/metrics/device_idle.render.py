"""``device_idle.render`` (%, device trace): the share of the traced stretch
of frames in which no kernel, copy or memset ran on the card."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
