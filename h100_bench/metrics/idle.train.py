"""idle.train: the share of the traced window in which no operation
ran on the card, in percent.  Device trace."""


def read(ctx):
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100
