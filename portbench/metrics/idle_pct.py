"""The device's idle share of the traced window, 100 (1 - busy / wall),
unclamped: busy above the wall would mean device time counted twice."""


def read(ctx):
    if not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
