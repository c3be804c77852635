"""Device milliseconds a step under the harness's ``pb.counters``
range: the nine counters (simulation/ber.py _frame_counters) and the step's tail."""


def read(ctx):
    return ctx.range_ms("counters")
