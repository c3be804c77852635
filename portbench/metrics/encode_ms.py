"""Device milliseconds a step under the harness's ``pb.encode``
range: the staircase encode (BerTest.encode)."""


def read(ctx):
    return ctx.range_ms("encode")
