"""Device milliseconds a step under the harness's ``pb.decode``
range: the decoder's call, kernels and glue (BerTest.decode)."""


def read(ctx):
    return ctx.range_ms("decode")
