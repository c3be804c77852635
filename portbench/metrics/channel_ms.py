"""Device milliseconds a step under the harness's ``pb.channel``
range: modulation, AWGN, demap and interleaving (BerTest.channel_llrs)."""


def read(ctx):
    return ctx.range_ms("channel")
