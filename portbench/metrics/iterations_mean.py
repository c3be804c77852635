"""Iterations a frame: the steps' own counters, total iterations over
frames."""


def read(ctx):
    frames = ctx.totals["num_frames"]
    return ctx.totals["total_iterations"] / frames if frames else None
