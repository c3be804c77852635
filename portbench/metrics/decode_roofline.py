"""The decode's share of its roofline: the least time of the work the
window's frames needed (the configuration's ``roofline`` family: the
operations from each frame's reported iterations, the LLRs read and the
answers written once, at the data sheet's peaks) over all device time
under the decode range, kernels and glue alike."""


def read(ctx):
    decode_s = ctx.device_s.get("decode", 0.0)
    if not decode_s:
        return None
    family = ctx.roofline
    ops = family.operations(ctx.schedule, ctx.edges, ctx.code.n,
                            ctx.totals["total_iterations"], ctx.totals["num_frames"])
    nbytes = family.bytes_moved(ctx.code.n, ctx.totals["num_frames"])
    least, _ = family.least_seconds(ops, nbytes, ctx.peaks.F32_OPS_PER_S,
                                    ctx.peaks.HBM_BYTES_PER_S)
    return 100.0 * least / decode_s
