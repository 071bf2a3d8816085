"""The conv reference branch's input-gradient kernel's share of its
roofline: the least time of every traced ``conv_ref_dgrad`` launch
(``counts_lstm.conv_dgrad_bound_s``: its bytes at the HBM rate, the larger
of that and its operations at the float32 peak) over their device time in
the trace. None where the trace holds no such launch."""

from port_bench import counts_lstm

KERNEL = "conv_ref_dgrad"


def read(ctx):
    if ctx.trace is None or ctx.card is None:
        return None
    launches = ctx.trace.kernels(KERNEL)
    spent = sum(e - s for _, s, e in launches) / 1e9
    if not spent:
        return None
    bound = counts_lstm.conv_dgrad_bound_s(ctx.config["net"], ctx.batch,
                                           ctx.card)
    return 100.0 * bound * len(launches) / spent
