"""The fused quad rollout's share of its roofline: the least time of
every traced launch of its forward and backward kernels (``counts``:
bytes at the HBM rate or operations at the float32 peak, the larger) over
their device time in the trace."""

from port_bench import counts

KERNELS = ("quad_rollout_fwd", "quad_rollout_bwd")


def read(ctx):
    if ctx.trace is None or ctx.card is None:
        return None
    bounds = counts.rollout_bound_s(ctx.batch, ctx.horizon, ctx.card)
    least = spent = 0.0
    for name, bound in zip(KERNELS, bounds):
        launches = ctx.trace.kernels(name)
        least += bound * len(launches)
        spent += sum(e - s for _, s, e in launches) / 1e9
    if not spent:
        return None
    return 100.0 * least / spent
