"""``select_ms``: the host's time a round in the layer selection, the mean
of the benchmark's spans around ``FLServer.select_round`` over the
window's rounds (the (P1) solve and its bookkeeping, on the solver
thread).  Nothing to read where the strategy has no probe."""


def read(ctx):
    if not ctx.needs_probe or not ctx.select_s:
        return None
    return 1e3 * sum(ctx.select_s) / len(ctx.select_s)
