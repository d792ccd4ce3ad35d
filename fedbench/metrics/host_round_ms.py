"""``host_round_ms``: the host's time a round in the window, the mean of
the program's own ``RoundRecord.wall_s`` (the round scheduler's select
submit to dispatch complete, the prefetch inside it; not device time)."""


def read(ctx):
    walls = [r.wall_s for r in ctx.records]
    return 1e3 * sum(walls) / len(walls) if walls else None
