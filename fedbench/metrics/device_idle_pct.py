"""``device_idle_pct``: the share of the traced round (its client calls
replayed one after another, from the first kernel's start to the last
kernel's end or the host's return, whichever is later) in which no
operation ran on the card, from the device trace."""


def read(ctx):
    w = ctx.trace["window_s"]
    return 100.0 * (1.0 - ctx.trace["busy_s"] / w) if w > 0 else None
