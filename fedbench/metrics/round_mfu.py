"""``round_mfu``: the operations the window's rounds need, from shapes and
the masks each round records (``fedbench/work/<family>.py``), over the
window's wall time at the bf16 peak (``fedbench/harness/peaks.py``)."""
import numpy as np

from fedbench.harness.peaks import PEAK_OPS_PER_S


def read(ctx):
    flops = 0
    for r in ctx.records:
        masks = np.asarray(r.mask_matrix)
        n_probe = len(masks) if ctx.needs_probe else 0
        flops += ctx.work.round_flops(ctx.c, ctx.traffic, masks.tolist(),
                                      n_probe)
    return 100.0 * flops / (ctx.window_s * PEAK_OPS_PER_S["bfloat16"])
