"""``ssd_scan_roofline``: the least time of the scans the traced round needs
(one per Mamba2 row per sequence forward: the update's, the probe's and
the eval's, from shapes: ``fedbench/work/<family>.py``) over the device
time of the kernels the cell's file names as the scan, in the traced
round."""
from fedbench.harness.trace import kernel_seconds


def read(ctx):
    bound = ctx.work.scan_bound(ctx.c, ctx.forwards)
    spent = kernel_seconds(ctx.trace, ctx.cell.spec["kernels"]["ssd_scan"])
    return 100.0 * bound / spent if bound and spent > 0 else None
