"""The device trace of a stretch: ``torch.profiler`` over a bounded call,
reduced to the device's busy time, the traced window, device time by
kernel name, and the longest idle gaps, each named by the operation that
ends it."""
from __future__ import annotations


def _events(prof, cuda: bool) -> list:
    """The device's operations (the host's on the CPU) as (name, start_ns,
    end_ns)."""
    from torch.autograd import DeviceType
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == want:
            start = e.start_ns()
            out.append((e.name(), start, start + e.duration_ns()))
    return out


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(window_ns: int, ops: list) -> dict:
    """Busy and window seconds, device seconds by kernel name, the ten
    longest device operations by total time and the ten longest idle gaps,
    each named by the operation that ends it.  ``ops`` are (name, start,
    end) in ns from the window's start; the window ends at ``window_ns`` or
    at the last operation's end, whichever is later."""
    w1 = max([window_ns] + [e for _, _, e in ops])
    busy = _merge([(s, e) for _, s, e in ops])
    by_name: dict = {}
    for n, s, e in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    edges = [0] + [x for b in busy for x in b] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    starts = sorted((s, n) for n, s, _ in ops)

    def before(t):
        nxt = [n for s, n in starts if s >= t]
        return f"before {nxt[0]}" if nxt else "after the last operation"
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": w1 / 1e9,
            "by_name": by_name,
            "device_ops": [[n[:160], t] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[before(e)[:160], (e - s) / 1e9]
                          for s, e in gaps[:10]]}


def trace_call(fn, cuda: bool = True) -> dict:
    """Run ``fn()`` once under the profiler, the card synchronised before
    and after, recording the device alone, so that no host-side recording
    slows the host's launches: its busy time, its window (by the host's
    clock, from the first kernel's start), device time by kernel and the
    idle gaps.  ``cuda=False`` (a rehearsal on the CPU) records the host's
    operations in the device's place."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter_ns()
        fn()
        sync()
        t1 = time.perf_counter_ns()
    ops = _events(prof, cuda)
    base = min((s for _, s, _ in ops), default=0)
    # the kernels' own clock, shifted to start the host's window
    return reduce(t1 - t0, [(n, s - base, e - base) for n, s, e in ops])


def kernel_seconds(trace: dict, patterns) -> float:
    """Device seconds of the kernels whose names contain a pattern."""
    return sum(t for n, t in trace["by_name"].items()
               if any(p in n for p in patterns))
