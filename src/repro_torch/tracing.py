"""Spans and one counter inside the port, off by default.

    from repro_torch import tracing
    tracer = tracing.enable()
    ...                                   # run rounds
    torch.cuda.synchronize()
    spans = tracer.collect()              # finished spans, device times read
    tracing.disable()

The port's round path opens named spans where its work happens:

* ``round`` (``core/scheduler.py`` ``RoundScheduler.run``): one an
  iteration, the parent of that round's spans; its start and end are the
  two clock reads that give ``RoundRecord.wall_s``.  It also reads the CPU
  time of the threads that launch kernels (:func:`launch_ticks`) at both
  ends;
* ``select_wait`` (the same loop): the main thread's wait for the round's
  masks;
* ``solve`` (``core/server.py`` ``FLServer.select_round``): the (P1) solve,
  on the solver thread, when it is not a memo hit;
* ``update``, ``probe``, ``eval`` (``core/client.py``): the stages on the
  card;
* ``scan_bwd`` (``kernels/ops.py`` ``_SSD.backward``): the scan's backward,
  on torch's autograd device thread, under the open ``update`` or
  ``probe``.

With :data:`TRACER` None (the default) :func:`span` returns one shared
null context manager and :func:`begin` / :func:`end` return at once: one
None check, no clock read, no allocation, no CUDA event.  On, each span
records its name, its thread, its start and end on one monotonic clock
(``perf_counter_ns``), the thread's CPU time over it (``thread_time_ns``),
the round index ``t`` and the span that caused it.  A span given a CUDA
``device`` also records a timing event pair on the current stream; nothing
reads the events until :meth:`Tracer.collect`, which the caller runs after
its final synchronise.  The tracer keeps one anchor pair (``perf_counter_ns``,
``time_ns``), read back to back when it is switched on, so that
:meth:`Tracer.epoch_ns` puts any span on the clock ``torch.profiler``'s
events carry (Unix-epoch nanoseconds).

Every clock read of the round path lives in this module.  Spans stay in
memory until a caller reads them through :meth:`Tracer.collect`.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

# The tracer that :func:`enable` switched on, else None.
TRACER: Optional["Tracer"] = None

_TASKS = "/proc/self/task"
# torch's autograd engine names its device threads so (``comm`` is cut at
# 15 characters: ``pt_autograd_0``)
_AUTOGRAD = "pt_autograd"


def now_ns() -> int:
    """The monotonic clock every span reads."""
    return time.perf_counter_ns()


class _Null:
    """The one context manager :func:`span` returns with the tracer off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


class Span:
    """One finished (or open) span.  Times are ``perf_counter_ns``;
    ``dev_start_ms`` / ``dev_end_ms`` are the device's, from the first
    device event of the collection, filled by :meth:`Tracer.collect` for a
    span that recorded events; ``ticks`` (``round`` spans) maps each
    launching thread's id to its (name, CPU ticks at the start, at the
    end)."""
    __slots__ = ("name", "thread", "tid", "t", "parent", "start_ns",
                 "end_ns", "cpu_ns", "ticks", "dev_start_ms", "dev_end_ms",
                 "_cpu0", "_events", "_device")

    def __init__(self, name, t, parent, start_ns, device):
        self.name, self.t, self.parent = name, t, parent
        self.start_ns, self.end_ns = start_ns, None
        self.thread = threading.current_thread().name
        self.tid = threading.get_native_id()
        self.cpu_ns = None
        self.ticks = None
        self.dev_start_ms = self.dev_end_ms = None
        self._cpu0 = time.thread_time_ns()
        self._events = None
        self._device = device

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_ms(self) -> Optional[float]:
        if self.dev_start_ms is None:
            return None
        return self.dev_end_ms - self.dev_start_ms

    @property
    def path(self) -> str:
        """Names from the root span down to this one, joined by ``/``."""
        names, s = [], self
        while s is not None:
            names.append(s.name)
            s = s.parent
        return "/".join(reversed(names))


class _Open:
    """The context manager of one span with the tracer on."""
    __slots__ = ("tracer", "args", "span")

    def __init__(self, tracer, args):
        self.tracer, self.args = tracer, args

    def __enter__(self):
        self.span = self.tracer.open(*self.args, start_ns=now_ns())
        return self.span

    def __exit__(self, *exc):
        self.tracer.close(self.span, now_ns())
        return False


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:                 # the thread ended between list and read
        return None


def launch_ticks(main_tid: int) -> dict:
    """The CPU time, in clock ticks, of the threads that launch kernels:
    thread ``main_tid`` and torch's autograd device threads, each found by
    name under ``/proc/self/task/*/comm`` and read from its ``stat``
    (``utime + stime``).  Maps each thread id to (name, ticks); empty where
    the system has no ``/proc``.  Thread ids are kept as ``/proc`` spells
    them."""
    try:
        tids = os.listdir(_TASKS)
    except OSError:
        return {}
    out, main = {}, str(main_tid)
    for tid in tids:
        comm = _read(f"{_TASKS}/{tid}/comm")
        if comm is None or (tid != main and not comm.startswith(_AUTOGRAD)):
            continue
        stat = _read(f"{_TASKS}/{tid}/stat")
        if stat is None:
            continue
        # fields after the parenthesised name: state is the first, utime
        # the 12th and stime the 13th
        rest = stat[stat.rindex(")") + 2:].split()
        # repro: allow[host-sync] -- text of /proc, no device value
        out[tid] = (comm.strip(), int(rest[11]) + int(rest[12]))
    return out


class Tracer:
    """Spans of one process, kept in memory until :meth:`collect`."""

    def __init__(self):
        # the anchor: the same instant on the monotonic clock and on the
        # epoch clock of the profiler's events
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self._lock = threading.Lock()
        self._local = threading.local()
        self._done: list = []
        self._rounds: dict = {}         # t -> its open ``round`` span
        self._device_open: list = []    # open spans given a device

    def epoch_ns(self, ns: int) -> int:
        """A ``perf_counter_ns`` reading on the profiler's (epoch) clock."""
        return ns - self.anchor[0] + self.anchor[1]

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, name: str, t=None, device=None, *, start_ns: int) -> Span:
        """Open a span on this thread.  Its parent is the innermost span
        open on this thread; on a thread with none open, the open ``round``
        of ``t``, else (a stage's work on another thread, such as the
        autograd thread's backward) the newest open span given a device."""
        stack = self._stack()
        with self._lock:
            if stack:
                parent = stack[-1]
            elif t is not None and t in self._rounds:
                parent = self._rounds[t]
            else:
                parent = (self._device_open[-1] if self._device_open
                          else None)
            if t is None and parent is not None:
                t = parent.t
            span = Span(name, t, parent, start_ns, device)
            if device is not None:
                self._device_open.append(span)
            if name == "round":
                self._rounds[t] = span
        if device is not None and device.type == "cuda":
            import torch
            span._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            span._events[0].record()
        stack.append(span)
        return span

    def close(self, span: Span, end_ns: int) -> None:
        if span._events is not None:
            span._events[1].record()
        span.cpu_ns = time.thread_time_ns() - span._cpu0
        span.end_ns = end_ns
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        with self._lock:
            if span._device is not None:
                self._device_open.remove(span)
            if span.name == "round" and self._rounds.get(span.t) is span:
                del self._rounds[span.t]
            self._done.append(span)

    def collect(self) -> list:
        """The spans finished since the last call, in the order they
        closed, with their device times read from their events.  Run it
        after the device's work is synchronised: each event it reads is
        then complete, and nothing waits."""
        with self._lock:
            done, self._done = self._done, []
        timed = [s for s in done if s._events is not None]
        if timed:
            first = min(timed, key=lambda s: s.start_ns)._events[0]
            for s in timed:
                s.dev_start_ms = first.elapsed_time(s._events[0])
                s.dev_end_ms = first.elapsed_time(s._events[1])
        for s in done:
            s._events = s._device = None
        return done


def enable() -> Tracer:
    """Switch a fresh tracer on and return it."""
    global TRACER
    TRACER = Tracer()
    return TRACER


def disable() -> None:
    global TRACER
    TRACER = None


def span(name: str, *, t=None, device=None):
    """A context manager around one stage.  ``t`` is the round index where
    the caller knows it (else the parent's); ``device`` is the device of
    the stage's tensors, and a CUDA device adds a timing event pair.  With
    the tracer off, the shared null context."""
    if TRACER is None:
        return NULL
    return _Open(TRACER, (name, t, device))


def begin(name: str, t: int, start_ns: int) -> Optional[Span]:
    """Open a span at a clock reading the caller took (``round``: the
    reading that starts ``wall_s``), with the launching threads' CPU ticks;
    None with the tracer off."""
    if TRACER is None:
        return None
    s = TRACER.open(name, t, start_ns=start_ns)
    s.ticks = launch_ticks(s.tid)
    return s


def end(s: Optional[Span], end_ns: int) -> None:
    """Close a span from :func:`begin` at the caller's reading."""
    tracer = TRACER
    if s is None or tracer is None:
        return
    t0 = s.ticks
    s.ticks = {tid: (name, t0[tid][1], ticks)
               for tid, (name, ticks) in launch_ticks(s.tid).items()
               if tid in t0}
    tracer.close(s, end_ns)
