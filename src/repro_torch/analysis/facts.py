"""Per-program fact extraction for the program auditor (counterpart of
``repro/analysis/facts.py``, DESIGN.md §11).

The reference lowers a jitted program once and reads its jaxpr and
compiled HLO.  Eager PyTorch has neither: here a program is *run* once on
concrete inputs under one dispatch mode, :class:`_Audit`, which sees every
ATen op below autograd (the backward too) and reads:

* **FLOPs** as ``torch.utils.flop_counter.FlopCounterMode`` counts them
  (its per-op formulas: the matmul class, convolutions, attention; an op
  without a formula is decomposed where it can be and its parts counted);
* **weight traffic** — every tensor leaf of a weight argument is tagged by
  its storage; views share the storage, and copies, casts and gathers of a
  tagged tensor (``_COPY_OPS``) tag their outputs.  ``weight_bytes`` is the
  bytes of tagged operands of matmul-class ops (``mm``, ``bmm``,
  ``addmm``, ...).  The delta-serving contract pins it: delta decode reads
  each base weight once and each of the C delta entries once whatever the
  batch B, the dense baseline reads one private copy per slot.  A training
  program's updated params are new tensors, so only its input params count;
* a **dtype census**: ``jaxpr_dtypes`` names the dtypes of the arguments
  and of every op's outputs, ``hlo_dtypes`` counts the outputs by short
  name (f32, bf16, f64, ...); ``out_dtypes`` are the program's results';
* **transfer ops** — ops that wait for the card (``.item()``'s
  ``_local_scalar_dense``, ``nonzero``, a boolean-mask index, ...) and
  copies from the card to the host;
* **collectives** — the ops of the c10d namespaces, counted and their
  operand bytes summed by kind under the reference's HLO names
  (``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
  ``collective-permute``: :func:`collective_kind`), as
  ``repro/sharding/hlo_analysis.py::collective_stats`` sums them: an
  all-gather's operand is the local shard, a reduce-scatter's the full
  input.  ``collective_bytes`` is their sum, this process's alone;
* **hbm_bytes** — the traffic of an unfused eager program: over every
  ATen op that is not a view or an allocation (``empty``), the bytes of its
  tensor operands (not the destination of ``copy_``, ``fill_``, ``zero_``)
  and outputs, each counted whole, plus the bytes each
  Hopper kernel reports (its inputs read once, its outputs written once).
  The reference reads XLA's fused program instead, so the two are not
  comparable: this one counts every intermediate the eager program writes
  and reads back;
* **donation** — ``donated_declared`` counts the leaves of the arguments a
  spec declares donated; ``donation_applied`` those written in place (an op
  whose schema writes that argument) and handed back in the output;
* sizes: ``arg_bytes``, ``out_bytes``, ``param_bytes`` (the weight leaves)
  and ``temp_bytes``: on the card the peak of
  ``torch.cuda.max_memory_allocated`` over what was allocated before; on
  the meta device (a dry run, ``launch/dryrun.py``) the peak of the live
  storage bytes the run made, a storage counting from the op that made it
  until its last reference is gone (:class:`_LiveBytes`); on the CPU 0.

The port's Hopper kernels launch through ``ctypes``, which the dispatcher
never sees: while facts are extracted the audit is ``kernels.ops.RECORDER``,
and each kernel wrapper reports its operations and its weight operands to
it (:meth:`_Audit.launched`; ``kernel_launches`` counts the reports).
``code_bytes`` comes from XLA's compiled program in the reference and has
no eager counterpart: it stays 0.  Running the program means the facts
are those of the inputs given, and on the card a spec's inputs must live
there; on the meta device the kernels take their meta route
(``kernels/ops.py``) and the facts are those of the card's program.
"""
from __future__ import annotations

import functools
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

# The audit decomposes composite ops (``matmul``, ``linear``, ``to``, ...)
# as FlopCounterMode does, so these lists name the ATen ops they become.
# Matmul-class ops whose weight-tagged operands count as streamed weights:
_MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm",
                         "convolution", "_scaled_mm"})
# Non-view ops whose output carries its input's weight tag (views share the
# input's storage and carry it anyway):
_COPY_OPS = frozenset({"_to_copy", "clone", "cat", "stack", "index_select",
                       "index", "gather", "repeat", "expand_copy"})
# Ops that make the host wait for the card (the sync-debug mode's list):
# a scalar read, data-dependent output sizes.
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                      "equal", "unique", "_unique", "_unique2",
                      "unique_consecutive", "unique_dim"})
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional",
                                    "c10d_functional", "_dtensor"})
# A collective op's name (underscores dropped) → the reference's HLO kind.
_COLLECTIVE_KINDS = (("allgather", "all-gather"),
                     ("reducescatter", "reduce-scatter"),
                     ("allreduce", "all-reduce"), ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))
# The schema names of a collective's operand (c10d: ``input_tensor`` /
# ``input_tensors``, ``allreduce_``'s ``tensors``; functional: ``input``).
_OPERAND_ARGS = frozenset({"input_tensor", "input_tensors", "input",
                           "tensors"})
# Ops that allocate without writing: no traffic.
_ALLOC_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})
# In-place ops that overwrite their first argument without reading it.
_OVERWRITE_OPS = frozenset({"copy_", "fill_", "zero_"})
_SHORT = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
          torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
          torch.bool: "pred", torch.complex64: "c64",
          torch.complex128: "c128"}


def dtype_name(dt: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"`` (numpy's and JAX's names)."""
    return str(dt).removeprefix("torch.")


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _ref(t: torch.Tensor) -> StorageWeakRef:
    return StorageWeakRef(t.untyped_storage())


def _op_tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (lists of tensors included:
    ``cat``, ``stack``, ``index``)."""
    out = []
    for v in (*args, *kwargs.values()):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def collective_kind(name: str) -> str | None:
    """The reference's HLO kind of a c10d op (``_allgather_base_`` →
    ``all-gather``), its own name for another collective (``broadcast_``,
    ``barrier``), None for ``wait_tensor``, which only waits."""
    bare = name.replace("_", "")
    if bare == "waittensor":
        return None
    for key, kind in _COLLECTIVE_KINDS:
        if key in bare:
            return kind
    return name.strip("_")


def _operand_bytes(func, args, kwargs) -> int:
    """Bytes of a collective's operand tensors (by schema name)."""
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    return sum(map(tensor_bytes, _op_tensors(
        [v for k, v in named.items() if k in _OPERAND_ARGS], {})))


class _LiveBytes:
    """The live storage bytes a run made, and their peak: each new storage
    among an op's outputs (not one of its inputs' storages, which a view
    or an in-place op hands back) counts from that op until the storage is
    freed, which a finalizer on it reports."""

    def __init__(self):
        self.live = self.peak = 0
        self._keys: set = set()

    def _freed(self, key: int, n: int) -> None:
        self._keys.discard(key)
        self.live -= n

    def made(self, outs, ins) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._keys or key in seen:
                continue
            n = st.nbytes()
            self._keys.add(key)
            self.live += n
            weakref.finalize(st, self._freed, key, n).atexit = False
        self.peak = max(self.peak, self.live)


def host_sync_op(func, args, kwargs, *, card: bool) -> str | None:
    """The name under which ``func(*args, **kwargs)`` would make the host
    wait for the card, else None: a ``SYNC_OPS`` op, an index by a boolean
    mask (a ``nonzero`` inside), or a copy from a CUDA tensor to the host.
    On the card (``card``) only ops that read a CUDA tensor wait; a CPU run
    stands in for the card, so there every ``SYNC_OPS`` op and mask index
    counts.  A copy to the host counts only from a CUDA tensor: in a CPU
    run there is none, and a readback of a host tensor reaches no op at
    all (``strict`` catches those methods on the CPU instead)."""
    name = func.overloadpacket.__name__
    if name in ("to", "_to_copy", "copy_", "copy"):
        if name in ("to", "_to_copy"):
            src = args[0]
            dst = kwargs.get("device", next(
                (a for a in args[1:] if isinstance(a, (torch.device, str))),
                None))
        else:
            src, dst = args[1], getattr(args[0], "device", None)
        if (isinstance(src, torch.Tensor) and src.is_cuda and dst is not None
                and torch.device(dst).type == "cpu"):
            return "device_to_host_copy"
        return None
    if name == "index":
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if not any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8) for i in idx):
            return None
        name = "index_by_mask"
    elif name not in SYNC_OPS:
        return None
    if card and not any(t.is_cuda for t in _op_tensors(args, kwargs)):
        return None
    return name


@functools.cache
def _decomposes(func) -> bool:
    """Does ``func`` lack a FLOP formula and have a composite kernel
    (FlopCounterMode then counts its parts)?"""
    return (func.overloadpacket not in flop_registry
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))


class _Audit(TorchDispatchMode):
    """Records one run's facts (see the module docstring); also the kernel
    wrappers' :data:`ops.RECORDER` while the run lasts.  FLOPs are counted
    as ``FlopCounterMode`` counts them (its formulas; an op without one is
    decomposed when it can be, and its parts counted), in this one mode."""

    def __init__(self, weights: Sequence[torch.Tensor], card: bool,
                 meta: bool = False):
        super().__init__()
        self.card = card
        self._weights = {_ref(t) for t in weights}
        self.flops = 0
        self.hbm_bytes = 0
        self.live = _LiveBytes() if meta else None
        self.out_dtypes: Counter = Counter()      # torch dtype -> outputs
        self.weight_bytes = 0.0
        self.kernel_launches: Counter = Counter()
        self.transfers: Counter = Counter()
        self.collectives: Counter = Counter()       # kind -> ops
        self.collective_bytes: Counter = Counter()  # kind -> operand bytes
        self.written: set = set()

    def _tagged(self, t: torch.Tensor) -> bool:
        return _ref(t) in self._weights

    def launched(self, kernel: str, flops: int, weights,
                 nbytes: int = 0) -> None:
        """A kernel wrapper's report of one launch (``kernels/ops.py``)."""
        self.flops += flops
        self.hbm_bytes += nbytes
        self.kernel_launches[kernel] += 1
        self.weight_bytes += sum(tensor_bytes(w) for w in weights
                                 if self._tagged(w))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if _decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        sync = host_sync_op(func, args, kwargs, card=self.card)
        if sync is not None:
            self.transfers[sync] += 1
        out = func(*args, **kwargs)
        name = packet.__name__
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = (out,) if isinstance(out, torch.Tensor) else _tensors(out)
        ins = _op_tensors(args, kwargs)
        for t in outs:
            self.out_dtypes[t.dtype] += 1
        if func.namespace == "aten":
            if not func.is_view and name not in _ALLOC_OPS:
                read = ins[1:] if name in _OVERWRITE_OPS else ins
                self.hbm_bytes += sum(map(tensor_bytes, read)) + sum(
                    map(tensor_bytes, outs))
        elif func.namespace in _COLLECTIVE_NAMESPACES:
            kind = collective_kind(name)
            if kind is not None:
                self.collectives[kind] += 1
                self.collective_bytes[kind] += _operand_bytes(func, args,
                                                              kwargs)
        if self.live is not None:
            self.live.made(outs, ins)
        if name in _MATMUL_OPS:
            self.weight_bytes += sum(tensor_bytes(t) for t in ins
                                     if self._tagged(t))
        elif name in _COPY_OPS and any(self._tagged(t) for t in ins):
            self._weights.update(_ref(t) for t in outs)
        if func._schema.is_mutable:
            for a, v in zip(func._schema.arguments, args):
                if (a.alias_info is not None and a.alias_info.is_write
                        and isinstance(v, torch.Tensor)):
                    self.written.add(_ref(v))
        return out


@dataclass
class ProgramFacts:
    """Everything the contract layer reads, one program (the reference's
    fields; see the module docstring for what each means here)."""
    name: str
    meta: dict = field(default_factory=dict)
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    transfer_ops: dict = field(default_factory=dict)
    hlo_dtypes: dict = field(default_factory=dict)
    donation_applied: int = 0
    weight_bytes: float = 0.0
    jaxpr_dtypes: list = field(default_factory=list)
    out_dtypes: list = field(default_factory=list)
    donated_declared: int = 0
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    code_bytes: int = 0
    param_bytes: int = 0
    kernel_launches: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "meta": dict(self.meta),
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": dict(self.collective_by_kind),
            "collective_counts": dict(self.collective_counts),
            "transfer_ops": dict(self.transfer_ops),
            "hlo_dtypes": dict(self.hlo_dtypes),
            "donation_applied": self.donation_applied,
            "weight_bytes": self.weight_bytes,
            "jaxpr_dtypes": sorted(self.jaxpr_dtypes),
            "out_dtypes": list(self.out_dtypes),
            "donated_declared": self.donated_declared,
            "arg_bytes": self.arg_bytes, "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes, "code_bytes": self.code_bytes,
            "param_bytes": self.param_bytes,
            "kernel_launches": dict(self.kernel_launches),
        }


def extract_facts(name: str, fn: Callable, args: Sequence[Any], *,
                  donate_argnums: Sequence[int] = (),
                  weight_argnums: Sequence[int] = (),
                  meta: dict | None = None) -> ProgramFacts:
    """Run ``fn(*args)`` once under the audit and return its fact row.

    ``weight_argnums`` name the arguments that hold weights (the tags'
    roots), ``donate_argnums`` those the program declares donated (written
    in place and handed back).  Non-tensor arguments (ints, strings) are
    the reference's static arguments.  The run's results are dropped.
    """
    weights = [t for i in weight_argnums for t in _tensors(args[i])]
    donated = [t for i in donate_argnums for t in _tensors(args[i])]
    on_card = any(t.is_cuda for t in _tensors(args))
    on_meta = any(t.is_meta for t in _tensors(args))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    audit = _Audit(weights, on_card, meta=on_meta)
    prev, ops.RECORDER = ops.RECORDER, audit
    try:
        with audit:
            out = fn(*args)
    finally:
        ops.RECORDER = prev
    temp = audit.live.peak if on_meta else 0
    if on_card:
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - before
    outs = _tensors(out)
    out_refs = {_ref(t) for t in outs}
    applied = sum(1 for t in donated
                  if _ref(t) in audit.written and _ref(t) in out_refs)
    return ProgramFacts(
        name=name, meta=dict(meta or {}),
        flops=float(audit.flops),
        hbm_bytes=float(audit.hbm_bytes),
        collective_bytes=float(sum(audit.collective_bytes.values())),
        collective_by_kind={k: float(v)
                            for k, v in audit.collective_bytes.items()},
        collective_counts=dict(audit.collectives),
        transfer_ops=dict(audit.transfers),
        hlo_dtypes={_SHORT.get(dt, dtype_name(dt)): n
                    for dt, n in audit.out_dtypes.items()},
        donation_applied=applied,
        weight_bytes=audit.weight_bytes,
        jaxpr_dtypes=sorted({dtype_name(t.dtype) for t in _tensors(args)}
                            | {dtype_name(dt) for dt in audit.out_dtypes}),
        out_dtypes=[dtype_name(t.dtype) for t in outs],
        donated_declared=len(donated),
        arg_bytes=sum(tensor_bytes(t) for t in _tensors(args)),
        out_bytes=sum(tensor_bytes(t) for t in outs),
        temp_bytes=temp,
        param_bytes=sum(tensor_bytes(t) for t in weights),
        kernel_launches=dict(audit.kernel_launches),
    )
