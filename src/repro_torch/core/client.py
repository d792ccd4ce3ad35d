"""Client-side local training (Eq. 2-4) and the selection probe, §4.2
(counterpart of ``repro/core/client.py``).

Two granularities share the same per-client math:

* per client: :meth:`Client.local_update` / :meth:`Client.probe` — the
  sequential oracle;
* per cohort: :meth:`Client.cohort_update` / :meth:`Client.probe_cohort` —
  the vectorized engine, with the Eq.(5)-(7) aggregation and Eq.(6) apply
  in the same call.  The reference's ``jax.vmap`` over the cohort becomes
  a loop over clients (each is independent, so the results are the same)
  and its ``lax.scan`` over τ a loop over steps; there is no jit cache.

The masked round (``cohort_update`` with an integer cut) differentiates
only the trainable suffix above the cut and applies each τ step through
the ``masked_update`` kernel (:func:`suffix_masked_sgd`); the probe's
per-layer ‖g‖² goes through the ``layer_grad_norm`` kernel.  Both follow
the tensors' device unless ``Model(kernel_mode="torch")`` forces the plain
versions.  Gradients are taken of the selectable segments only: the
reference differentiates embeddings and head too, then masks them to zero,
which leaves them unchanged — here they are never differentiated.

The streaming scheduler (``core/scheduler.py``) calls the ``*_raw``
variants, which return device tensors and force no device→host copy: host
inputs (masks, sizes) reach the card through pinned memory with
``non_blocking`` copies (:func:`host_to_device`), so a round's kernels can
be queued while earlier ones run.  ``cohort_update``, ``probe_cohort`` and
``evaluate`` materialise their results on the host.
``probe_update_cohort_raw`` is the update followed by the next cohort's
probe on the updated params: the reference fuses them into one XLA
program, here they are queued one after the other (the same math).
``cohort_update_guarded_raw`` is the fault path's round step: the dense
program for every row, then the injected corruption, the finite guard and
the survivor-reweighted Eq.(5)-(7) aggregation (DESIGN.md §12).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import aggregation as agg
from repro_torch.core import masks as M
from repro_torch.core.strategies import PROBE_KEYS
from repro_torch.kernels import ops
from repro_torch.models.model import (Model, _torch_dtype, apply_layer_mask,
                                      layer_layout, segment_prefix_cuts,
                                      split_mask, trainable_rows)
from repro_torch.tree import tree_leaves, tree_map


def suffix_masked_sgd(trainable: dict, grads: dict, mask: torch.Tensor,
                      lr: float, cut: int, cfg, *,
                      mode: Optional[str] = None) -> dict:
    """Fused Eq.(3) apply on the trainable suffix — the masked τ loop's call
    site for the ``masked_update`` kernel: each segment's stacked leaves
    get θ ← θ − η·m(l)·g, out of place, through ``ops.masked_sgd_update``
    (``mode`` forces the kernel or the plain version)."""
    cuts = segment_prefix_cuts(cut, cfg)
    mparts = split_mask(mask, cfg)
    return {path: ops.masked_sgd_update(sub, grads[path],
                                        mparts[path][cuts[path]:], lr,
                                        mode=mode)
            for path, sub in trainable.items()}


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without blocking the host.  On the card
    the array is staged in pinned memory and copied ``non_blocking``
    (PyTorch's pinned allocator keeps the buffer until the copy has run); a
    copy from pageable memory would wait for every kernel already queued.
    On the CPU the tensor shares the array's memory."""
    t = torch.from_numpy(np.require(arr, requirements="C"))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """Device tensors on their way to the host.  On the card each is copied
    into pinned memory ``non_blocking`` behind the work already queued, and
    an event is recorded after the copies: :meth:`to_numpy` waits for that
    event alone, never for kernels queued later, and can run on another
    thread (the scheduler's solver thread).  Host arrays pass through."""

    def __init__(self, tensors: dict):
        self._event = None
        self._host = {}
        for k, v in tensors.items():
            if isinstance(v, torch.Tensor):
                v = v.detach()
                if v.is_cuda:
                    v = torch.empty(v.shape, dtype=v.dtype,
                                    pin_memory=True).copy_(v,
                                                           non_blocking=True)
                    self._event = torch.cuda.Event()
            self._host[k] = v
        if self._event is not None:
            self._event.record()

    def to_numpy(self) -> dict[str, np.ndarray]:
        if self._event is not None:
            # repro: allow[host-sync] -- the sanctioned readback: waits on the event behind this object's own copies, never on later work
            self._event.synchronize()
        # the sanctioned readback: strict mode's CPU guard (a torch-function
        # mode on its thread) flags every other ``.numpy()``
        with torch._C.DisableTorchFunction():
            # repro: allow[host-sync] -- pinned host tensors, already copied behind the event above
            return {k: v.numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in self._host.items()}


# -- program-auditor enumeration hook ---------------------------------------

def audit_batch(cfg, lead: tuple, seq: int, rng: np.random.RandomState,
                device: torch.device) -> dict:
    """A random batch with leading axes ``lead`` (family-aware: vlm
    patches, whisper frames, labels for a classifier) on ``device``."""
    dt = _torch_dtype(cfg.dtype)

    def ints(shape, hi):
        return torch.from_numpy(rng.randint(0, hi, shape).astype(np.int32)
                                ).to(device)

    def floats(shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                ).to(device, dt)
    if cfg.family == "vlm":
        batch = {"patches": floats(lead + (cfg.n_prefix_tokens, cfg.d_model))}
        if cfg.task == "lm":
            batch["tokens"] = ints(lead + (max(seq - cfg.n_prefix_tokens, 4),),
                                   cfg.vocab_size)
        else:
            batch["label"] = ints(lead, cfg.n_classes)
        return batch
    if cfg.family == "audio":
        return {"frames": floats(lead + (cfg.enc_seq, cfg.d_model)),
                "tokens": ints(lead + (seq,), cfg.vocab_size)}
    batch = {"tokens": ints(lead + (seq,), cfg.vocab_size)}
    if cfg.task == "classification":
        batch["label"] = ints(lead, cfg.n_classes)
    return batch


def suite_program_specs(model: Model, *, cohort: int = 2, tau: int = 2,
                        batch: int = 2, seq: int = 16, sel_batches: int = 1,
                        cuts: Optional[tuple] = None) -> list[dict]:
    """Audit specs for every training program family (the reference's
    list): the dense round step, every masked-cut variant (``cuts``
    defaults to all L+1, including the cut=L forward-only program), the
    cohort probe, the probe queued behind the update (dense and one masked
    representative) and the guarded step.

    Eager PyTorch has no abstract lowering, so each entry's ``args`` is a
    zero-argument callable that builds concrete inputs at these sizes on
    the model's device when the auditor (``repro_torch.analysis.program``)
    runs it: params from ``model.init(0)`` (one copy, shared by every
    entry), random tokens from a fixed seed, all-ones masks, equal sizes.
    Plain dicts: core does not import the auditor.
    """
    client = Client(model)
    cfg, dev = model.cfg, model.device
    params = model.init(0)
    L = model.n_selectable
    reqs = ("grad_sq_norms",)
    masks = np.ones((cohort, L), np.float32)
    sizes = np.ones(cohort, np.float32)
    lr = 0.01
    if cuts is None:
        cuts = tuple(range(L + 1))

    def audit_inputs():
        rng = np.random.RandomState(0)
        return (audit_batch(cfg, (cohort, tau, batch), seq, rng, dev),
                audit_batch(cfg, (cohort, sel_batches, batch), seq, rng, dev))

    def update_args(*tail):
        return lambda: (params, audit_inputs()[0], masks, sizes, lr, *tail)

    def probe_update_args(*tail):
        def probe_update_inputs():
            b, pb = audit_inputs()
            return (params, b, masks, sizes, lr, pb, reqs, None, *tail)
        return probe_update_inputs

    # training entries declare no donation: the round's params feed the
    # probe and the sequential oracle too (meta records it, as the
    # reference's do)
    base = dict(donate_argnums=(), weight_argnums=(0,))
    specs = [
        dict(base, name="fl_step", fn=client.cohort_update_raw,
             args=update_args(None),
             meta={"kind": "fl_step", "single_host": True}),
        dict(base, name="probe", fn=client.probe_cohort_raw,
             args=lambda: (params, audit_inputs()[1], reqs, None),
             meta={"kind": "probe", "single_host": True}),
        dict(base, name="probe_update", fn=client.probe_update_cohort_raw,
             args=probe_update_args(None),
             meta={"kind": "probe_update", "single_host": True}),
        # the fault path's one variant: every row survives, none corrupted
        dict(base, name="fl_step_guarded",
             fn=client.cohort_update_guarded_raw,
             args=update_args(np.ones(cohort, np.float32),
                         np.zeros(cohort, np.int32), 1.0, float("inf")),
             meta={"kind": "fl_step_guarded", "single_host": True}),
    ]
    mid = cuts[len(cuts) // 2] if cuts else 0
    for cut in cuts:
        specs.append(dict(
            base, name=f"fl_step_masked/cut{cut}",
            fn=client.cohort_update_raw, args=update_args(int(cut)),
            meta={"kind": "fl_step_masked", "cut": int(cut),
                  "n_selectable": L, "single_host": True}))
    specs.append(dict(
        base, name=f"probe_update_masked/cut{mid}",
        fn=client.probe_update_cohort_raw, args=probe_update_args(int(mid)),
        meta={"kind": "probe_update_masked", "cut": int(mid),
              "single_host": True}))
    return specs


def probe_stats_dict(stats: dict) -> dict[str, np.ndarray]:
    """Materialise a probe result to host numpy."""
    return {k: v.detach().cpu().numpy() for k, v in stats.items()}


def _requires_grad(tree: dict) -> dict:
    """Leaves that autograd differentiates, sharing the given storage."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def _grads(loss: torch.Tensor, wrt: dict) -> dict:
    leaves = tree_leaves(wrt)
    it = iter(torch.autograd.grad(loss, leaves))
    return tree_map(lambda _: next(it), wrt)


def _row(batches: dict, *idx) -> dict:
    return {k: v[idx] for k, v in batches.items()}


class Client:
    """Stateless executor for local training; data is passed per call.

    Batches are dicts of tensors on the model's device; masks and sizes
    are host arrays (the select stage's output).
    """

    def __init__(self, model: Model):
        self.model = model
        self.cfg = model.cfg
        self._kernel_mode = model.kernel_mode
        self._paths = tuple(seg.path for seg in layer_layout(model.cfg))

    def _device_f32(self, x) -> torch.Tensor:
        # x: host masks or sizes (the select stage's numpy output)
        return host_to_device(np.require(x, np.float32), self.model.device)

    # -- Eq. (3)-(4): τ masked SGD steps, return accumulated update ---------
    def _local_update_impl(self, params: dict, batches: dict,
                           mask: torch.Tensor, lr: float):
        """The dense program for one client: every selectable layer is
        differentiated, the gradient masked per layer.  Returns (Δ over
        the selectable segments, mean loss)."""
        model, cfg = self.model, self.cfg
        sel0 = {k: params[k] for k in self._paths}
        sel, losses = sel0, []
        for s in range(next(iter(batches.values())).shape[0]):
            wrt = _requires_grad(sel)
            loss = model.seq_loss({**params, **wrt}, _row(batches, s))
            g = apply_layer_mask(_grads(loss, wrt), mask, cfg)
            sel = tree_map(lambda p, gi: p.detach() - lr * gi, wrt, g)
            losses.append(loss.detach())
        # Δ_i^t = (θ^{t,0} − θ^{t,τ}) / η  = Σ_k Σ_{l∈L_i} g_{i,l}
        delta = tree_map(lambda a, b: (a - b).float() / lr, sel0, sel)
        return delta, torch.stack(losses).mean()

    def local_update(self, params: dict, batches: dict, mask,
                     lr: float) -> tuple[dict, float]:
        """One client's τ steps (batches: dict with a leading τ axis).
        Returns (Δ as a full tree, zero outside the selectable segments,
        mean loss) — the sequential oracle's input to ``aggregate``."""
        delta, loss = self._local_update_impl(params, batches,
                                              self._device_f32(mask), lr)
        full = {k: delta[k] if k in delta else tree_map(
            lambda t: torch.zeros_like(t, dtype=torch.float32), v)
            for k, v in params.items()}
        return full, float(loss)

    def _masked_local_update(self, params: dict, batches: dict,
                             mask: torch.Tensor, lr: float, cut: int):
        """One client's τ steps on the trainable suffix above ``cut``; the
        frozen prefix runs without a graph.  Returns (suffix Δ, mean loss).
        """
        model, cfg = self.model, self.cfg
        tr0 = trainable_rows(params, cut, cfg)
        tr, losses = tr0, []
        for s in range(next(iter(batches.values())).shape[0]):
            wrt = _requires_grad(tr)
            loss = model.seq_loss(params, _row(batches, s), trainable=wrt,
                                  cut=cut)
            g = _grads(loss, wrt)
            tr = suffix_masked_sgd(tree_map(torch.Tensor.detach, wrt), g,
                                   mask, lr, cut, cfg,
                                   mode=self._kernel_mode)
            losses.append(loss.detach())
        delta = tree_map(lambda a, z: (a - z).float() / lr, tr0, tr)
        return delta, torch.stack(losses).mean()

    def _stacked_deltas(self, client_update, n: int):
        """Run ``client_update(i) -> (Δ_i, loss_i)`` client by client into
        stacked (n, …) f32 leaves; only one client's graph is alive at a
        time."""
        stacked, losses = None, []
        for i in range(n):
            delta, loss = client_update(i)
            if stacked is None:
                stacked = tree_map(lambda d: torch.empty(
                    (n,) + tuple(d.shape), dtype=d.dtype, device=d.device),
                    delta)
            tree_map(lambda s, d, i=i: s[i].copy_(d), stacked, delta)
            losses.append(loss)
            del delta
        return stacked, torch.stack(losses)

    def cohort_update_raw(self, params: dict, batches: dict, masks, sizes,
                          lr: float, cut: Optional[int] = None
                          ) -> tuple[dict, torch.Tensor]:
        """One round step for the whole cohort: τ local steps per client,
        then Eq.(5)-(7) aggregation and the Eq.(6) apply; nothing is copied
        back to the host.

        batches: leaves with leading (cohort, τ) axes; masks: (cohort, L);
        sizes: (cohort,) client dataset sizes d_i.  ``cut=None`` runs the
        dense program (every selectable layer differentiated); an integer
        cut runs the mask-aware program for that frozen-prefix depth, and a
        cut of L (no layer selected) only computes forward losses.
        Returns (new global params, per-client mean local losses on the
        device).
        """
        with tracing.span("update", device=self.model.device):
            cfg = self.cfg
            mt = self._device_f32(masks)
            n = mt.shape[0]
            if cut is not None and cut >= self.model.n_selectable:
                with torch.no_grad():
                    tau = next(iter(batches.values())).shape[1]
                    losses = torch.stack([torch.stack([
                        self.model.seq_loss(params, _row(batches, i, s))
                        for s in range(tau)]).mean() for i in range(n)])
                return params, losses
            # Eq. 7
            weights = M.aggregation_weights(mt, self._device_f32(sizes))
            if cut is None:
                deltas, losses = self._stacked_deltas(
                    lambda i: self._local_update_impl(
                        params, _row(batches, i), mt[i], lr), n)
                update = agg.aggregate_stacked(deltas, weights, cfg)
                del deltas
                new_params = agg.apply_suffix_update(params, update, lr, 0,
                                                     cfg)
            else:
                deltas, losses = self._stacked_deltas(
                    lambda i: self._masked_local_update(
                        params, _row(batches, i), mt[i], lr, cut), n)
                update = agg.aggregate_suffix(deltas, weights, cut, cfg)
                del deltas
                new_params = agg.apply_suffix_update(params, update, lr,
                                                     cut, cfg)
            return new_params, losses

    def cohort_update(self, params: dict, batches: dict, masks, sizes,
                      lr: float, cut: Optional[int] = None
                      ) -> tuple[dict, np.ndarray]:
        """:meth:`cohort_update_raw` with the losses on the host."""
        new_params, losses = self.cohort_update_raw(params, batches, masks,
                                                    sizes, lr, cut)
        return new_params, losses.cpu().numpy()

    # -- fault-guarded cohort round: survivor reweighting + finite guard ----
    def cohort_update_guarded_raw(self, params: dict, batches: dict, masks,
                                  sizes, lr: float, survivors, codes,
                                  explode_scale, max_delta_sq
                                  ) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """The fault path's round step, nothing copied to the host: the
        dense program for every row (dead rows too, as the reference
        computes them), then the injected corruption (``codes``, host
        int32), the finite guard, the dead and quarantined rows zeroed in
        place, and Eq.(5)-(7) with the sizes of those rows zeroed.  A
        no-fault call (survivors 1, codes 0) computes exactly
        ``cohort_update_raw(cut=None)``'s params; a layer all of whose
        selectors died gets weight 0 and passes through (θ − η·0 = θ).

        Returns ``(new_params, losses, ok)``: ``ok`` (n,) f32 on the device
        marks the rows that aggregated (alive, finite and under
        ``max_delta_sq``).
        """
        with tracing.span("update", device=self.model.device):
            cfg = self.cfg
            mt = self._device_f32(masks)
            deltas, losses = self._stacked_deltas(
                lambda i: self._local_update_impl(params, _row(batches, i),
                                                  mt[i], lr), mt.shape[0])
            agg.corrupt_delta_rows(deltas, codes, explode_scale)
            ok = agg.finite_row_mask(deltas, max_delta_sq) \
                * self._device_f32(survivors)
            agg.zero_delta_rows(deltas, ok)
            weights = M.aggregation_weights(mt,
                                            self._device_f32(sizes) * ok)
            update = agg.aggregate_stacked(deltas, weights, cfg)
            del deltas
            new_params = agg.apply_suffix_update(params, update, lr, 0, cfg)
            return new_params, losses, ok

    def cohort_update_guarded(self, params: dict, batches: dict, masks, sizes,
                              lr: float, survivors, codes, explode_scale,
                              max_delta_sq
                              ) -> tuple[dict, np.ndarray, np.ndarray]:
        """:meth:`cohort_update_guarded_raw` with losses and ``ok`` on the
        host: one wait, for their copy."""
        new_params, losses, ok = self.cohort_update_guarded_raw(
            params, batches, masks, sizes, lr, survivors, codes,
            explode_scale, max_delta_sq)
        # repro: allow[host-sync] -- fault accounting is a sanctioned round-boundary sync (DESIGN.md §12)
        host = HostCopy({"losses": losses, "ok": ok}).to_numpy()
        return new_params, host["losses"], host["ok"]

    # -- selection probe: layer-wise gradient stats on one batch ------------
    def _probe_one(self, params: dict, batch: dict,
                    reqs: tuple = PROBE_KEYS) -> dict[str, torch.Tensor]:
        """Gradient stats for one batch, trimmed to the requested keys:
        ``ours`` needs ‖g_l‖² only (the ``layer_grad_norm`` kernel), SNR
        mean and variance, RGN also ‖θ_l‖².  The probe is dense over all L
        layers: next round's selection needs every layer's utility."""
        cfg = self.cfg
        out: dict[str, torch.Tensor] = {}
        if {"grad_sq_norms", "grad_means", "grad_vars"} & set(reqs):
            wrt = _requires_grad({k: params[k] for k in self._paths})
            g = _grads(self.model.seq_loss({**params, **wrt}, batch), wrt)
            if "grad_means" in reqs or "grad_vars" in reqs:
                sq, mean, var = M.layer_grad_stats(g, cfg)
                out.update(grad_sq_norms=sq, grad_means=mean, grad_vars=var)
            else:
                out["grad_sq_norms"] = M.per_layer_sq_norms(
                    g, cfg, mode=self._kernel_mode)
        if "param_sq_norms" in reqs:
            out["param_sq_norms"] = M.per_layer_param_sq_norms(
                params, cfg, mode=self._kernel_mode)
        return {k: v for k, v in out.items() if k in reqs}

    def probe(self, params: dict, batch: dict,
              reqs: tuple = PROBE_KEYS) -> dict[str, np.ndarray]:
        return probe_stats_dict(self._probe_one(params, batch, tuple(reqs)))

    def probe_cohort_raw(self, params: dict, batches: dict,
                         reqs: tuple = PROBE_KEYS,
                         score_fn=None) -> dict[str, torch.Tensor]:
        """The probe for a whole cohort: batches with leading (cohort,
        selection_batches) axes.  Returns (cohort, L) device tensors for the
        requested keys, each the mean over the selection batches, plus
        ``"scores"`` when a strategy's device ``score_fn`` is given (applied
        to the meaned stats on the device)."""
        with tracing.span("probe", device=self.model.device):
            n, nb = next(iter(batches.values())).shape[:2]
            rows = []
            for i in range(n):
                outs = [self._probe_one(params, _row(batches, i, b),
                                        tuple(reqs)) for b in range(nb)]
                rows.append({k: torch.stack([o[k] for o in outs]).mean(0)
                             for k in outs[0]})
            stats = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
            if score_fn is not None:
                stats = dict(stats, scores=score_fn(stats))
            return stats

    def probe_cohort(self, params: dict, batches: dict,
                     reqs: tuple = PROBE_KEYS,
                     score_fn=None) -> dict[str, np.ndarray]:
        """:meth:`probe_cohort_raw` materialised to host numpy."""
        return probe_stats_dict(self.probe_cohort_raw(params, batches, reqs,
                                                      score_fn))

    def probe_update_cohort_raw(self, params: dict, batches: dict, masks,
                                sizes, lr: float, probe_batches: dict,
                                reqs: tuple = PROBE_KEYS, score_fn=None,
                                cut: Optional[int] = None
                                ) -> tuple[dict, torch.Tensor, dict]:
        """The cohort update, then the next cohort's probe on the updated
        params (the probe stays dense: selection needs every layer's
        utility).  Returns (new params, losses, stats), device tensors —
        the same math as :meth:`cohort_update_raw` followed by
        :meth:`probe_cohort_raw`."""
        new_params, losses = self.cohort_update_raw(params, batches, masks,
                                                    sizes, lr, cut)
        stats = self.probe_cohort_raw(new_params, probe_batches, reqs,
                                      score_fn)
        return new_params, losses, stats

    # -- evaluation -----------------------------------------------------------
    @torch.no_grad()
    def evaluate_raw(self, params: dict, batch: dict
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """One forward for both loss and accuracy, as device scalars: the
        hidden state feeds the loss tail and, for labelled batches, the
        accuracy logits (0 without labels)."""
        with tracing.span("eval", device=self.model.device):
            model = self.model
            h, aux, prefix_len = model.hidden_seq(params, batch)
            loss = model.loss_from_hidden(params, h, aux, prefix_len, batch)
            if "label" not in batch:
                return loss, torch.zeros((), device=loss.device)
            logits = model._head(params, h.mean(1)[:, None])[:, 0]
            acc = (logits.argmax(-1) == batch["label"].long()).float().mean()
            return loss, acc

    def evaluate(self, params: dict, batch: dict) -> tuple[float, float]:
        loss, acc = self.evaluate_raw(params, batch)
        return loss.item(), acc.item()
