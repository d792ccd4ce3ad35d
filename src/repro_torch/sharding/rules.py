"""Parameter / batch / cache partition rules for the mesh (counterpart of
``repro/sharding/rules.py``).

Mesh axes: ``('data', 'model')`` single-pod, ``('pod', 'data', 'model')``
multi-pod.  The *client* axes (pod×data) carry the FL cohort — one client
per (pod, data) coordinate — and ``data`` doubles as the ZeRO-3 storage
axis for the frozen model base.  The rules are the reference's, name-based
over the stacked-parameter layout, and return a :class:`Spec` of the
leaf's rank.

A spec names ``model`` where the reference lays tensor parallelism, and
the port keeps those entries, so its specs equal the reference's leaf by
leaf.  With tensor parallelism off (``RuntimeConfig(tp_constraints=
False)``) a rank stores the slice of a leaf along the client axes of its
spec and holds it whole over ``model`` (:func:`local_shard`), as the
reference's fully manual fallback does.  With it on, for the language
models of the dense, vlm, ssm, hybrid, moe and audio families, a rank
stores the slice its spec gives, ``model`` included (:class:`TPLayout`,
:func:`tp_local_shard`), and computes its share of each layer
(``sharding/tensor_parallel.py``); :func:`attention_mode` says how a
config's heads split.  :func:`cache_specs` stays the reference's; a
tensor-parallel decode keeps each rank's kv heads whole over the
sequence (whisper's cross cache too), its Mamba2 conv channels in its own
order and MLA's latent rows whole on every rank instead
(:func:`tp_shard_cache`), a layout difference with the same values.  The
moe experts' activation constraints (the reference's ``make_shard_hook``)
are the experts' split itself (:meth:`TPLayout.experts`).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import dense0_ff
from repro_torch.tree import tree_map_with_path

PyTree = Any

DATA = "data"     # ZeRO-3 / client axis
MODEL = "model"   # tensor-parallel axis
CLIENT = ("pod", DATA)


class Spec(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry per
    dim, each None, an axis name or a tuple of names; a 1-tuple entry is
    its name, as ``PartitionSpec`` normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _divisible(n: int, axis_size: int) -> bool:
    return axis_size > 0 and n % axis_size == 0


_SUBBLOCK_PREFIXES = ("attn_", "xattn_", "mlp_", "moe_", "ssm_")


def param_spec(path: tuple[str, ...], leaf, cfg: ArchConfig, *,
               zero3: bool, mesh_shape: dict[str, int]) -> Spec:
    """Spec for one parameter leaf (stacked or not); ``leaf`` needs only
    ``.shape`` (ref ``param_spec``)."""
    name = path[-1]
    for pref in _SUBBLOCK_PREFIXES:      # stacked blocks prefix their leaves
        if name.startswith(pref):
            name = name[len(pref):]
            break
    group = path[0]
    shape = tuple(leaf.shape)
    dsz, msz = mesh_shape.get(DATA, 1), mesh_shape.get(MODEL, 1)

    stacked = group in ("blocks", "enc_blocks", "dense0")
    off = 1 if stacked else 0          # leading (L,) axis never sharded

    def spec(*dims):
        full = [None] * off + list(dims)
        full += [None] * (len(shape) - len(full))
        # drop axes that do not divide (tuple entries: product must divide)
        out = []
        for dim, ax in zip(shape, full):
            if isinstance(ax, tuple):
                size = math.prod(mesh_shape.get(a, 1) for a in ax)
                if not _divisible(dim, size):
                    ax = tuple(a for a in ax if a == MODEL) or None
                    if isinstance(ax, tuple):
                        ax = ax[0] if _divisible(dim, msz) else None
            elif ax == DATA and not _divisible(dim, dsz):
                ax = None
            elif ax == MODEL and not _divisible(dim, msz):
                ax = None
            out.append(ax)
        return Spec(*out)

    # the ZeRO-3 ('data') axis is co-located with 'model' on the tensor-
    # parallel dim: contraction dims stay unsharded (ref rules.py:71-75)
    tp = (MODEL, DATA) if zero3 else MODEL

    # --- embeddings / head --------------------------------------------------
    if group == "embed":
        if name == "tok":
            return spec(tp, None)                  # (V, d)
        return spec(None, tp)                      # projectors (d, d)
    if group == "head":
        return spec(None, tp)                      # (d, V) or (d, classes)
    if group in ("final_norm", "enc_norm"):
        return Spec(None)

    # --- attention (column: qkv — row: wo, both on the H·hd dim) -----------
    if name in ("wq", "wk", "wv", "w_dkv", "w_krope"):
        return spec(None, tp)                      # (…, d, H·hd)
    if name == "w_ukv":
        return spec(None, tp)                      # (…, lora, H·(nope+v))
    if name == "wo":
        return spec(tp, None)                      # (…, H·hd, d)
    if name in ("bq", "bk", "bv"):
        return spec(MODEL)

    # --- dense MLP (column: wi — row: wo, both on the ff dim) ----------------
    if name == "wi" or name == "wi_s":
        return spec(None, tp)                      # (…, d, 2ff)
    if name == "wo" or name == "wo_s":
        return spec(tp, None)                      # (…, ff, d)

    # --- MoE ------------------------------------------------------------------
    if name == "router":
        return spec(None, None)                    # (…, d, E)
    if name == "wi_e":                             # (…, E, d, F)
        if _divisible(cfg.n_experts, msz):
            return spec(MODEL, None, DATA if zero3 else None)
        return spec(None, None, tp)
    if name == "wo_e":                             # (…, E, F, d)
        if _divisible(cfg.n_experts, msz):
            return spec(MODEL, DATA if zero3 else None, None)
        return spec(None, tp, None)

    # --- SSM --------------------------------------------------------------------
    if name == "in_proj":
        return spec(None, tp)                      # (…, d, zxbcdt)
    if name == "out_proj":
        return spec(tp, None)                      # (…, d_in, d)
    if name == "conv_w":
        return spec(None, MODEL)                   # (…, K, conv_dim)
    if name == "conv_b":
        return spec(MODEL)

    # small vectors (ln / dt_bias / A_log / D / gate_ln / kv_ln)
    return Spec(*([None] * len(shape)))


def params_pytree_specs(cfg: ArchConfig, params_shapes: PyTree, *,
                        zero3: bool, mesh_shape: dict[str, int]) -> PyTree:
    """:func:`param_spec` over a nested dict of leaves with ``.shape``
    (tensors, meta tensors), same paths."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, cfg, zero3=zero3,
                                      mesh_shape=mesh_shape), params_shapes)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def client_axes(mesh) -> tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n in CLIENT)


def n_clients(mesh) -> int:
    """Clients on the mesh: the product of its client axes."""
    return math.prod(mesh.shape[a] for a in client_axes(mesh))


def batch_spec_train(mesh) -> Spec:
    """FL training batch (clients, per_client, seq): clients over pod×data."""
    return Spec(client_axes(mesh))


def batch_spec_serve(mesh, batch: int) -> Spec:
    """Inference batch dim over the client axes when divisible."""
    ca = client_axes(mesh)
    return Spec(ca) if batch % n_clients(mesh) == 0 else Spec(None)


def cache_specs(cfg: ArchConfig, cache_shapes: PyTree, mesh,
                batch: int) -> PyTree:
    """KV/state cache specs: batch over client axes, heads-or-seq over model."""
    msz = mesh.shape[MODEL]
    ca = client_axes(mesh)
    b_ax = ca if batch % n_clients(mesh) == 0 else None

    def spec_for(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        # layouts: kv (L,B,W,K,hd) | pos (L,W) | mla ckv (L,B,W,lora)
        # ssm conv (L,B,K-1,Cd) | ssm state (L,B,H,P,N) | shared (G,B,W,K,hd)
        if name == "pos":
            return Spec(*([None] * len(shape)))
        if name in ("k", "v"):
            L_, B_, W_, K_, hd_ = shape
            kv_ax = MODEL if _divisible(K_, msz) else None
            w_ax = MODEL if kv_ax is None and _divisible(W_, msz) else None
            return Spec(None, b_ax, w_ax, kv_ax, None)
        if name == "ckv" or name == "krope":
            L_, B_, W_, R_ = shape
            r_ax = MODEL if _divisible(R_, msz) else None
            return Spec(None, b_ax, None, r_ax)
        if name == "conv":
            return Spec(None, b_ax, None,
                        MODEL if _divisible(shape[-1], msz) else None)
        if name == "state":
            L_, B_, H_, P_, N_ = shape
            h_ax = MODEL if _divisible(H_, msz) else None
            return Spec(None, b_ax, h_ax, None, None)
        return Spec(*([None] * len(shape)))

    return tree_map_with_path(spec_for, cache_shapes)


def zero3_gather_axis(spec: Spec) -> Optional[int]:
    """Index of the client/ZeRO axis in a param spec (None if replicated)."""
    for i, entry in enumerate(spec):
        if DATA in _names(entry):
            return i
    return None


# ---------------------------------------------------------------------------
# Storage: a full leaf and this rank's shard
# ---------------------------------------------------------------------------

def shard_dim(spec: Spec) -> tuple[Optional[int], tuple[str, ...]]:
    """(dim, client axes) along which a leaf of ``spec`` is stored split
    over the mesh, or (None, ()) for a replicated leaf.  ``model`` entries
    are dropped: a shard is whole over ``model``."""
    for i, entry in enumerate(spec):
        names = tuple(a for a in _names(entry) if a in CLIENT)
        if names:
            return i, names
    return None, ()


def without_client_axes(spec: Spec) -> Spec:
    """``spec`` with its client-axis entries dropped: a leaf stored whole
    on every rank."""
    return Spec(*(None if set(_names(e)) & set(CLIENT) else e
                  for e in spec))


def local_shard(leaf: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's storage of a full ``leaf``: its slice along the spec's
    client-axis dim (a view), or the leaf itself when replicated."""
    dim, axes = shard_dim(spec)
    if dim is None:
        return leaf
    n = mesh.size(axes)
    size = leaf.shape[dim] // n
    return leaf.narrow(dim, mesh.index(axes) * size, size)


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """:func:`local_shard` leaf by leaf, same paths."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return local_shard(tree, specs, mesh)


# ---------------------------------------------------------------------------
# Tensor parallelism over 'model' (RuntimeConfig(tp_constraints=True))
# ---------------------------------------------------------------------------

TP_FAMILIES = ("dense", "vlm", "ssm", "hybrid", "moe", "audio")


def check_tp_family(cfg: ArchConfig) -> None:
    """Tensor parallelism over ``model`` is ported for the language models
    of the dense, vlm, ssm, hybrid, moe and audio families (whisper's
    decoder is one: ``task == "lm"``); the classifiers (CLIP of the vlm
    family, XLM-R of the dense one) raise, naming their family, name and
    task: neither package splits a pooled classification head."""
    if cfg.family not in TP_FAMILIES or cfg.task != "lm":
        raise ValueError(
            f"RuntimeConfig(tp_constraints=True): tensor parallelism over "
            f"the 'model' axis is ported for the language models of the "
            f"dense, vlm, ssm, hybrid, moe and audio families, not for the "
            f"{cfg.family!r} family's classifier {cfg.name} (task "
            f"{cfg.task!r}) (ROADMAP.md)")


def attention_mode(cfg: ArchConfig, msz: int) -> str:
    """How attention splits over a ``model`` axis of ``msz`` ranks (H query
    heads, K kv heads of ``hd``):

    * ``"heads"`` when M divides H and K: a rank computes H/M query heads
      and their K/M kv heads (every mode at M = 1; whisper-medium's 16
      and 16 at 2 to 16, one head a rank at 16, in self- and
      cross-attention alike); MLA (DeepSeek) when M
      divides H alone: a rank computes H/M heads of ``wq``, of the
      ``w_ukv`` expansion and of ``wo``, and the latent (``w_dkv``,
      ``w_krope``, ``kv_ln``), which every head reads, whole;
    * ``"kv_shared"`` when M divides H and K divides M (and K·hd): a rank
      computes H/M query heads, all of one kv head, whose ``wk`` / ``wv``
      columns it all-gathers over ``model`` (PaliGemma's one kv head at 2,
      4 and 8; reduced whisper's 4 over 2 at 4);
    * ``"replicated"`` otherwise (SmolLM's 15 heads, PaliGemma's 8 at
      16): attention runs whole on every rank, its leaves all-gathered
      over ``model``; only the MLP or the experts, the embedding and the
      head are split.
    """
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.use_mla:
        return "heads" if H % msz == 0 else "replicated"
    if H % msz == 0 and K % msz == 0:
        return "heads"
    if H % msz == 0 and msz % K == 0 and (K * hd) % msz == 0:
        return "kv_shared"
    return "replicated"


class TPLayout:
    """A model's storage and compute under tensor parallelism over a
    ``model`` axis of ``size`` ranks: the dense and vlm families' blocks,
    the ssm and hybrid families' Mamba2 blocks, the hybrid's shared block,
    which splits as a dense block, the moe family's blocks and
    ``dense0``, their attention MLA or GQA, and whisper's encoder rows
    (``enc_blocks``) and decoder rows, whose cross-attention (``xattn_``)
    splits as their self-attention.

    Storage (:func:`tp_local_shard`): a rank holds the slice of each leaf
    that its spec gives, ``model`` included; a tuple entry ``(model,
    data)`` is model-major, data-minor, as ``PartitionSpec`` lays it, so a
    gather over ``data`` within model coordinate m yields model slice m.
    Leaves packed from pieces on their last dim are reordered first
    (:meth:`to_storage_order`) so that model slice m is the m-th part of
    every piece side by side: a gated ``mlp_wi`` (gate | up, ``dense0``'s
    too) as gate[:, m] | up[:, m], the halves ``blocks.mlp_fwd`` splits,
    and so the shared experts' ``moe_wi_s`` and, split on ff, the routed
    experts' ``moe_wi_e``; a Mamba2 ``ssm_in_proj`` (z | x | B | C | dt)
    as z_m | x_m | B_m | C_m | dt_m, and ``ssm_conv_w`` / ``ssm_conv_b``
    (x | B | C) as x_m | B_m | C_m.  ``wk`` / ``wv`` keep the contiguous
    split; under ``"kv_shared"`` a model slice is a part of one kv head,
    and the step all-gathers them over ``model``
    (``sharding/tensor_parallel.py``), as it does every B_m | C_m.  MLA's
    head-major leaves keep the contiguous split too, which is whole heads
    where ``size`` divides H: ``wq`` (H·(nope + rope)), ``w_ukv``
    (H·(nope + v), each head's [nope | v] side by side) and ``wo``'s rows
    (H·v); its latent projections ``w_dkv`` / ``w_krope`` are stored
    split by their spec and all-gathered over ``model`` whole, as are the
    vlm projector ``patch_proj`` and whisper's ``frame_proj``.  A plain
    (not gated) ``mlp_wi`` (whisper's GELU MLP) keeps the contiguous
    split, which is the rank's columns already.

    Compute (:meth:`compute_slice`): model coordinate m computes query
    heads :meth:`q_heads` and kv heads :meth:`kv_heads` (all of them under
    ``"replicated"``; an MLA head's width taken per leaf, its latent
    whole), in whisper's cross-attention as in its self-attention
    (``xattn_wq`` / ``wk`` / ``wv`` by heads on the last dim, ``xattn_wo``
    on its rows, ``xattn_ln`` whole), the m-th 1/size of each MLP's
    columns
    (``d_ff`` wide, ``dense0``'s ``d_ff · (top_k + n_shared_experts)``,
    the shared experts' ``d_ff · n_shared_experts``), the SSD heads
    :meth:`ssm_heads` with their ``d_inner / size`` channels of z and x
    and all of B and C, and, where the spec of ``embed.tok`` names
    ``model`` (``vocab_split``: the vocabulary divides), the vocabulary
    rows ``[m·V/size, (m+1)·V/size)``; else the embedding and the head are
    whole on every rank.  The routed experts split as the reference's
    ``make_shard_hook`` pins their buffers: by expert where ``size``
    divides ``n_experts`` (``expert_parallel``: the rank's
    :meth:`experts`, whole), else on ff (every expert, its ``d_ff /
    size`` columns m).  The routers stay whole on every rank.  A split
    width that does not divide by ``size`` raises.
    """

    def __init__(self, cfg: ArchConfig, size: int):
        check_tp_family(cfg)
        self.moe = cfg.family == "moe"
        self.expert_parallel = self.moe and cfg.n_experts % size == 0
        # the split widths: expert-parallel experts are whole on a rank
        widths = {} if self.expert_parallel else {"d_ff": cfg.d_ff}
        if self.moe and cfg.n_shared_experts:
            widths["d_ff·n_shared_experts"] = cfg.d_ff * cfg.n_shared_experts
        if self.moe and cfg.first_dense:
            widths["dense0's d_ff·(top_k + n_shared_experts)"] = \
                dense0_ff(cfg)
        for what, n in widths.items():
            if n % size:
                raise ValueError(
                    f"tensor parallelism over 'model' of {size}: "
                    f"{cfg.name}'s {what} {n} does not divide")
        self.ssm = cfg.family in ("ssm", "hybrid")
        if self.ssm:
            H, GN = cfg.resolved_ssm_heads, cfg.ssm_groups * cfg.ssm_state
            if H % size or GN % size:
                raise ValueError(
                    f"tensor parallelism over 'model' of {size}: {cfg.name}'s"
                    f" ssm_heads {H} and ssm_groups·ssm_state {GN} must both "
                    f"divide by it")
        self.cfg, self.size = cfg, size
        # Mamba2 alone has no attention (n_heads 0): nothing to split
        self.mode = attention_mode(cfg, size) if cfg.n_heads else "heads"
        self.gated = cfg.mlp_act != "gelu_plain"
        # split the vocabulary where the spec of embed.tok names 'model'
        tok = torch.empty((cfg.vocab_size, cfg.d_model), device="meta")
        self.vocab_split = model_dim(param_spec(
            ("embed", "tok"), tok, cfg, zero3=False,
            mesh_shape={MODEL: size})) is not None

    def q_heads(self, m: int) -> tuple[int, int]:
        """(first, count) of the query heads model coordinate m computes."""
        H = self.cfg.n_heads
        if self.mode == "replicated":
            return 0, H
        return m * (H // self.size), H // self.size

    def kv_heads(self, m: int) -> tuple[int, int]:
        """(first, count) of the kv heads model coordinate m computes."""
        H, K = self.cfg.n_heads, self.cfg.n_kv_heads
        if self.cfg.use_mla:             # MLA's kv heads are its heads
            return self.q_heads(m)
        if self.mode == "heads":
            return m * (K // self.size), K // self.size
        if self.mode == "kv_shared":
            return self.q_heads(m)[0] // (H // K), 1
        return 0, K

    def experts(self, m: int) -> tuple[int, int]:
        """(first, count) of the routed experts model coordinate m
        computes: its E/size whole experts when ``expert_parallel``, else
        every expert (on its share of ff)."""
        E = self.cfg.n_experts
        if self.expert_parallel:
            return m * (E // self.size), E // self.size
        return 0, E

    def ssm_heads(self, m: int) -> tuple[int, int]:
        """(first, count) of the SSD heads model coordinate m computes."""
        n = self.cfg.resolved_ssm_heads // self.size
        return m * n, n

    def ssm_widths(self) -> tuple[int, int, int]:
        """(d_inner, ssm_groups·ssm_state, ssm_heads) of the whole block."""
        cfg = self.cfg
        return (cfg.d_inner, cfg.ssm_groups * cfg.ssm_state,
                cfg.resolved_ssm_heads)

    def _pieces(self, path: tuple, n: int) -> Optional[list]:
        """Widths of the pieces packed on the last dim (``n`` wide) of the
        leaf at ``path`` that storage reorders, or None."""
        if self.size == 1:
            return None
        if self.gated and (path[-1] in ("mlp_wi", "moe_wi_s") or (
                path[-1] == "moe_wi_e" and not self.expert_parallel)):
            return [n // 2, n // 2]
        if self.ssm and path[-1] in ("ssm_in_proj", "ssm_conv_w",
                                     "ssm_conv_b"):
            di, gn, h = self.ssm_widths()
            return ([di, di, gn, gn, h] if path[-1] == "ssm_in_proj"
                    else [di, gn, gn])
        return None

    def _order(self, pieces: list, inverse: bool) -> np.ndarray:
        starts = np.cumsum([0] + pieces[:-1])
        order = np.concatenate([
            np.r_[s + m * (w // self.size):s + (m + 1) * (w // self.size)]
            for m in range(self.size) for s, w in zip(starts, pieces)])
        return np.argsort(order) if inverse else order

    def _take_last(self, leaf, order: np.ndarray):
        if isinstance(leaf, torch.Tensor):
            return leaf.index_select(
                leaf.dim() - 1, torch.as_tensor(order, device=leaf.device))
        return np.asarray(leaf)[..., order]

    def to_storage_order(self, path: tuple, leaf):
        """A full leaf (tensor or array) in its storage order."""
        pieces = self._pieces(path, leaf.shape[-1])
        if pieces is None:
            return leaf
        return self._take_last(leaf, self._order(pieces, False))

    def from_storage_order(self, path: tuple, leaf):
        """The inverse of :meth:`to_storage_order`."""
        pieces = self._pieces(path, leaf.shape[-1])
        if pieces is None:
            return leaf
        return self._take_last(leaf, self._order(pieces, True))

    def compute_slice(self, name: str, row, m: int):
        """What model coordinate m computes with of one full row's leaf
        ``name`` (``attn_wq``, ``xattn_wk``, ``mlp_wi``, ``ssm_in_proj``,
        ``moe_wi_e``, …, of a ``blocks``, ``enc_blocks`` or ``dense0`` row
        or of the hybrid's shared block): the parallel form's weights, as
        the step's gathers leave them."""
        if name in ("attn_ln", "xattn_ln", "mlp_ln", "ssm_ln", "moe_ln",
                    "moe_router"):
            return row
        if name.startswith("ssm_"):
            return self._ssm_slice(name[len("ssm_"):], row, m)
        if name.startswith(("attn_", "xattn_")):
            leaf = name.split("_", 1)[1]
            if self.mode == "replicated" or leaf in self.LATENT:
                return row
            hd = self.head_width(leaf)
            first, n = (self.kv_heads(m) if leaf in ("wk", "wv", "bk", "bv")
                        else self.q_heads(m))
            dim = 0 if leaf == "wo" else row.dim() - 1
            return row.narrow(dim, first * hd, n * hd)
        if self.expert_parallel and name in ("moe_wi_e", "moe_wo_e"):
            return row.narrow(0, *self.experts(m))
        if name in ("mlp_wi", "moe_wi_s", "moe_wi_e"):   # column-parallel
            if not self.gated:
                w = row.shape[-1] // self.size
                return row[..., m * w:(m + 1) * w]
            ff = row.shape[-1] // 2
            w = ff // self.size
            return torch.cat([row[..., m * w:(m + 1) * w],
                              row[..., ff + m * w:ff + (m + 1) * w]], -1)
        if name in ("mlp_wo", "moe_wo_s", "moe_wo_e"):   # row-parallel
            dim = row.dim() - 2                        # the ff rows
            w = row.shape[dim] // self.size
            return row.narrow(dim, m * w, w)
        raise ValueError(f"no tensor-parallel slice for {name!r}")

    # MLA's latent leaves: every head reads them, so no rank splits them
    LATENT = ("w_dkv", "w_krope", "kv_ln")

    def head_width(self, leaf: str) -> int:
        """One head's width in an attention leaf (``wq``, ``wo``, …,
        without ``attn_``): ``resolved_head_dim``, or MLA's per leaf —
        ``wq`` nope + rope, ``w_ukv`` nope + v, ``wo`` v."""
        cfg = self.cfg
        if not cfg.use_mla:
            return cfg.resolved_head_dim
        return {"wq": cfg.qk_nope_dim + cfg.qk_rope_dim,
                "w_ukv": cfg.qk_nope_dim + cfg.v_head_dim,
                "wo": cfg.v_head_dim}[leaf]

    def _ssm_slice(self, leaf: str, row, m: int):
        di, gn, _ = self.ssm_widths()
        dm, (h0, hm) = di // self.size, self.ssm_heads(m)
        if leaf == "in_proj":                      # z_m | x_m | B | C | dt_m
            dt0 = 2 * di + 2 * gn + h0
            return torch.cat([row[..., m * dm:(m + 1) * dm],
                              row[..., di + m * dm:di + (m + 1) * dm],
                              row[..., 2 * di:2 * di + 2 * gn],
                              row[..., dt0:dt0 + hm]], -1)
        if leaf in ("conv_w", "conv_b"):           # x_m | B | C
            return torch.cat([row[..., m * dm:(m + 1) * dm],
                              row[..., di:]], -1)
        if leaf in ("out_proj", "gate_ln"):        # the rank's channels
            return row[m * dm:(m + 1) * dm]
        if leaf in ("A_log", "D", "dt_bias"):      # the rank's heads
            return row[h0:h0 + hm]
        raise ValueError(f"no tensor-parallel slice for 'ssm_{leaf}'")


def model_dim(spec: Spec) -> Optional[int]:
    """Index of the spec's ``model`` entry (None if whole over model)."""
    for i, entry in enumerate(spec):
        if MODEL in _names(entry):
            return i
    return None


def tp_local_shard(leaf, spec: Spec, mesh, layout: TPLayout,
                   path: tuple = ()):
    """This rank's storage of a full ``leaf`` (tensor or array) under
    tensor parallelism: after :meth:`TPLayout.to_storage_order`, its block
    along every dim whose spec entry names a client axis or ``model``
    (expert-parallel ``moe_wi_e`` / ``moe_wo_e``: the experts over
    ``model`` and ff over ``data``)."""
    leaf = layout.to_storage_order(path, leaf)
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in _names(entry) if a in CLIENT or a == MODEL)
        if not axes:
            continue
        size = leaf.shape[dim] // mesh.size(axes)
        start = mesh.index(axes) * size
        leaf = leaf[(slice(None),) * dim + (slice(start, start + size),)]
    return leaf


def tp_shard_tree(tree: PyTree, specs: PyTree, mesh, layout: TPLayout,
                  path: tuple = ()) -> PyTree:
    """:func:`tp_local_shard` leaf by leaf, same paths."""
    if isinstance(tree, dict):
        return {k: tp_shard_tree(v, specs[k], mesh, layout, path + (k,))
                for k, v in tree.items()}
    return tp_local_shard(tree, specs, mesh, layout, path)


def tp_shard_cache(cache: PyTree, c_specs: PyTree, mesh,
                   layout: TPLayout) -> PyTree:
    """This rank's decode cache under tensor parallelism: the batch rows
    of :func:`shard_tree` by ``c_specs`` (:func:`cache_specs`, the
    reference's), then of each ``k`` / ``v`` leaf (L, B, W, K, hd) the kv
    heads the rank computes (:meth:`TPLayout.kv_heads`), whole over W:
    whisper's ``cross_kv`` (L, B, enc_seq, K, hd) too, which is the
    reference's split of it on K (under ``"kv_shared"`` the rank's one
    kv head, which the reference's rule, K not dividing, would split on
    enc_seq instead); of
    a Mamba2 ``conv`` leaf (L, B, K−1, x | B | C) the rank's channels of x
    and all of B | C, and of a ``state`` leaf (L, B, H, P, N) its SSD
    heads; MLA's latent ``ckv`` / ``krope`` rows stay whole on every rank,
    because every head of a rank reads the whole latent (DeepSeek-V2-Lite's
    ``decode_32k``: 27 layers × 8 rows × 32 768 × 576 × 2 B ≈ 8.2 GB a
    device, where the reference's split would hold 0.5).  Where K % M ≠ 0
    the reference's rule splits W over ``model`` instead, it splits
    ``conv`` contiguously and the latent rows on their rank dim R; the
    values read are the same."""
    m = mesh.coord(MODEL)
    first, n = layout.kv_heads(m)

    def one(path, leaf):
        if path[-1] in ("k", "v"):
            return leaf.narrow(3, first, n)
        if path[-1] == "conv":
            return layout.compute_slice("ssm_conv_b", leaf, m)
        if path[-1] == "state":
            return leaf.narrow(2, *layout.ssm_heads(m))
        return leaf
    return tree_map_with_path(one, shard_tree(cache, c_specs, mesh))
