"""Dependency-free checkpointing of nested dicts of tensors and numpy
arrays (counterpart of ``repro/ckpt/checkpoint.py``, in its on-disk
format, so a checkpoint crosses between the two packages).

One ``step_<08d>/`` directory per checkpoint holds

* ``arrays.npz`` — one ``.npy`` member per leaf, keyed by its ``/``-joined
  path (``|`` inside the archive), leaves in sorted-key order;
* ``manifest.json`` — ``step``, the sorted ``keys``, ``dtypes``,
  ``shapes``, a crc32 ``checksums`` map over each leaf's bytes, and
  ``extra`` (the FL round metadata).

bf16 has no numpy type without ``ml_dtypes``: a bf16 leaf is written as its
raw 2-byte words under the npy descr ``'<V2'`` with ``"bfloat16"`` in
``dtypes`` — the bytes, descr, dtype string and checksum the reference
writes — and read back by viewing the words as ``torch.bfloat16``.

Saves are atomic (write to a ``tmp*`` dir, then rename); orphaned ``tmp*``
dirs of interrupted saves are swept on the next save.
:func:`restore_checkpoint` restores into a template tree (``partial=True``
keeps template leaves the archive lacks); :func:`verify_checkpoint` checks
manifest, archive, key set and checksums without a template, and
:func:`latest_intact_step` scans newest-first for the first checkpoint that
verifies — the fallback ``FLServer.restore_state`` takes past a corrupted
latest step.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

_SEP = "/"
_BF16 = "bfloat16"
_BF16_DESCR = "<V2"


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (host numpy array of its bytes, dtype string)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _flatten(tree, prefix: str = "") -> dict[str, tuple[np.ndarray, str]]:
    """Leaves by ``/``-joined path, keys sorted at every level (the order
    ``jax.tree_util`` flattens a dict in)."""
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        key = prefix + str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key + _SEP))
        else:
            flat[key] = _host_array(v)
    return flat


def _checksum(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _write_npz(path: str, flat: dict[str, tuple[np.ndarray, str]]) -> None:
    """``np.savez``'s container (stored, zip64 members), with bf16 leaves
    written under the reference's ``'<V2'`` descr."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (a, dtype) in flat.items():
            name = key.replace(_SEP, "|") + ".npy"
            with zf.open(name, "w", force_zip64=True) as f:
                if dtype == _BF16:
                    np.lib.format.write_array_header_1_0(f, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": a.shape})
                    f.write(a.tobytes())
                else:
                    np.lib.format.write_array(f, a, allow_pickle=False)


def sweep_tmp_dirs(directory: str) -> list[str]:
    """Remove orphaned ``tmp*`` dirs left behind by interrupted saves."""
    swept = []
    if not os.path.isdir(directory):
        return swept
    for d in os.listdir(directory):
        path = os.path.join(directory, d)
        if d.startswith("tmp") and os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            swept.append(path)
    return swept


def save_checkpoint(directory: str, step: int, tree: dict,
                    extra: Optional[dict] = None) -> str:
    """Write ``tree`` (nested dicts of tensors or arrays) as ``step``."""
    os.makedirs(directory, exist_ok=True)
    sweep_tmp_dirs(directory)
    target = os.path.join(directory, f"step_{step:08d}")
    flat = _flatten(tree)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "dtypes": {k: dt for k, (_, dt) in flat.items()},
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "checksums": {k: _checksum(a) for k, (a, _) in flat.items()},
        "extra": extra or {},
    }
    tmp = tempfile.mkdtemp(dir=directory)
    try:
        _write_npz(os.path.join(tmp, "arrays.npz"), flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(target):
            shutil.rmtree(target)
        os.rename(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return target


def all_checkpoint_steps(directory: str) -> list[int]:
    """Every ``step_*/`` step under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if not d.startswith("step_"):
            continue
        try:
            steps.append(int(d.split("_")[1]))
        except (IndexError, ValueError):
            continue            # a stray entry, not a checkpoint
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_checkpoint_steps(directory)
    return steps[-1] if steps else None


def _read_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k.replace("|", _SEP): z[k] for k in z.files}


def verify_checkpoint(directory: str, step: int) -> tuple[bool, str]:
    """Is checkpoint ``step`` intact?  Returns ``(ok, why)``: the manifest
    parses, the archive loads, its key set matches the manifest and every
    leaf's crc32 matches (a manifest without ``checksums`` is checked
    structurally only).  Never raises on damage: the caller needs the
    verdict."""
    target = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(target, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"manifest unreadable: {e}"
    try:
        flat = _read_npz(os.path.join(target, "arrays.npz"))
    except Exception as e:  # a torn archive raises zipfile, OS and value errors alike
        return False, f"arrays unreadable: {e}"
    missing = set(manifest.get("keys", [])) - set(flat)
    if missing:
        return False, f"arrays missing keys: {sorted(missing)[:3]}"
    for key, want in manifest.get("checksums", {}).items():
        if key in flat and _checksum(flat[key]) != want:
            return False, f"checksum mismatch on {key!r}"
    return True, "ok"


def latest_intact_step(directory: str
                       ) -> tuple[Optional[int], list[tuple[int, str]]]:
    """Newest checkpoint that verifies, and the ``(step, why)`` list of
    newer ones skipped as corrupt; ``(None, skipped)`` when none does."""
    skipped: list[tuple[int, str]] = []
    for step in reversed(all_checkpoint_steps(directory)):
        ok, why = verify_checkpoint(directory, step)
        if ok:
            return step, skipped
        skipped.append((step, why))
    return None, skipped


def load_checkpoint_arrays(directory: str, step: Optional[int] = None
                           ) -> tuple[dict[str, np.ndarray], dict]:
    """The raw flat ``{path: array}`` archive and its manifest, no template
    (bf16 leaves as their ``'V2'`` words; :func:`leaf_to_torch` reads
    them)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    target = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(target, "manifest.json")) as f:
        manifest = json.load(f)
    return _read_npz(os.path.join(target, "arrays.npz")), manifest


def leaf_to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """An archive leaf as a CPU tensor; ``dtype`` is the manifest's."""
    if dtype == _BF16:
        words = np.array(arr).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def extract_delta(directory: str, base_params: dict, cfg,
                  step: Optional[int] = None, *,
                  layers=None, atol: float = 0.0):
    """Diff a saved FL round against ``base_params`` into a sparse
    :class:`repro_torch.serve.deltas.DeltaRecord` (a round checkpoint →
    the delta-serving store).  Takes bare-params checkpoints and FLServer's
    wrapped trees (keys under ``params/``); ``layers=None`` exports the
    rows that moved by more than ``atol``."""
    from repro_torch.serve.deltas import delta_from_params

    flat, manifest = load_checkpoint_arrays(directory, step)
    prefix = "params/" if any(k.startswith("params/") for k in flat) else ""
    tuned: dict[str, dict[str, torch.Tensor]] = {}
    for key, arr in flat.items():
        if prefix and not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split(_SEP)
        if len(parts) != 2:
            continue
        seg, leaf = parts
        tuned.setdefault(seg, {})[leaf] = leaf_to_torch(
            arr, manifest["dtypes"][key])
    return delta_from_params(base_params, tuned, cfg, layers=layers,
                             atol=atol)


def restore_tree(flat: dict[str, np.ndarray], manifest: dict,
                 template: dict, *, partial: bool = False,
                 source: str = "") -> tuple[dict, list, list]:
    """Fill the structure of ``template`` from a loaded archive (shapes
    must match): each leaf comes back as a tensor of the template leaf's
    dtype on its device.  Returns (tree, restored paths, skipped paths)."""
    restored, skipped = [], []

    def fill(node, prefix):
        out = {}
        for k in sorted(node):
            leaf, key = node[k], prefix + str(k)
            if isinstance(leaf, dict):
                out[k] = fill(leaf, key + _SEP)
                continue
            if key not in flat:
                if not partial:
                    raise KeyError(
                        f"{key!r} missing from checkpoint {source} step "
                        f"{manifest['step']} (pass partial=True to keep the "
                        f"template leaf)")
                skipped.append(key)
                out[k] = leaf
                continue
            arr = flat[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} vs "
                                 f"template {tuple(leaf.shape)}")
            restored.append(key)
            t = leaf_to_torch(arr, manifest["dtypes"][key])
            out[k] = t.to(device=leaf.device, dtype=leaf.dtype)
        return {k: out[k] for k in node}          # the template's key order

    return fill(template, ""), restored, skipped


def restore_checkpoint(directory: str, template: dict,
                       step: Optional[int] = None, *,
                       partial: bool = False) -> tuple[dict, dict]:
    """Restore into the structure of ``template`` (:func:`restore_tree`).
    With ``partial=True`` template keys absent from the archive keep the
    template leaf instead of raising.  The manifest gains ``restored`` and
    ``skipped`` lists of paths."""
    flat, manifest = load_checkpoint_arrays(directory, step)
    tree, manifest["restored"], manifest["skipped"] = restore_tree(
        flat, manifest, template, partial=partial, source=directory)
    return tree, manifest
