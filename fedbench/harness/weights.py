"""Weights made from the seed, on the device, in the type they are served
in: one draw per leaf from a generator on the device, in the port's layout
(``{path: {leaf: tensor}}``, stacked segments with a leading row axis).
The program and the reference receive the same tensors."""
from __future__ import annotations

import math

import torch

# segments whose leaves carry a leading axis of one row per layer
STACKED = ("blocks",)


def _leaf(shape, rule, gen, device, dtype) -> torch.Tensor:
    kind = rule[0]
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device).mul_(rule[1])
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    if kind == "uniform":
        out = (2.0 * u - 1.0) * rule[1]
    elif kind == "log_uniform":                  # log U[lo, hi)
        out = torch.log(rule[1] + (rule[2] - rule[1]) * u)
    elif kind == "dt_bias":                      # softplus⁻¹ of log-uniform dt
        lo, hi = math.log(rule[1]), math.log(rule[2])
        dt = torch.exp(lo + (hi - lo) * u).clamp_min(1e-4)
        out = dt + torch.log(-torch.expm1(-dt))
    else:
        raise ValueError(f"unknown init rule {rule!r}")
    return out.to(dtype)


def make_params(specs: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for path in sorted(specs):
        spec = specs[path]
        if isinstance(spec, dict):
            out[path] = {k: _leaf(*spec[k], gen, device, dtype)
                         for k in sorted(spec)}
        else:
            out[path] = _leaf(*spec, gen, device, dtype)
    return out


def flat_rows(params: dict) -> dict:
    """``{key: tensor}`` views, one per leaf row: ``blocks/<leaf>/<row>``
    for a stacked segment, ``<path>/<leaf>`` or ``<path>`` otherwise."""
    flat = {}
    for path, sub in params.items():
        if not isinstance(sub, dict):
            flat[path] = sub
            continue
        for k, t in sub.items():
            if path in STACKED:
                for i in range(t.shape[0]):
                    flat[f"{path}/{k}/{i}"] = t[i]
            else:
                flat[f"{path}/{k}"] = t
    return flat


@torch.no_grad()
def change_norms(new: dict, old: dict) -> dict:
    """‖new − old‖ in float32 for every leaf row, as Python floats."""
    a, b = flat_rows(new), flat_rows(old)
    keys = sorted(a)
    norms = torch.stack([(a[k].float() - b[k].float()).norm() for k in keys])
    return dict(zip(keys, norms.tolist()))
