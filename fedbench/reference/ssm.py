"""Plain-PyTorch reference of the ssm family: a Mamba2 language model
[arXiv:2405.21060], written from its equations in float32.

Weights are read in the port's layout, one flat key per tensor row
(``embed/tok``, ``blocks/<leaf>/<row>``, ``final_norm``):

* a row: ``x = h + out_proj(gnorm(ssd(conv(in_proj(rms(h)))) · silu(z)))``;
  ``in_proj`` packs z | x | B | C | dt, the depthwise causal conv (width
  ``ssm_conv``, then SiLU) runs over x | B | C, dt = softplus(dt +
  dt_bias), A = −exp(A_log), and the gated norm is an RMS norm over
  ``d_inner``;
* the scan: y_t = Σ_{s≤t} C_t·B_s exp(Σ_{s<r≤t} dt_r A) dt_s x_s + D x_t,
  computed in chunks of ``ssm_chunk`` (the dense form inside a chunk, a
  state of (P, N) per head across chunks);
* norms keep their scale s as (1 + s), ε 1e-5; the head is the tied
  embedding; the loss is the mean next-token cross-entropy.

Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5


def dims(c: dict):
    d = c["d_model"]
    d_in = c["ssm_expand"] * d
    h = c["ssm_heads"]
    return d, d_in, h, d_in // h, c["ssm_groups"], c["ssm_state"], c["ssm_conv"]


def mamba_leaves(c: dict, n_rows: int) -> dict:
    """Leaf shapes and init rules of one Mamba2 row, stacked ``n_rows``."""
    d, d_in, h, _, g, n, K = dims(c)
    cd = d_in + 2 * g * n
    resid = 0.02 / math.sqrt(2 * c["n_layers"])
    L = (n_rows,)
    return {
        "ssm_A_log": (L + (h,), ("log_uniform", 1.0, 16.0)),
        "ssm_D": (L + (h,), ("ones",)),
        "ssm_conv_b": (L + (cd,), ("uniform", K ** -0.5)),
        "ssm_conv_w": (L + (K, cd), ("uniform", K ** -0.5)),
        "ssm_dt_bias": (L + (h,), ("dt_bias", 1e-3, 0.1)),
        "ssm_gate_ln": (L + (d_in,), ("zeros",)),
        "ssm_in_proj": (L + (d, 2 * d_in + 2 * g * n + h), ("normal", 0.02)),
        "ssm_ln": (L + (d,), ("zeros",)),
        "ssm_out_proj": (L + (d_in, d), ("normal", resid)),
    }


def leaf_specs(c: dict) -> dict:
    """The weights as the port lays them out: ``{path: {leaf: (shape,
    rule)}}`` or ``{path: (shape, rule)}``."""
    d = c["d_model"]
    return {"embed": {"tok": ((c["vocab_size"], d), ("normal", 0.02))},
            "blocks": mamba_leaves(c, c["n_layers"]),
            "final_norm": ((d,), ("zeros",))}


def units(c: dict) -> list:
    """The selectable layers in mask order, each a list of flat keys."""
    names = sorted(mamba_leaves(c, 1))
    return [[f"blocks/{k}/{i}" for k in names] for i in range(c["n_layers"])]


def rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
        * (1.0 + scale.float())


def ssd(x, dt, A, B, C, D, chunk: int, num) -> torch.Tensor:
    """The scan in float32: x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,g,n),
    D (h,) → y (b,s,h,p)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    nc = s // q
    Bh = B.repeat_interleave(h // g, dim=2).reshape(b, nc, q, h, n)
    Ch = C.repeat_interleave(h // g, dim=2).reshape(b, nc, q, h, n)
    xdt = (x * dt[..., None]).reshape(b, nc, q, h, p)
    a = torch.cumsum((dt * A).reshape(b, nc, q, h), dim=2)   # Σ_{r≤t} dt A
    seg = a[:, :, :, None, :] - a[:, :, None, :, :]           # (b,c,t,s,h)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  float("-inf")))
    cb = torch.einsum("bcthn,bcshn->bctsh", num.q(Ch), num.q(Bh))
    y = torch.einsum("bctsh,bcshp->bcthp", num.q(cb * decay), num.q(xdt))
    # the state each chunk leaves behind, then carried across chunks
    last = torch.exp(a[:, :, -1:, :] - a)                     # (b,c,s,h)
    st = torch.einsum("bcshn,bcshp->bchpn", num.q(Bh * last[..., None]),
                      num.q(xdt))
    state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    entering = []
    for k in range(nc):
        entering.append(state)
        state = state * torch.exp(a[:, k, -1, :])[..., None, None] + st[:, k]
    prev = torch.stack(entering, dim=1)                       # (b,c,h,p,n)
    y = y + torch.einsum("bcthn,bchpn->bcthp",
                         num.q(Ch * torch.exp(a)[..., None]), num.q(prev))
    return y.reshape(b, s, h, p) + x * D[None, None, :, None]


def causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, k:k + S] * w[k] for k in range(K))
    return F.silu(out + bias)


def mamba_row(p: dict, h: torch.Tensor, c: dict, num) -> torch.Tensor:
    """One residual Mamba2 row; ``p`` maps leaf names to tensors."""
    d, d_in, H, P, g, n, _ = dims(c)
    b, s, _ = h.shape
    f = {k: v.float() for k, v in p.items()}
    zxbcdt = num.mm(rms(h, f["ssm_ln"]), f["ssm_in_proj"])
    z = zxbcdt[..., :d_in]
    xbc = causal_conv(zxbcdt[..., d_in:2 * d_in + 2 * g * n],
                      f["ssm_conv_w"], f["ssm_conv_b"])
    dt = F.softplus(zxbcdt[..., 2 * d_in + 2 * g * n:] + f["ssm_dt_bias"])
    y = ssd(xbc[..., :d_in].reshape(b, s, H, P), dt,
            -torch.exp(f["ssm_A_log"]),
            xbc[..., d_in:d_in + g * n].reshape(b, s, g, n),
            xbc[..., d_in + g * n:].reshape(b, s, g, n),
            f["ssm_D"], c["ssm_chunk"], num)
    y = rms(y.reshape(b, s, d_in) * F.silu(z), f["ssm_gate_ln"])
    return h + num.mm(y, f["ssm_out_proj"])


def lm_loss(h: torch.Tensor, tokens: torch.Tensor, state: dict,
            num) -> torch.Tensor:
    """Mean next-token cross-entropy through the tied head."""
    hn = rms(h[:, :-1], state["final_norm"])
    logits = num.mm(hn, state["embed/tok"].float().T)
    tgt = tokens[:, 1:].long()
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean()


class Stack:
    """The compute order of a model: a list of (mask index, fn(h, params
    dict) -> h, names) steps, run with autograd from the lowest wanted
    layer up, each differentiated step rematerialised in the backward."""

    def __init__(self, steps: list):
        self.steps = steps

    def loss(self, state: dict, tokens: torch.Tensor, c: dict, num,
             want=None):
        """(loss, {key: f32 gradient}) for the mask indices in ``want``
        (None or empty: the loss alone, no graph)."""
        want = sorted(set(want or ()))
        first = min((pos for pos, (u, _, _) in enumerate(self.steps)
                     if u in want), default=len(self.steps))
        leaves: dict = {}
        with torch.no_grad():
            h = state["embed/tok"][tokens.long()].float()
            for _, fn, keys in self.steps[:first]:
                h = fn(h, {k: state[v] for k, v in keys.items()})
        with torch.enable_grad():
            for u, fn, keys in self.steps[first:]:
                vals = {}
                for k, v in keys.items():
                    if u in want:
                        if v not in leaves:
                            leaves[v] = state[v].to(torch.float32, copy=True) \
                                .requires_grad_()
                        vals[k] = leaves[v]
                    else:
                        vals[k] = state[v]
                names = list(vals)

                def step(h_, *ts, fn=fn, names=names):
                    return fn(h_, dict(zip(names, ts)))
                args = (h, *(vals[k] for k in names))
                # rematerialised on the card, where the activations of a
                # whole model in float32 would not fit
                h = (checkpoint(step, *args, use_reentrant=False)
                     if h.is_cuda else step(*args))
            loss = lm_loss(h, tokens, state, num)
            if not leaves:
                return loss.detach(), {}
            keys = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        return loss.detach(), dict(zip(keys, grads))


def stack(c: dict, num) -> Stack:
    names = sorted(mamba_leaves(c, 1))
    steps = []
    for i in range(c["n_layers"]):
        keys = {k: f"blocks/{k}/{i}" for k in names}
        steps.append((i, lambda h, p: mamba_row(p, h, c, num), keys))
    return Stack(steps)
