"""The precision a reference computation runs in.

``"f32"`` is the reference: every product in float32, with TF32 off on the
card.  ``"fp8"`` is the control: the same equations with every product's
operands rounded to float8 e4m3 (one scale per tensor, its absolute maximum
mapped to 448) and accumulated in float32, the step below the bfloat16
that the configurations state.  The backward passes the rounding through
unchanged, so its products read the rounded forward operands.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


class Numerics:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"numerics must be 'f32' or 'fp8', got {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product, as this precision holds it (f32)."""
        t = t.float()
        if self.kind == "f32":
            return t
        with torch.no_grad():
            scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
            err = (t / scale).to(torch.float8_e4m3fn).float() * scale - t
        # the rounded value forward; gradients pass to t unchanged
        return t + err

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def full_f32() -> None:
    """Float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
