"""What the plain references share: the weights drawn from an executor's
seed, the precision a reference computes in, and the comparison of served
logits with the reference's.

Weights. A serving executor draws every parameter from a ``torch.Generator``
on its device seeded with its seed, in sorted-path order: a truncated normal
on [-2, 2] times 1/sqrt(fan-in) (fan-in: the product of every axis but the
last), a standard normal for the embedding, zeros and ones where named, each
drawn in float32 in slices of whole rows of at most 2**26 elements and
rounded to the dtype it is served in. ``draw`` makes the same numbers from
the same seed, on its own: the reference holds each served parameter in
that dtype (bf16 matrices hold their bf16 values exactly) and computes in
float32 from it.

Precision. ``Prec("float32")`` is the reference. ``Prec("fp8")`` is the
control: the same forward computed in float8 e4m3 wherever the
configuration computes in bf16: both operands of every product (a scale
per row of the activations and per output column of the weights) and the
activations the program holds in bf16 between operations (the residual
stream, the scan's inputs), the step below bf16 that a faster serving path
would take.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DRAW_ELEMS = 1 << 26
FP8_MAX = 448.0


def draw(specs: dict, seed: int, device, served_dtype) -> dict:
    """Every parameter of ``specs`` ({path: (shape, init, scale)}), drawn
    from ``seed`` on ``device`` in sorted-path order; ``served_dtype(path)``
    gives the dtype each is held in."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for path in sorted(specs):
        shape, init, scale = specs[path]
        dt = served_dtype(path)
        if init == "zeros":
            out[path] = torch.zeros(shape, dtype=dt, device=device)
            continue
        if init == "ones":
            out[path] = torch.ones(shape, dtype=dt, device=device)
            continue
        if scale is None:
            fan_in = shape[0] if len(shape) <= 1 else math.prod(shape[:-1])
            scale = 1.0 if init == "embed" else 1.0 / np.sqrt(max(fan_in, 1))
        scale = float(scale)
        t = torch.empty(shape, dtype=dt, device=device)
        rows = max(1, DRAW_ELEMS // math.prod(shape[1:]))
        for i in range(0, shape[0], rows):
            j = min(i + rows, shape[0])
            piece = torch.empty((j - i, *shape[1:]), dtype=torch.float32,
                                device=device)
            if init == "embed":
                piece.normal_(0.0, 1.0, generator=gen)
            else:
                torch.nn.init.trunc_normal_(piece, 0.0, 1.0, -2.0, 2.0,
                                            generator=gen)
            t[i:j].copy_(piece.mul_(scale))
        out[path] = t
    return out


class Prec:
    """How a reference rounds the operands of its bf16 products."""

    def __init__(self, name: str):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation operand, float32, rows along the last axis."""
        x = x.float()
        return _fp8(x, -1) if self.name == "fp8" else x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (..., in, out) weight operand, float32."""
        w = w.float()
        return _fp8(w, -2) if self.name == "fp8" else w

    def mm(self, x, w):
        return self.act(x) @ self.weight(w)

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation the program holds in bf16 between operations (the
        residual stream, the scan's inputs), rows along the last axis."""
        return _fp8(x.float(), -1) if self.name == "fp8" else x.float()


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def rms_norm(x, scale, eps: float = 1e-6):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def compare(served: torch.Tensor, ref: torch.Tensor) -> dict:
    """Served logits (n, V) against the reference's (n, V), both float32:
    per row, how far the reference's logit of the served top token lies
    below the reference's best (``top_gap``), and the largest logit error
    over the reference's root mean square logit (``logit_err``)."""
    served, ref = served.double(), ref.double()
    top = served.argmax(-1)
    gap = ref.max(-1).values - ref.gather(-1, top[:, None])[:, 0]
    rms = ref.square().mean(-1).sqrt()
    err = (served - ref).abs().max(-1).values / rms
    return {"top_gap": gap.cpu().numpy(), "logit_err": err.cpu().numpy()}


def compare_kv(served: torch.Tensor, ref: torch.Tensor) -> np.ndarray:
    """Served cache slots (n, layers, 2, heads, D) against the
    reference's, both float32: per execution, the largest error of a key or
    value over the root mean square of the reference's keys (or values) in
    that layer (``kv_err``)."""
    served, ref = served.double(), ref.double()
    rms = ref.square().mean((-2, -1)).sqrt().clamp(min=1e-30)
    err = (served - ref).abs().amax((-2, -1)) / rms
    return err.flatten(1).amax(1).cpu().numpy()


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
