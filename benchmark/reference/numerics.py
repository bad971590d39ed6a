"""The precision the reference computes its products in.

`Numerics("fp32")` is the reference: every product in float32, with TF32
off (`fp32_products` switches it off and back). `Numerics("fp8")` is the
control of the benchmark's output check: each operand of a product
(linear, convolution, attention's q k^T and p v) is rounded to float8
e4m3 under a per-tensor scale (amax / 448) before the float32 product, the
step below the bf16 that the configurations state. In a graph the
rounding passes the gradient straight through, so the backward's products
take the rounded operands that autograd saved.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

E4M3_MAX = 448.0


class Numerics:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}: fp32 or fp8")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product in this precision."""
        if self.kind == "fp32":
            return x
        with torch.no_grad():
            scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
            r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (r - x).detach() if x.requires_grad else r


@contextlib.contextmanager
def fp32_products() -> Iterator[None]:
    """Float32 products on the card: TF32 off for matmuls and cuDNN."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
