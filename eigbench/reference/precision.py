"""The precision a reference runs in.

The reference itself runs in float64.  Its control runs the same code one
step below the precision the configuration states: "tf32" keeps float32
storage and rounds every matrix-product operand to TF32's 10-bit mantissa
(the products of two such operands are exact in float32, as on the
tensor cores); "bf16" stores and computes in bfloat16.  "f32" is plain
float32 with no TF32, a witness between the two.
"""

from __future__ import annotations

import torch

DTYPES = {"f64": torch.float64, "f32": torch.float32, "tf32": torch.float32,
          "bf16": torch.bfloat16}


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value (10 explicit
    mantissa bits), ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """How vectors are stored and how product operands are rounded."""

    def __init__(self, name: str):
        if name not in DTYPES:
            raise ValueError(f"precision must be one of {sorted(DTYPES)}, "
                             f"got {name!r}")
        self.name = name
        self.dtype = DTYPES[name]

    def vec(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in the storage dtype."""
        return t.to(self.dtype)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an operand of a matrix product."""
        t = t.to(self.dtype)
        return round_tf32(t) if self.name == "tf32" else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` with both operands rounded as this precision's
        products round them (no TF32 inside the library call)."""
        with no_tf32():
            return self.operand(a) @ self.operand(b)


class no_tf32:
    """Keep PyTorch's own float32 products in full float32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
