"""TF32 products, emulated: within :class:`TF32Products`, each float32
operand of a matrix product (``matmul``, ``@``, ``mm``, ``bmm``,
``einsum``) is rounded to TF32's 10-bit mantissa first, and the product
accumulates in float32, as the card's tensor cores do with TF32 on.  The
control of a float32 cell is the reference in float32 under this mode
(with TF32 allowed, the library still runs most of the program's products
without the tensor cores)."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.einsum,
            torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm,
            torch.Tensor.__matmul__, torch.Tensor.__rmatmul__}


def round_tf32(x):
    """`x` rounded to the nearest TF32 value (ties away from zero), where
    it is a finite float32 tensor; anything else as it is."""
    if isinstance(x, (list, tuple)):
        return type(x)(round_tf32(v) for v in x)
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


class TF32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            args = tuple(round_tf32(a) for a in args)
        return func(*args, **(kwargs or {}))
