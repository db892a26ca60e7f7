"""The reference computed one precision below the configuration's: every
product in fp8.

Under ``Fp8Products()`` every convolution and matrix product (forward and
backward) takes its operands rounded to float8 e4m3, each tensor scaled by
its own largest magnitude (per-tensor scaling, as fp8 GEMMs are fed), and
accumulates in the operands' own type. It is the benchmark's control: a
program that computed its bfloat16 products in fp8 would read as this
does, so each cell's limits have to fail it.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
E4M3_MAX = 448.0

# operand positions of each product
PRODUCTS = {
    aten.convolution.default: (0, 1),
    aten.convolution_backward.default: (0, 1, 2),
    aten.mm.default: (0, 1),
    aten.bmm.default: (0, 1),
    aten.addmm.default: (1, 2),
    aten.baddbmm.default: (1, 2),
}


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in x's type."""
    if not torch.is_tensor(x) or not x.is_floating_point() or x.numel() == 0:
        return x
    scale = torch.clamp(x.abs().amax().float(), min=1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class Fp8Products(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        positions = PRODUCTS.get(func)
        if positions:
            args = list(args)
            for i in positions:
                args[i] = fp8(args[i])
        return func(*args, **(kwargs or {}))
