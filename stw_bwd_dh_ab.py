#!/usr/bin/env python3
"""Kernel 5's dh read-back against recomputing dh, on one NVIDIA GPU.

    python3 stw_bwd_dh_ab.py

Kernel 5's bf16 body (``extdm_tpu_torch/csrc/stw_layer_bwd.cu``) forms
dh = dqkv Wqkv in one launch (``stw_bwd_dh_kernel``, dh in float32 to
device memory) and reads it back in the ChanLN backward (``ln_bwd_kernel``),
which needs two row sums over all C channels before it can write dx. The
other design recomputes dh there: a first round of the product forms the
row sums, a second forms dh again and writes dx. Whatever its epilogues
cost, it runs the product twice without the float32 store. At KTH's
32 x 32 / 64-channel and multi1248's 4 x 4 / 512-channel training layers
(batch 8), this script times by torch.profiler (``chip_smoke.device_ms``):

  dh_ms       stw_bwd_dh_kernel as built: the product and its float32 store;
  ln_ms       ln_bwd_kernel, the read-back included;
  product_ms  the product alone: stw_bwd_dh_kernel of a copy of the source
              whose store is cut (built here with nvcc),

and prints, after the card's name and power limit, one JSON line a shape
with read_back_ms = dh_ms + ln_ms and recompute_floor_ms = 2 product_ms.
The copy's gradients are not used (its dh is never written).
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke

# (x shape, window): the layers' shapes in the KTH and multi1248 train steps
SHAPES = (((8, 30, 32, 32, 64), (4, 4, 4)), ((8, 30, 4, 4, 512), (4, 4, 4)))
STORE = """  conv_tile<false, 1, 3, BN>(ring, &wmap, dqkv, nullptr, dh, tokens, 1, 1, K, C, blockIdx.x * GM,
                             blockIdx.y * BN);"""
NO_STORE = """  float acc[BN / 2];
  conv_product<false, 1, 3, BN>(ring, &wmap, dqkv, acc, tokens, 1, 1, K, blockIdx.x * GM,
                                blockIdx.y * BN);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) s += acc[j];
  if (s == 1.2345e-30f) dh[threadIdx.x] = s;  // keeps the products live; stores nothing"""


def product_only_library(_build) -> ctypes.CDLL:
    """stw_layer_bwd.cu with stw_bwd_dh_kernel's store cut, built in a
    temporary directory beside copies of the headers it includes."""
    src = (_build.CSRC / "stw_layer_bwd.cu").read_text()
    if src.count(STORE) != 1:
        raise AssertionError("stw_bwd_dh_kernel's store is not where this script expects it")
    tmp = Path(tempfile.mkdtemp(prefix="stw_bwd_dh_ab_"))
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, tmp / header.name)
    (tmp / "stw_layer_bwd.cu").write_text(src.replace(STORE, NO_STORE))
    out = tmp / "libstw_layer_bwd.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(out), str(tmp / "stw_layer_bwd.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def use_library(_build, lib: ctypes.CDLL) -> None:
    _build._LIBS["stw_layer_bwd"] = lib
    for key in [k for k in _build._FNS if k[0] == "stw_layer_bwd"]:
        del _build._FNS[key]


def main() -> int:
    if not torch.cuda.is_available():
        print("stw_bwd_dh_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from extdm_tpu_torch import _build
    from extdm_tpu_torch.ops import fused_stw

    card = chip_smoke.card_info()
    _build.build_all()
    built = _build.library("stw_layer_bwd")
    variant = product_only_library(_build)
    heads, dim_head = 8, 32
    hid = heads * dim_head
    g = torch.Generator(device="cuda").manual_seed(29)
    r = lambda *s, scale=1.0: torch.randn(s, generator=g, device="cuda") * scale  # noqa: E731
    for shape, window in SHAPES:
        C = shape[-1]
        N = math.prod(window)
        args = [r(*shape).bfloat16(), r(*shape).bfloat16(), 1 + r(C, scale=0.1),
                r(3 * hid, C, scale=C ** -0.5).bfloat16(), r(C, hid, scale=hid ** -0.5).bfloat16(),
                r(C, scale=0.1).bfloat16(), r(heads, N, N, scale=0.1)]
        kwargs = dict(window=window, shift=(0, 0, 0), heads=heads, dim_head=dim_head)

        def call():
            fused_stw.stw_layer_bwd(*args, **kwargs)

        use_library(_build, built)
        dh_ms = chip_smoke.device_ms(call, 10, {"stw_bwd_dh_kernel"})[0]
        ln_ms = chip_smoke.device_ms(call, 10, {"ln_bwd_kernel"})[0]
        use_library(_build, variant)
        product_ms = chip_smoke.device_ms(call, 10, {"stw_bwd_dh_kernel"})[0]
        use_library(_build, built)
        print(json.dumps({"ab": "kernel 5 dh: read back vs recompute", "shape": list(shape),
                          "window": list(window), "dh_ms": dh_ms, "ln_ms": ln_ms,
                          "product_ms": product_ms, "read_back_ms": dh_ms + ln_ms,
                          "recompute_floor_ms": 2 * product_ms, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
