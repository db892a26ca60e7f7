"""Kernel 1's bf16 body (``csrc/stw_layer.cu``) and kernel 12's operands, on
the CPU: the host-side pieces the card's kernels depend on.

``stw_plan`` sizes kernel 1's launch: it must cover the layer (every output
column, every head group and 64-channel block) and fit one block's shared
memory at every shape the presets give it. The plain layer at 512 channels
(the widest layer kernel 1 takes) is held against JAX's
``pallas_stw.stw_layer_reference`` in float32 to 1e-5. Kernel 12 reads the
head-split views of a qkv product through their strides: its operand
function passes them uncopied, and its output layout makes the head merge a
view.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.nn.attention import _relative_position_index, _shifted_window_mask
from extdm_tpu.ops import pallas_stw
from extdm_tpu_torch.nn.attention import _merge_heads, _rotate, _split_heads
from extdm_tpu_torch.ops import fused_stw, window_attn

SRC = Path(__file__).resolve().parents[1] / "extdm_tpu_torch" / "csrc" / "stw_layer.cu"


def _constant(name):
    """An integer constant of the kernel source: a literal or a product of
    literals and BOX."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SRC.read_text()).group(1)
    value = 1
    for factor in expr.split("*"):
        factor = factor.strip()
        value *= _constant(factor) if factor.isidentifier() else int(factor)
    return value


def test_plan_constants_are_the_kernels():
    assert _constant("BOX") == fused_stw.STW_BOX
    assert _constant("QKV_STEP") == fused_stw.STW_QKV_STEP
    assert _constant("SMEM_MAX") == fused_stw.STW_SMEM_MAX == 232448


@pytest.mark.parametrize("C", [64, 128, 256, 512, 192, 320])
@pytest.mark.parametrize("N", [16, 32, 64])
def test_stw_plan_covers_the_layer_and_fits(C, N):
    heads, dh = 8, 32
    plan = fused_stw.stw_plan(C, N, heads, dh, 132)
    assert plan.smem <= fused_stw.STW_SMEM_MAX
    assert plan.cw in (64, 128) and plan.rounds * 2 * plan.cw >= C > (plan.rounds - 1) * 2 * plan.cw
    nkp = -(-C // 64)
    assert plan.steps == heads // 4 * nkp + plan.rounds * heads * dh // 64
    assert plan.resident == (C == 64)  # 128 KB of weights stay with every window at C = 64
    assert plan.resident or plan.stages >= 2
    assert plan.blocks == 132
    assert fused_stw.stw_plan(C, N, heads, dh, 132) is plan  # cached


@pytest.mark.parametrize("args", [(544, 64, 8, 32), (512, 65, 8, 32), (512, 64, 8, 16),
                                  (512, 64, 2, 32), (500, 64, 8, 32)])
def test_stw_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        fused_stw.stw_plan(*args, 132)


def test_stw_plain_at_512_channels_matches_reference():
    B, T, H, W, C = 1, 6, 8, 8, 512
    window, shift, heads, dh = (4, 4, 4), (2, 2, 2), 8, 32
    rng = np.random.default_rng(21)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x = f(B, T, H, W, C)
    gamma, w_qkv, w_proj, b_proj = 1 + 0.1 * f(C), 0.03 * f(C, 768), 0.03 * f(256, C), 0.05 * f(C)
    table = 0.02 * f(7 * 7 * 7, heads)
    rel = _relative_position_index(window)
    bias = np.transpose(table[rel.reshape(-1)].reshape(64, 64, heads), (2, 0, 1))
    m = _shifted_window_mask(8, 8, 8, window, shift)
    uniq, ids = np.unique(m.reshape(m.shape[0], -1), axis=0, return_inverse=True)
    ref = pallas_stw.stw_layer_reference(
        jnp.asarray(x), gamma, w_qkv, w_proj, b_proj, jnp.asarray(bias),
        jnp.asarray(uniq.reshape(-1, 64, 64)), jnp.asarray(ids.reshape(-1).astype(np.int32)),
        window=window, shift=shift, heads=heads, dim_head=dh, rotary=True)
    t = torch.from_numpy
    out = fused_stw.fused_stw_layer(t(x), t(gamma), t(w_qkv.T.copy()), t(w_proj.T.copy()),
                                    t(b_proj), t(bias), window=window, shift=shift, heads=heads,
                                    dim_head=dh)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_operands_take_head_split_views_uncopied(dtype):
    heads, dh, N, C = 8, 32, 64, 64
    g = torch.Generator().manual_seed(3)
    windows = torch.randn(6, N, C, generator=g).to(dtype)
    w_qkv = (0.1 * torch.randn(3 * heads * dh, C, generator=g)).to(dtype)
    q, k, v = (_split_heads(a, heads, dh) for a in (windows @ w_qkv.t()).chunk(3, -1))
    assert not v.is_contiguous()  # a view into the qkv product
    q, k = _rotate(q, k, dh)
    ops, vec = window_attn.window_attention_operands(q, k, v)
    assert all(o[0] is t for o, t in zip(ops, (q, k, v)))  # no copy
    assert [(o[1], o[2]) for o in ops] == [(t.data_ptr(), t.stride()) for t in (q, k, v)]
    assert vec == (dtype == torch.bfloat16)
    # the temporal layer's (B, M) sequences flattened: still views
    seq = torch.randn(2, 3, 30, C, generator=g).to(dtype)
    tq, tk, tv = (_split_heads(a, heads, dh).flatten(0, 1) for a in (seq @ w_qkv.t()).chunk(3, -1))
    assert window_attn.window_attention_operands(tq, tk, tv)[0][2][0] is tv
    # an operand whose last dim is strided is copied
    qt = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    (qo, qp, qs), *_ = window_attn.window_attention_operands(qt, k, v)[0]
    assert qo is not qt and qs[-1] == 1 and qp == qo.data_ptr() and torch.equal(qo, qt)


def test_window_attention_output_merges_heads_as_a_view():
    g = torch.Generator().manual_seed(4)
    BW, H, N, D = 4, 8, 64, 32
    q, k, v = (torch.randn(BW, H, N, D, generator=g) for _ in range(3))
    bias = 0.1 * torch.randn(H, N, N, generator=g)
    masks = torch.from_numpy(_shifted_window_mask(8, 8, 8, (4, 4, 4), (2, 2, 2))[:2].copy())
    mask = (masks, torch.tensor([0, 1], dtype=torch.int32))
    want = window_attn.window_attention_plain(q, k, v, bias, mask)
    out = window_attn.window_attention_output(q)
    assert out.shape == (BW, H, N, D) and out.permute(0, 2, 1, 3).is_contiguous()
    out.copy_(want)  # the kernel's writes, in its (BW, N, H, D) order
    merged = _merge_heads(out)
    assert merged.data_ptr() == out.data_ptr() and merged.is_contiguous()  # a view
    assert torch.equal(merged, _merge_heads(want))


def test_bias_mask_table_holds_what_the_reference_adds():
    """Kernel 1's bf16 body adds bf16(bias + mask) to its scores, as the
    reference (``window_attention``) casts their sum to the compute dtype."""
    g = torch.Generator().manual_seed(5)
    bias = 0.1 * torch.randn(8, 27, 27, generator=g)
    masks = torch.from_numpy(_shifted_window_mask(6, 6, 6, (3, 3, 3), (1, 1, 1)))
    uniq = torch.unique(masks.reshape(masks.shape[0], -1), dim=0).reshape(-1, 27, 27)
    table = fused_stw.bias_mask_table(bias, uniq)
    assert table.shape == (uniq.shape[0], 8, 64, 64) and table.dtype == torch.bfloat16
    assert torch.equal(table[..., :27, :27], (bias[None] + uniq[:, None]).to(torch.bfloat16))
    assert torch.equal(fused_stw.bias_mask_table(bias)[0, :, :27, :27], bias.to(torch.bfloat16))
    # padding keys and rows: -inf, so the kernel's softmax gives them no weight
    assert (table[..., 27:] == float("-inf")).all() and (table[..., 27:, :] == float("-inf")).all()


def test_relative_position_biases_are_contiguous_by_head():
    """The bias tables the layers give their kernels are (heads, N, N)
    contiguous, so kernel 12 reads each head's rows in place."""
    from extdm_tpu_torch.nn.attention import RelativePositionBias, WindowAttention3D

    wa = WindowAttention3D(16, (4, 4, 4), heads=8, dim_head=8)
    table = wa.relative_position_bias_table
    idx = torch.as_tensor(_relative_position_index((4, 4, 4)))
    b = wa.bias_hnn(64)
    assert b.is_contiguous() and torch.equal(b, table[idx].permute(2, 0, 1))
    rp = RelativePositionBias(heads=8, max_distance=32)
    t = rp.bias(30)
    assert t.is_contiguous() and t.shape == (8, 30, 30)
