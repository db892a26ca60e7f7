"""The frozen cost functions against counts worked by hand at small shapes,
the flop counter's conventions, and the roofline share's guard."""
import math

import pytest
import torch

from portbench import harness
from portbench.cost import kernels
from portbench.cost.flops import sample_flops, train_flops
from portbench.tests import tiny

BF16 = torch.bfloat16


def t(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype)


def test_stw_cost_by_hand():
    # 2 x 4 x 4 x 4 tokens of 32 channels, 2 heads of 8, windows of 2x2x2
    x = t(2, 4, 4, 4, 32)
    bias = t(2, 8, 8, dtype=torch.float32)
    byts, flops, dtype = kernels.stw_cost(x, t(32), t(48, 32), t(32, 16), t(32), bias,
                                          window=(2, 2, 2), shift=(1, 1, 1), heads=2, dim_head=8)
    n = 2 * 4 * 4 * 4
    assert flops == 2 * n * 32 * 48 + 4 * n * 8 * 16 + 2 * n * 16 * 32 == 589824
    assert byts == (2 * n * 32 + 48 * 32 + 32 * 16) * 2 + 2 * 8 * 8 * 4
    assert dtype is BF16


def test_temporal_cost_by_hand():
    x = t(1, 6, 2, 3, 32)
    byts, flops, _ = kernels.temporal_cost(x, t(32), t(32), t(32), t(48, 32), t(32, 16),
                                           t(2, 6, 6, dtype=torch.float32), heads=2, dim_head=8)
    n = 6 * 2 * 3
    assert flops == 2 * n * 32 * 48 + 4 * n * 6 * 16 + 2 * n * 16 * 32
    assert byts == (2 * n * 32 + 48 * 32 + 32 * 16) * 2 + 2 * 6 * 6 * 4


def test_resnet_cost_by_hand():
    x = t(1, 2, 4, 4, 16)
    args = (t(32, 16, 1, 3, 3), t(32), t(32), t(32), None, t(32, 32, 1, 3, 3), t(32), t(32), t(32))
    byts, flops, _ = kernels.resnet_cost(x, *args, t(32, 16, 1, 1, 1), t(32))
    P = 2 * 4 * 4
    assert flops == 2 * P * 9 * (16 * 32 + 32 * 32) + 2 * P * 16 * 32
    assert byts == (P * 16 + P * 32 + 32 * 16 * 9 + 32 * 32 * 9 + 32 * 16) * 2
    no_res = kernels.resnet_cost(t(1, 2, 4, 4, 32), t(32, 32, 1, 3, 3), t(32), t(32), t(32), None,
                                 t(32, 32, 1, 3, 3), t(32), t(32), t(32))[1]
    assert no_res == 2 * P * 9 * (32 * 32 + 32 * 32)


def test_warp_cost_by_hand():
    byts, flops, dtype = kernels.warp_cost(t(2, 8, 8, 3), t(2, 4, 5, 2, dtype=torch.float32))
    out = 2 * 4 * 5 * 3
    assert flops == 8 * out and dtype is torch.float32
    assert byts == 2 * 8 * 8 * 3 * 2 + 2 * 4 * 5 * 2 * 4 + out * 2


def test_grad_cost_is_three_forwards_less_the_output_projection():
    x = t(2, 4, 4, 4, 32)
    args = (t(32), t(48, 32), t(32, 16), t(32), t(2, 8, 8, dtype=torch.float32))
    kw = dict(window=(2, 2, 2), shift=(0, 0, 0), heads=2, dim_head=8)
    fb, ff, _ = kernels.stw_cost(x, *args, **kw)
    gb, gf, _ = kernels.BACKWARD["stw_layer_bwd"](x, x, *args, **kw)
    n = x.numel() // 32
    assert gf == 3 * ff - 2 * n * 16 * 32
    assert gb == fb + x.numel() * 2 + (48 * 32 + 32 * 16 + 2 * 8 * 8) * 4  # and the bias table


def test_bound_is_the_larger_of_compute_and_bytes():
    assert kernels.bound_seconds(3.35e12, 989e12, BF16) == pytest.approx(1.0)
    assert kernels.bound_seconds(6.7e12, 989e12, BF16) == pytest.approx(2.0)
    assert kernels.bound_seconds(0, 67e12, torch.float32) == pytest.approx(1.0)


def test_share_never_runs_above_its_bound():
    assert kernels.share(1.0, 4.0) == pytest.approx(25.0)
    assert kernels.share(1.0, 0.0) is None
    with pytest.raises(ValueError):
        kernels.share(1.0, 0.5)


def test_flop_counter_counts_two_flops_a_multiply_add():
    from torch.utils.flop_counter import FlopCounterMode

    conv = torch.nn.Conv3d(4, 6, (1, 3, 3), padding=(0, 1, 1), device="meta")
    x = torch.empty(2, 4, 3, 5, 5, device="meta")
    with FlopCounterMode(display=False) as c:
        conv(x)
    assert c.get_total_flops() == 2 * (2 * 3 * 5 * 5) * 6 * 4 * 9


def test_model_flops_are_linear_in_rows_and_steps():
    m = tiny.MODEL
    one = sample_flops(m, 1)
    assert sample_flops(m, 5) == pytest.approx(5 * one)
    more = dict(m, sampling_timesteps=m["sampling_timesteps"] + 1)
    step = sample_flops(more, 1) - one
    assert 0 < step < one
    assert math.isclose(sample_flops(dict(m, sampling_timesteps=1), 1) + 2 * step, one,
                        rel_tol=1e-9)
    assert train_flops(m, 4) == pytest.approx(4 * train_flops(m, 1))
    # forward and backward of the denoiser: about three of its forwards
    assert 2.5 * step < train_flops(m, 1) < 3.5 * step + one


# Model flops of a unit of each cell (flop counter over the reference at the
# cells' sizes): a KTH and a Cityscapes sampler call of 100 rows, a train
# step of 24 clips.
UNIT_FLOPS = {"kth-sample-traj100": 217.5449e12, "city-sample-traj100": 56.3594e12,
              "kth-train-b24": 23.8758e12}


@pytest.mark.parametrize("cell", sorted(UNIT_FLOPS))
def test_unit_flops_of_the_cells_stay(cell):
    run = harness.make_run(cell, 1, 1.0, False, "cpu")
    assert harness.driver(run).unit_flops(run) == pytest.approx(UNIT_FLOPS[cell], rel=1e-4)


def test_trajwarp_cost_by_hand():
    # B 2, tc 3, tp 2, features 2 x 4 of 16 channels in 4 heads; queries at 4 x 8
    xp, f = t(2, 2, 4, 8, 16), t(2, 5, 2, 4, 16, dtype=torch.float32)
    byts, flops, dtype = kernels.trajwarp_cost(xp, f, heads=4)
    nq, nk = 2 * 2 * 8, 2 * 3 * 8
    assert flops == (2 * nq * 256 + 4 * nk * 256 + 4 * 2 * 16 * 24 * 16 + 2 * nq * 256
                     + 4 * nq * 256)
    weights = 4 * (256 + 16) + 2 * 256 + 16
    assert byts == (2 * 2 * 4 * 8 * 16 + weights + 2 * 5 * 8 * 16) * 2 + 2 * 5 * 8 * 16 * 4
    assert dtype is BF16
    with pytest.raises(ValueError):
        kernels.trajwarp_cost(xp, f, heads=3)
