"""The UNet's index and rotary tables and the diffusion schedule on their
device: the tables kept per shape and device gather what the host tables
gave, bit for bit; each is built (the span ``table_upload``) once; the
schedule's rows on the CPU; and, on a card, a warm sampler call and a
training loss that never synchronize the stream.

On the card: ``python -m pytest --noconftest -m card
tests/test_torch_device_tables.py`` (the test directory's conftest imports
JAX, which the card's machine does not have)."""
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from extdm_tpu_torch.models.dm.diffusion import DiffusionSchedule, GaussianDiffusion, _extract
from extdm_tpu_torch.models.dm.unet3d import Unet3D
from extdm_tpu_torch.nn import attention
from extdm_tpu_torch.nn.attention import (RelativePositionBias, WindowAttention3D,
                                          get_window_size, relative_position_index)
from extdm_tpu_torch.ops import fused_stw, window_attn
from extdm_tpu_torch.utils import profiler

WINDOW = (4, 4, 4)
# (frames T, latent H = W) of the benchmark's configurations; four levels
CONFIGS = {"kth64_u22": (30, 16), "city128_u22": (7, 32)}
CACHES = (attention._window_index, attention._bucket_index, attention.rotary_on,
          fused_stw._rope_pairs, window_attn.mask_tables)


def _tokens(T: int, H: int):
    """Tokens a window at each level of the UNet, the window clamped."""
    return {math.prod(get_window_size((T, H >> i, H >> i), WINDOW)) for i in range(4)}


CASES = sorted({("window", N) for T, H in CONFIGS.values() for N in _tokens(T, H)}
               | {("window", math.prod(get_window_size((2, 16, 16), WINDOW)))}  # T = 2: N = 32
               | {("bucket", T) for T, _ in CONFIGS.values()})


@pytest.fixture(autouse=True)
def fresh_totals():
    profiler.reset()
    yield
    profiler.reset()


@pytest.mark.parametrize("kind,size", CASES)
def test_device_tables_gather_what_the_host_tables_gave(kind, size):
    """bias_hnn(N) and RelativePositionBias.bias(n) against the gather by
    the numpy index copied to the table's device, values and gradients."""
    torch.manual_seed(size)
    if kind == "window":
        module = WindowAttention3D(64, WINDOW, heads=8)
        table, got = module.relative_position_bias_table, module.bias_hnn(size)
        idx = relative_position_index(WINDOW)[:size, :size]
    else:
        module = RelativePositionBias(heads=8, max_distance=32)
        table, got = module.relative_attention_bias.weight, module.bias(size)
        idx = attention._rel_bucket_matrix(size, 32, 32)
    want = table.t()[:, torch.as_tensor(idx, device=table.device)]
    assert got.shape == (8, size, size) and got.is_contiguous()
    assert torch.equal(got, want)
    cot = torch.randn(got.shape)
    (g_got,) = torch.autograd.grad(got, table, cot)
    (g_want,) = torch.autograd.grad(want, table, cot)
    assert torch.equal(g_got, g_want)


def _tiny_unet_call():
    torch.manual_seed(0)
    unet = Unet3D(dim=16, dim_mults=(1, 2), window_size=(2, 2, 2), attn_heads=2,
                  attn_dim_head=4, cond_feature_dim=32, cond_num=2, pred_num=2)
    g = torch.Generator().manual_seed(1)
    x, xc = (torch.randn(1, 2, 8, 8, 3, generator=g) for _ in range(2))
    fea = torch.randn(1, 4, 4, 4, 32, generator=g)
    return lambda: unet(x, torch.tensor([3]), xc, fea)


def test_each_table_is_uploaded_once():
    """A cleared cache records one table_upload per distinct table on the
    first UNet call and none on the second: at T = 4 and windows of 8
    tokens, one window index, one bucket table and rotary tables of 8 and
    4 positions."""
    call = _tiny_unet_call()
    for cache in CACHES:
        cache.cache_clear()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    first = profiler.snapshot()["table_upload"]["calls"]
    assert first == sum(cache.cache_info().currsize for cache in CACHES) == 4
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    assert "table_upload" not in profiler.snapshot()
    assert "unet.forward" in profiler.snapshot()


def test_extract_on_the_cpu_gives_the_table_rows():
    s = DiffusionSchedule.create(100)
    t = torch.tensor([0, 5, 99, 5])
    for name in ("sqrt_alphas_cumprod", "posterior_variance"):
        got = _extract(s, name, t, 5)
        assert got.shape == (4, 1, 1, 1, 1) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.reshape(-1).numpy(), getattr(s, name)[t.numpy()])


@pytest.mark.card
def test_no_synchronize_in_a_warm_sample_or_loss():
    """A tiny bf16 UNet on the kernels' main path (64 and 128 channels, 8
    heads of 32, windows of 64 tokens): after one warm sampler call, a
    second one and a p_losses forward run with the stream never
    synchronized; the schedule rows on the card are the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    unet = Unet3D(dim=64, dim_mults=(1, 2), window_size=WINDOW, attn_heads=8, attn_dim_head=32,
                  cond_feature_dim=64, cond_num=2, pred_num=2, dtype=torch.bfloat16).to(dev)
    diffusion = GaussianDiffusion(DiffusionSchedule.create(1000), sampling_timesteps=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    x_cond, x_pred = (torch.randn(2, 2, 8, 8, 3, generator=gen, device=dev) for _ in range(2))
    fea = torch.randn(2, 4, 4, 4, 64, generator=gen, device=dev)
    with torch.no_grad():
        diffusion.sample(unet, gen, x_cond, 2, fea)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out = diffusion.sample(unet, gen, x_cond, 2, fea)
        loss, _ = diffusion.p_losses(unet, gen, x_cond, x_pred, fea)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert out.shape == x_pred.shape and torch.isfinite(out).all() and torch.isfinite(loss)
    s, t = diffusion.schedule, torch.tensor([0, 5, 999, 5])
    for name in ("sqrt_alphas_cumprod", "posterior_variance"):
        assert torch.equal(_extract(s, name, t.to(dev), 5).cpu(), _extract(s, name, t, 5))
    assert s.pinned("posterior_variance").is_pinned()
