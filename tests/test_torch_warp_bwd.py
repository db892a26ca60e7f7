"""Backward of the port's grid sample (kernel 8's plain version and the
autograd wiring of ``fused_warp.grid_sample``) against the JAX package, on
the CPU, float32.

The reference is ``jax.vjp`` of ``pallas_warp.grid_sample(..., interpret=True)``,
which runs the JAX package's Pallas backward kernel (``_grid_sample_bwd_impl``)
in interpret mode; its index split needs a power-of-two W. Tolerance 1e-5 of
max(1, max|reference|) on each gradient: float32 sums in another order, and
d_grid sums up to 67 channels with cancellation, times 0.5 (W - 1). The
plain autograd and the Pallas kernel differ only where a coordinate lands
exactly on a clamp or fold boundary (border / reflection modes); uniform
random grids do not hit those points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.ops import pallas_warp
from extdm_tpu_torch.ops import fused_warp
from torch_port_helpers import close

TOL = 1e-5


def _jax_vjp(image, grid, g, mode):
    fn = jax.jit(lambda im, gr, ct: jax.vjp(
        lambda a, b: pallas_warp.grid_sample(a, b, mode, interpret=True), im, gr)[1](ct))
    return fn(jnp.asarray(image), jnp.asarray(grid), jnp.asarray(g))


@pytest.mark.parametrize("image_shape,grid_hw,mode", [
    ((2, 16, 16, 5), (8, 16), "zeros"),
    ((2, 16, 16, 5), (8, 16), "border"),
    ((2, 16, 16, 5), (8, 16), "reflection"),
    ((22, 32, 32, 3), (32, 32), "zeros"),     # the K+1 sparse warp's shape
    ((2, 16, 16, 67), (16, 16), "zeros"),     # the merged skip0 + source warp's C
])
def test_plain_vjp_matches_pallas_bwd(image_shape, grid_hw, mode):
    rng = np.random.default_rng(sum(image_shape) + len(mode))
    B, C = image_shape[0], image_shape[-1]
    image = rng.normal(size=image_shape).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(B, *grid_hw, 2)).astype(np.float32)
    g = rng.normal(size=(B, *grid_hw, C)).astype(np.float32)
    want = _jax_vjp(image, grid, g, mode)
    got = fused_warp.grid_sample_plain_vjp(torch.from_numpy(g), torch.from_numpy(image),
                                           torch.from_numpy(grid), mode)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL * max(1.0, np.abs(b).max()))


def test_bwd_wrapper_on_cpu_takes_plain_vjp_and_honours_flags():
    rng = np.random.default_rng(3)
    image = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1, 1, size=(2, 4, 6, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 4, 6, 4)).astype(np.float32))
    before = fused_warp.grid_sample_bwd.launches
    want = fused_warp.grid_sample_plain_vjp(g, image, grid, "border")
    d_image, d_grid = fused_warp.grid_sample_bwd(g, image, grid, "border")
    assert torch.equal(d_image, want[0]) and torch.equal(d_grid, want[1])
    assert fused_warp.grid_sample_bwd(g, image, grid, "border", image_grad=False)[0] is None
    assert fused_warp.grid_sample_bwd(g, image, grid, "border", grid_grad=False)[1] is None
    assert fused_warp.grid_sample_bwd.launches == before


@pytest.mark.parametrize("image_needs_grad", [True, False])
def test_autograd_function_routes_backward_through_grid_sample_bwd(monkeypatch,
                                                                   image_needs_grad):
    """The Function that wraps the kernel on the card: its backward calls
    grid_sample_bwd with the flags autograd asks for, and its gradients are
    the plain version's. The forward kernel is swapped for the plain version
    so that the Function runs on the CPU."""
    rng = np.random.default_rng(4)
    image = torch.from_numpy(rng.normal(size=(2, 8, 8, 3)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, size=(2, 5, 7, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 5, 7, 3)).astype(np.float32))
    calls = []
    real_bwd = fused_warp.grid_sample_bwd

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real_bwd(*args, **kwargs)

    monkeypatch.setattr(fused_warp, "_grid_sample_forward", fused_warp.grid_sample_plain)
    monkeypatch.setattr(fused_warp, "grid_sample_bwd", spy)
    im = image.clone().requires_grad_(image_needs_grad)
    gr = grid.clone().requires_grad_(True)
    out = fused_warp._GridSample.apply(im, gr, "reflection")
    assert out.grad_fn is not None
    out.backward(g)
    assert calls == [dict(image_grad=image_needs_grad, grid_grad=True)]
    want = fused_warp.grid_sample_plain_vjp(g, image, grid, "reflection")
    close(gr.grad, want[1], 0)
    if image_needs_grad:
        close(im.grad, want[0], 0)
    else:
        assert im.grad is None
