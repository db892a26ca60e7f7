"""Port ops (extdm_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both packages; float32
throughout. Tolerances: 1e-5 for elementwise/closed-form ops (only the
summation order differs), 2e-5 for the convolution-based antialias.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.ops import antialias as j_antialias
from extdm_tpu.ops import coords as j_coords
from extdm_tpu.ops import eigh2x2 as j_eigh
from extdm_tpu.ops import pallas_warp
from extdm_tpu.ops import resize as j_resize
from extdm_tpu.ops import warp as j_warp
from extdm_tpu_torch.ops import antialias, coords, eigh2x2, fused_warp, resize

RNG = np.random.default_rng(0)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_coordinate_grid_and_homogeneous():
    close(coords.make_coordinate_grid(5, 7), j_coords.make_coordinate_grid(5, 7), 0)
    x = RNG.normal(size=(2, 3, 4, 2)).astype(np.float32)
    h = coords.to_homogeneous(torch.from_numpy(x))
    close(h, j_coords.to_homogeneous(jnp.asarray(x)), 0)
    close(coords.from_homogeneous(h * 1.5), j_coords.from_homogeneous(jnp.asarray(h.numpy() * 1.5)),
          1e-6)


@pytest.mark.parametrize("covar_kind", ["scalar", "matrix"])
def test_region2gaussian(covar_kind):
    center = RNG.uniform(-0.8, 0.8, size=(2, 3, 2)).astype(np.float32)
    if covar_kind == "scalar":
        covar = 0.01
        jcov = covar
    else:
        a = RNG.normal(size=(2, 3, 2, 2)).astype(np.float32) * 0.2
        covar = torch.from_numpy(a @ a.transpose(0, 1, 3, 2) + 0.01 * np.eye(2, dtype=np.float32))
        jcov = jnp.asarray(covar.numpy())
    out = coords.region2gaussian(torch.from_numpy(center), covar, (6, 5))
    ref = j_coords.region2gaussian(jnp.asarray(center), jcov, (6, 5))
    close(out, ref, 1e-5)


@pytest.mark.parametrize("size,align", [((16, 12), False), ((4, 6), False), ((16, 12), True)])
def test_interpolate_bilinear(size, align):
    x = RNG.normal(size=(2, 3, 8, 6, 5)).astype(np.float32)
    out = resize.interpolate_bilinear(torch.from_numpy(x), size, align_corners=align)
    ref = j_resize.interpolate_bilinear(jnp.asarray(x), size, align_corners=align)
    close(out, ref, 1e-5)


def test_upsample_and_pool():
    x = RNG.normal(size=(2, 4, 6, 3)).astype(np.float32)
    close(resize.upsample_nearest(torch.from_numpy(x)), j_resize.upsample_nearest(jnp.asarray(x)), 0)
    close(resize.avg_pool_2x2(torch.from_numpy(x)), j_resize.avg_pool_2x2(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("scale", [0.5, 0.25])
def test_antialias_downsample(scale):
    x = RNG.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    out = antialias.antialias_downsample(torch.from_numpy(x), scale)
    ref = j_antialias.antialias_downsample(jnp.asarray(x), scale)
    close(out, ref, 2e-5)


def test_eigh2x2_sqrt_and_inverse():
    a = RNG.normal(size=(4, 5, 2, 2)).astype(np.float32)
    covar = a @ a.transpose(0, 1, 3, 2)
    covar[0, 0] = np.eye(2) * 0.3  # degenerate eigengap
    u, s = eigh2x2.eigh_2x2(torch.from_numpy(covar))
    ju, js = j_eigh.eigh_2x2(jnp.asarray(covar))
    close(u, ju, 1e-5)
    close(s, js, 1e-5)
    close(eigh2x2.sqrt_symmetric_2x2(torch.from_numpy(covar)),
          j_eigh.sqrt_symmetric_2x2(jnp.asarray(covar)), 1e-5)
    close(eigh2x2.inv_2x2(torch.from_numpy(a)), j_eigh.inv_2x2(jnp.asarray(a)), 1e-4)


@pytest.mark.parametrize("mode", ["zeros", "border", "reflection"])
def test_grid_sample_plain_matches_jax(mode):
    """Port plain grid sample vs the JAX gather path and the Pallas kernel
    (interpret mode), odd channel count, grid reaching past the border."""
    image = RNG.normal(size=(2, 32, 32, 5)).astype(np.float32)
    grid = RNG.uniform(-1.3, 1.3, size=(2, 8, 16, 2)).astype(np.float32)
    out = fused_warp.grid_sample_plain(torch.from_numpy(image), torch.from_numpy(grid), mode)
    ref_xla = j_warp.grid_sample_xla(jnp.asarray(image), jnp.asarray(grid), mode)
    ref_pallas = pallas_warp.grid_sample(jnp.asarray(image), jnp.asarray(grid), mode,
                                         interpret=True)
    close(out, ref_xla, 1e-5)
    close(out, ref_pallas, 1e-5)


def test_grid_sample_matches_torch_functional():
    """The plain version is torch's own grid_sample(align_corners=True) semantics."""
    image = RNG.normal(size=(3, 9, 7, 67)).astype(np.float32)
    grid = RNG.uniform(-1.2, 1.2, size=(3, 5, 6, 2)).astype(np.float32)
    for mode in ("zeros", "border", "reflection"):
        out = fused_warp.grid_sample_plain(torch.from_numpy(image), torch.from_numpy(grid), mode)
        ref = torch.nn.functional.grid_sample(
            torch.from_numpy(image).permute(0, 3, 1, 2), torch.from_numpy(grid), mode="bilinear",
            padding_mode=mode, align_corners=True).permute(0, 2, 3, 1)
        close(out, ref, 1e-5)
