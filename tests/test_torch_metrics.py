"""Port metrics (extdm_tpu_torch.metrics) against the JAX package's, on the CPU.

- PSNR and SSIM, variants 1/2/3, in float64: 1e-10 (the JAX side runs its
  own float64 numpy, or its C++ SSIM in double on the same float32 inputs).
- ``frechet_distance`` (with its non-finite short-circuit),
  ``calculate_fvd2`` and ``best_trajectory_by_feature_distance``: exact, on
  the same numpy features.
- LPIPS (AlexNet + heads) and the I3D features against the flax modules on
  the same weights (``convert.lpips_state_dict`` / ``i3d_state_dict``),
  float32: LPIPS 1e-5, I3D features 1e-4 of max(1, max|feature|), at the
  small sizes of tests/test_metrics.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu import metrics as jm
from extdm_tpu.metrics.i3d import InceptionI3d as JInceptionI3d
from extdm_tpu_torch import convert, metrics
from extdm_tpu_torch.metrics import fvd
from torch_port_helpers import he_scaled, random_variables


def _vids(seed, n=4, t=3, c=3, h=32, w=32):
    return np.random.RandomState(seed).rand(n, t, c, h, w).astype(np.float32)


@pytest.mark.parametrize("layout", ["tchw", "thwc"])
def test_psnr_matches_jax(layout):
    v1, v2 = _vids(1), _vids(2)
    v2[0] = v1[0]  # a capped frame
    if layout == "thwc":
        v1, v2 = v1.transpose(0, 1, 3, 4, 2), v2.transpose(0, 1, 3, 4, 2)
    np.testing.assert_allclose(metrics.calculate_psnr3(v1, v2), jm.calculate_psnr3(v1, v2),
                               rtol=1e-10, atol=0)
    got, want = metrics.calculate_psnr1(v1, v2), jm.calculate_psnr1(v1, v2)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-10, atol=1e-12)
    assert abs(metrics.calculate_psnr2(v1, v2, 2) - jm.calculate_psnr2(v1, v2, 2)) <= 1e-10


@pytest.mark.parametrize("c", [3, 1])
def test_ssim_matches_jax(c):
    v1, v2 = _vids(3, c=c), _vids(4, c=c)
    v2[1] = np.clip(v1[1] + 0.05, 0, 1)
    np.testing.assert_allclose(metrics.calculate_ssim3(v1, v2), jm.calculate_ssim3(v1, v2),
                               rtol=0, atol=1e-10)
    got, want = metrics.calculate_ssim1(v1, v2), jm.calculate_ssim1(v1, v2)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-10)
    assert abs(metrics.calculate_ssim2(v1, v2, 2) - jm.calculate_ssim2(v1, v2, 2)) <= 1e-10
    with pytest.raises(ValueError, match="channels-first"):
        metrics.calculate_ssim3(v1.transpose(0, 1, 3, 4, 2), v2.transpose(0, 1, 3, 4, 2))


def test_ssim_gray_four_dim_matches_jax():
    v1, v2 = _vids(5, c=1)[:, :, 0], _vids(6, c=1)[:, :, 0]
    np.testing.assert_allclose(metrics.calculate_ssim3(v1, v2), jm.calculate_ssim3(v1, v2),
                               rtol=0, atol=1e-10)


def test_frechet_distance_and_trajectory_selection_match_jax():
    rng = np.random.RandomState(7)
    real = rng.randn(6, 16).astype(np.float32)
    fake = (rng.randn(6, 16) + 0.3).astype(np.float32)
    assert metrics.frechet_distance(fake, real) == jm.frechet_distance(fake, real)
    assert metrics.calculate_fvd2(fake, real) == jm.calculate_fvd2(fake, real)
    assert metrics.frechet_distance(fake[:1], real) == jm.frechet_distance(fake[:1], real)
    bad = fake.copy()
    bad[2, 3] = np.nan
    with pytest.warns(UserWarning, match="non-finite"):
        assert np.isnan(metrics.frechet_distance(bad, real))
    traj = np.repeat(real, 3, axis=0) + rng.randn(18, 16).astype(np.float32)
    traj[4] = real[1]
    got = metrics.best_trajectory_by_feature_distance(real, traj, 3)
    np.testing.assert_array_equal(got, jm.best_trajectory_by_feature_distance(real, traj, 3))
    assert got[1] == 1


def test_lpips_matches_flax():
    jmetric = jm.LPIPSMetric(seed=0)
    params = jax.tree_util.tree_map(np.asarray, jmetric.params)
    port = metrics.LPIPSMetric(convert.lpips_state_dict(params), device="cpu")
    assert port.pretrained and not metrics.LPIPSMetric(device="cpu").pretrained
    rng = np.random.RandomState(8)
    v1 = rng.rand(4, 2, 32, 32, 3).astype(np.float32)
    v2 = np.clip(v1 + 0.2 * rng.randn(*v1.shape), 0, 1).astype(np.float32)
    want = jmetric.calculate_lpips3(v1, v2)
    np.testing.assert_allclose(port.calculate_lpips3(v1, v2), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    assert abs(port.calculate_lpips2(v1, v2, 2) - jmetric.calculate_lpips2(v1, v2, 2)) <= 1e-5
    got, ref = port.calculate_lpips1(v1, v2), jmetric.calculate_lpips1(v1, v2)
    np.testing.assert_allclose(got[0]["lpips"], ref[0]["lpips"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.calculate_lpips3(v1, v1), 0.0, atol=1e-6)


def test_preprocess_videos_matches_jax():
    v = np.random.RandomState(12).rand(1, 4, 36, 64, 3).astype(np.float32)
    got = fvd.preprocess_videos(torch.from_numpy(v))
    assert got.shape == (1, 4, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.preprocess_videos(jnp.asarray(v))),
                               rtol=0, atol=1e-5)


def test_i3d_features_match_flax():
    """8-frame clips: the final pool runs with the clamped temporal kernel
    (T' = 1). Random He-scaled weights in the flax tree (seeded), converted;
    the two videos' features differ by much more than the bound."""
    model = JInceptionI3d()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 224, 224, 3)))
    variables = he_scaled(random_variables(dict(shapes), 13))
    v = np.random.RandomState(21).rand(2, 8, 32, 32, 3).astype(np.float32)
    want = jm.I3DExtractor(params=variables).get_feats(v)
    assert np.abs(want[0] - want[1]).max() > 0.01 * np.abs(want).max()
    port = metrics.I3DExtractor(convert.i3d_state_dict(variables), device="cpu")
    got = port.get_feats(v)
    assert got.shape == want.shape == (2, 400) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))
