"""Shared pieces of the tests/test_torch_*.py parity tests: a tiny LFAE
config and seeded weights for a JAX variable tree."""
import copy

import jax
import numpy as np

# tests/test_scripts.py's shrink of the LFAE: 3 regions, block_expansion 8.
TINY_FLOW_PARAMS = dict(
    num_regions=3, num_channels=3, estimate_affine=True, revert_axis_swap=True,
    bg_predictor_params=dict(block_expansion=8, max_features=16, num_blocks=2, bg_type="affine"),
    region_predictor_params=dict(temperature=0.1, block_expansion=8, max_features=16,
                                 scale_factor=0.5, num_blocks=2, pca_based=True, pad=0),
    generator_params=dict(block_expansion=8, max_features=32, num_down_blocks=2,
                          num_bottleneck_blocks=1, skips=True,
                          pixelwise_flow_predictor_params=dict(
                              block_expansion=8, max_features=16, num_blocks=2,
                              scale_factor=0.5, use_deformed_source=True,
                              use_covar_heatmap=True, estimate_occlusion_map=True)),
)


def tiny_flow_params():
    return copy.deepcopy(TINY_FLOW_PARAMS)


def random_variables(shapes, seed):
    """Seeded values for a tree of ShapeDtypeStructs (from jax.eval_shape of
    an init): kernels uniform in +-1/sqrt(fan_in), norm scales near 1,
    variances in [0.5, 1.5], everything else small."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        name, shape = str(path[-1]), leaf.shape
        if name == "['kernel']":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            a = rng.uniform(-bound, bound, size=shape)
        elif name == "['var']":
            a = rng.uniform(0.5, 1.5, size=shape)
        elif name in ("['scale']", "['gamma']", "['alpha']", "['beta']"):
            a = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            a = 0.05 * rng.normal(size=shape)
        out.append(a.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def he_scaled(variables):
    """Conv kernels (4-D and 5-D) of a ``random_variables`` tree scaled by
    sqrt(6), to He's variance: deep random networks (VGG19, I3D) then keep
    their signal's size instead of fading to an input-independent output."""
    return jax.tree_util.tree_map(lambda a: a * np.float32(np.sqrt(6.0)) if a.ndim >= 4 else a,
                                  variables)
