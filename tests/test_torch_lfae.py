"""Port LFAE (extdm_tpu_torch.models.dm.flow_diffusion.LFAE) against the JAX
LFAE at a tiny config (32 px, 3 regions, block_expansion 8), float32.

Weights are drawn from a numpy seed into the JAX variable tree (its shapes
from ``jax.eval_shape`` of the init, so BatchNorm statistics, the bg head
and the norms are all non-trivial) and reach the port through
``convert.lfae_state_dict``. Tolerance 1e-4: the region softmax runs at
temperature 0.1 and the flow passes through several warps, so float32
summation-order differences grow a little. The JAX side runs under
``jax.jit``: one compiled program per call is far quicker on the CPU than
an eager apply, which compiles every primitive on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.dm.flow_diffusion import LFAE as JLFAE
from extdm_tpu_torch import convert
from extdm_tpu_torch.models.dm.flow_diffusion import LFAE
from torch_port_helpers import close, random_variables, tiny_flow_params

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    tc, T = 2, 4
    jl = JLFAE(flow_params=tiny_flow_params())
    shapes = jax.eval_shape(lambda v: jl.init(jax.random.PRNGKey(0), v, tc),
                            jnp.zeros((1, T, 32, 32, 3)))
    variables = random_variables(dict(shapes), 1)
    port = LFAE(tiny_flow_params()).eval()
    port.load_state_dict(convert.lfae_state_dict(variables))
    video = np.random.default_rng(2).uniform(size=(2, T, 32, 32, 3)).astype(np.float32)
    return jl, variables, port, video, tc


def test_encode_video(models):
    jl, variables, port, video, tc = models
    ref = jax.jit(lambda v, vid: jl.apply(v, vid, tc, method=JLFAE.encode_video))(
        variables, jnp.asarray(video))
    with torch.no_grad():
        out = port.encode_video(torch.from_numpy(video), tc)
    close(out["flow"], ref["flow"], TOL)
    close(out["conf"], ref["conf"], TOL)
    for k in ("shift", "covar", "affine"):
        close(out["source_region_params"][k], ref["source_region_params"][k], TOL)


def test_encode_video_with_decode(models):
    """The full-mode encode: besides the flow and conf, every frame
    reconstructed (out_vid) and the reference frame warped to it
    (warped_vid)."""
    jl, variables, port, video, tc = models
    ref = jax.jit(lambda v, vid: jl.apply(v, vid, tc, True, method=JLFAE.encode_video))(
        variables, jnp.asarray(video))
    with torch.no_grad():
        out = port.encode_video(torch.from_numpy(video), tc, with_decode=True)
    for k in ("flow", "conf", "out_vid", "warped_vid"):
        assert out[k].shape == ref[k].shape, k
        close(out[k], ref[k], TOL)


def test_ref_features(models):
    jl, variables, port, video, tc = models
    ref = jax.jit(lambda v, vid: jl.apply(v, vid, tc, 2, method=JLFAE.ref_features))(
        variables, jnp.asarray(video))
    with torch.no_grad():
        out = port.ref_features(torch.from_numpy(video), tc, 2)
    assert out.shape == ref.shape
    close(out, ref, TOL)


def test_decode_flows(models):
    jl, variables, port, video, tc = models
    rng = np.random.default_rng(3)
    flow = rng.uniform(-1.1, 1.1, size=(2, 3, 16, 16, 2)).astype(np.float32)
    conf = rng.uniform(size=(2, 3, 16, 16, 1)).astype(np.float32)
    ref_img = video[:, tc - 1]
    ref = jax.jit(lambda v, *a: jl.apply(v, *a, method=JLFAE.decode_flows))(
        variables, *map(jnp.asarray, (ref_img, flow, conf)))
    with torch.no_grad():
        out = port.decode_flows(torch.from_numpy(ref_img), torch.from_numpy(flow),
                                torch.from_numpy(conf))
    close(out["out_vid"], ref["out_vid"], TOL)
    close(out["warped_vid"], ref["warped_vid"], TOL)
