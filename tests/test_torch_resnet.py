"""Port resnet block (extdm_tpu_torch.ops.fused_resnet and the UNet's
ResnetBlock3d) against the JAX package, on the CPU, float32.

The plain version is held against ``pallas_resnet.resnet_block_reference``
and the Pallas kernel in interpret mode to 2e-5 (the JAX package's own
kernel-vs-reference bound in tests/test_pallas_resnet.py); the module
against the flax module to 1e-4 (GroupNorm over a whole sample, summed in a
different order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu.models.dm import unet3d as j_unet
from extdm_tpu.ops import pallas_resnet
from extdm_tpu_torch import convert
from extdm_tpu_torch.models.dm import unet3d
from extdm_tpu_torch.ops import fused_resnet


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _params(cin, cout, B, film, res, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = dict(w1=0.1 * f(1, 3, 3, cin, cout), b1=0.1 * f(cout), g1s=1 + 0.1 * f(cout),
             g1b=0.1 * f(cout), film=0.2 * f(B, 2 * cout) if film else None,
             w2=0.1 * f(1, 3, 3, cout, cout), b2=0.1 * f(cout), g2s=1 + 0.1 * f(cout),
             g2b=0.1 * f(cout), wres=None, bres=None)
    if res:
        p["wres"], p["bres"] = 0.1 * f(cin, cout), 0.1 * f(cout)
    return p


@pytest.mark.parametrize("shape,cout,groups,film", [
    ((2, 3, 8, 8, 16), 16, 4, True),     # identity residual + FiLM
    ((2, 3, 8, 8, 16), 32, 8, True),     # residual projection
    ((1, 2, 4, 4, 24), 16, 8, False),    # no FiLM, tiny frame
    ((1, 5, 4, 8, 16), 16, 4, True),     # H != W
])
def test_resnet_plain_matches_reference_and_interpret(shape, cout, groups, film):
    cin = shape[-1]
    p = _params(cin, cout, shape[0], film, cin != cout)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    names = ("w1", "b1", "g1s", "g1b", "film", "w2", "b2", "g2s", "g2b", "wres", "bres")
    jargs = [None if p[k] is None else jnp.asarray(p[k]) for k in names]
    ref = pallas_resnet.resnet_block_reference(jnp.asarray(x), *jargs, groups=groups)
    fused = pallas_resnet.fused_resnet_block(jnp.asarray(x), *jargs, groups=groups,
                                             interpret=True)
    conv = lambda w: torch.from_numpy(convert.conv_weight(w).copy())  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    wres = None if p["wres"] is None else conv(p["wres"][None, None, None])
    out = fused_resnet.fused_resnet_block(
        t(x), conv(p["w1"]), t(p["b1"]), t(p["g1s"]), t(p["g1b"]), t(p["film"]), conv(p["w2"]),
        t(p["b2"]), t(p["g2s"]), t(p["g2b"]), wres, t(p["bres"]), groups=groups)
    close(out, ref, 2e-5)
    close(out, fused, 2e-5)


@pytest.mark.parametrize("cin,cout,time", [(16, 16, True), (16, 32, True), (32, 16, False)])
def test_resnet_module_matches_flax(cin, cout, time):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 8, 8, cin)).astype(np.float32)
    temb = rng.normal(size=(2, 24)).astype(np.float32) if time else None
    jt = None if temb is None else jnp.asarray(temb)
    mod = j_unet.ResnetBlock3d(cout, groups=8)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jt)
    ref = mod.apply(variables, jnp.asarray(x), jt)
    b = convert._Builder({"m": jax.tree_util.tree_map(np.asarray, variables["params"])})
    b.resnet("m", "x")
    port = unet3d.ResnetBlock3d(cin, cout, 24 if time else None, groups=8)
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in b.sd.items()})
    out = port(torch.from_numpy(x), None if temb is None else torch.from_numpy(temb))
    close(out.detach(), ref, 1e-4)
