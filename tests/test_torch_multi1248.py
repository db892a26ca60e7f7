"""The ``multi1248/ada`` UNet (dim_mults (1, 2, 4, 8), 512 channels at the
deepest level and in the mid blocks at full width) of the port against the
JAX package, on the CPU, float32, at dim 8 on converted weights: the
Unet3D forward within 2e-4 (the JAX package's own parity bound with the
reference, IMPLEMENTATION_NOTES.md:184).

At dim 8 no layer reaches the kernels' 256-channel limit, so the test
lowers the limit to 32 channels: the 64-channel layers (the deepest level's
two window layers and its temporal layer, the mid block's two window
layers) then take the unfused route through kernel 12's wrapper, as the
512-channel layers do at full width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu_torch import convert
from extdm_tpu_torch.config import ARCH_PRESETS, kth_multi1248_config, kth_sampling_config
from extdm_tpu_torch.models.dm import unet3d
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from extdm_tpu_torch.ops import fused_stw
from torch_port_helpers import close, random_variables, tiny_flow_params

CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=1000, sampling_timesteps=3,
           dim=8, attn_heads=2, attn_dim_head=8, **ARCH_PRESETS["multi1248/ada"])


def test_multi1248_preset():
    cfg = kth_multi1248_config()
    assert cfg.dim_mults == (1, 2, 4, 8) and cfg.conditioning == "adaptor"
    assert cfg.use_ref_features and cfg.dim * max(cfg.dim_mults) == 512
    assert cfg == kth_sampling_config(dim_mults=(1, 2, 4, 8))


def test_multi1248_unet_forward_matches_jax(monkeypatch):
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    unet_vars = {"params": random_variables(dict(shapes[1]["params"]), 5)}
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **CFG), device="cpu")
    fd.unet.load_state_dict(convert.unet_state_dict(unet_vars["params"]))
    rng = np.random.default_rng(6)
    tc, tp = CFG["cond_frames"], CFG["pred_frames"]
    x = rng.normal(size=(2, tp, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, tc, 16, 16, 3)).astype(np.float32)
    fea = rng.normal(size=(2, tc + tp, 8, 8, 32)).astype(np.float32)
    t = np.array([999, 40], np.int32)
    ref = jax.jit(jfd.unet.apply)(unet_vars, *map(jnp.asarray, (x, t, cond, fea)))

    monkeypatch.setattr(fused_stw, "MAX_CHANNELS", 32)
    routes = []
    route = unet3d.stw_route
    monkeypatch.setattr(unet3d, "stw_route",
                        lambda C, *a, **k: routes.append((C, route(C, *a, **k))) or routes[-1][1])
    with torch.no_grad():
        out = fd.unet(*(torch.from_numpy(a) for a in (x, t, cond, fea)))
    close(out, ref, 2e-4)
    unfused = sorted(C for C, r in routes if r == "unfused")
    assert unfused == [64] * 5  # down level 3: 2 window + 1 temporal; mid: 2 window
    assert all(C <= 32 for C, r in routes if r == "fused")
