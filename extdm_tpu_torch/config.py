"""Config loading, same YAML schema as the JAX package (port of
extdm_tpu/config.py), plus the KTH sampling preset that ``bench.py`` runs."""
from __future__ import annotations

from typing import Any, Dict

import yaml

from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusionConfig

# --DM_arch / --Unet3D_arch combinations -> config fields.
ARCH_PRESETS: Dict[str, Dict[str, Any]] = {
    "multi/wo_ref": dict(use_ref_features=False, conditioning="adaptor",
                         dim_mults=(1, 2, 4, 4)),
    "multi1248/ada": dict(use_ref_features=True, conditioning="adaptor",
                          dim_mults=(1, 2, 4, 8)),
    "w_ref/traj": dict(use_ref_features=True, conditioning="trajwarp",
                       down_adaptor_from_level=2, window_size=(2, 4, 4),
                       dim_mults=(1, 2, 4, 4)),
    "w_ref/ada": dict(use_ref_features=True, conditioning="adaptor",
                      dim_mults=(1, 2, 4, 4)),
    "w_ref_u22/ada_u22": dict(use_ref_features=True, conditioning="adaptor",
                              dim_mults=(1, 2, 4, 4), window_size=(4, 4, 4)),
}

# The KTH LFAE of bench.py (flow_params of config/DM/kth.yaml).
KTH_FLOW_PARAMS = dict(
    num_regions=10,
    num_channels=3,
    estimate_affine=True,
    revert_axis_swap=True,
    bg_predictor_params=dict(block_expansion=32, max_features=1024, num_blocks=5,
                             bg_type="affine"),
    region_predictor_params=dict(temperature=0.1, block_expansion=32, max_features=1024,
                                 scale_factor=0.5, num_blocks=5, pca_based=True, pad=0),
    generator_params=dict(block_expansion=64, max_features=512, num_down_blocks=2,
                          num_bottleneck_blocks=6, skips=True,
                          pixelwise_flow_predictor_params=dict(
                              block_expansion=64, max_features=1024, num_blocks=5,
                              scale_factor=0.5, use_deformed_source=True,
                              use_covar_heatmap=True, estimate_occlusion_map=True)),
)


def kth_sampling_config(**overrides) -> FlowDiffusionConfig:
    """bench.py's KTH sampling configuration: 64 px, tc=10, tp=20, dim 64,
    dim_mults (1,2,4,4), 8x32 heads, window (4,4,4), DDIM-10."""
    kwargs = dict(flow_params=KTH_FLOW_PARAMS, cond_frames=10, pred_frames=20, frame_shape=64,
                  timesteps=1000, sampling_timesteps=10, dim=64, dim_mults=(1, 2, 4, 4),
                  attn_heads=8, attn_dim_head=32)
    kwargs.update(overrides)
    return FlowDiffusionConfig(**kwargs)


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def dm_config_from_yaml(cfg: Dict[str, Any], arch: str = "w_ref_u22/ada_u22",
                        **overrides) -> FlowDiffusionConfig:
    dp = cfg["dataset_params"]
    diff = cfg["diffusion_params"]["model_params"]
    kwargs = dict(
        flow_params=cfg["flow_params"]["model_params"],
        cond_frames=dp["train_params"]["cond_frames"],
        pred_frames=dp["train_params"]["pred_frames"],
        frame_shape=dp["frame_shape"],
        sampling_timesteps=diff.get("sampling_timesteps", 10),
        use_residual_flow=diff.get("use_residual_flow", False),
    )
    kwargs.update(ARCH_PRESETS[arch])
    kwargs.update(overrides)
    return FlowDiffusionConfig(**kwargs)
