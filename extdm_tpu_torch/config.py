"""Config loading, same YAML schema as the JAX package (port of
extdm_tpu/config.py), plus the KTH sampling and training presets that
``bench.py`` runs, the KTH preset at the ``multi1248/ada`` widths, and the
stage-1 (AE) settings of configs/AE/kth.yaml."""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import torch
import yaml

from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusionConfig

# A data file of the repository, read (never imported) by the port.
KTH_AE_YAML = Path(__file__).resolve().parents[1] / "configs" / "AE" / "kth.yaml"

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


def kth_multi1248_config(**overrides) -> FlowDiffusionConfig:
    """The KTH sampling preset with the ``multi1248/ada`` UNet (the
    reference's VideoFlowDiffusion_multi1248): dim_mults (1, 2, 4, 8), so the
    deepest level and the mid blocks have 512 channels."""
    return kth_sampling_config(**{**ARCH_PRESETS["multi1248/ada"], **overrides})


def kth_traj_config(**overrides) -> FlowDiffusionConfig:
    """The KTH sampling preset with the ``w_ref/traj`` UNet (the reference's
    VideoFlowDiffusion_multi_w_ref with the ..._traj_u12/u22 denoisers):
    window (2, 4, 4), so N = 32 tokens a window and shift (1, 2, 2); the
    trajectory-warp conditioning (``TrajWarp``) at the init conv and
    MotionAdaptors from down level 2; bf16 compute unless overridden."""
    return kth_sampling_config(**{"dtype": torch.bfloat16, **ARCH_PRESETS["w_ref/traj"],
                                  **overrides})


def kth_training_config(dtype=torch.bfloat16, **overrides) -> FlowDiffusionConfig:
    """bench.py's KTH train-step configuration (``bench_train_step``): the
    sampling preset's widths with remat, computing in `dtype` (None: float32)."""
    return kth_sampling_config(remat=True, dtype=dtype, **overrides)


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
        loss_type=diff.get("loss_type", "l2"),
        use_residual_flow=diff.get("use_residual_flow", False),
    )
    kwargs.update(ARCH_PRESETS[arch])
    kwargs.update(overrides)
    return FlowDiffusionConfig(**kwargs)


def ae_model_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """kwargs for models.lfae.recon_model.ReconstructionModel from an AE yaml."""
    flow = cfg["flow_params"]["model_params"]
    tp = cfg["flow_params"]["train_params"]
    rp = {k: v for k, v in flow["region_predictor_params"].items() if k != "fast_svd"}
    return dict(
        region_predictor_cfg={**rp, "estimate_affine": flow.get("estimate_affine", True)},
        bg_predictor_cfg=flow["bg_predictor_params"],
        generator_cfg={**flow["generator_params"],
                       "revert_axis_swap": flow.get("revert_axis_swap", True)},
        num_regions=flow["num_regions"],
        num_channels=flow["num_channels"],
        scales=tuple(tp.get("scales", (1.0, 0.5, 0.25))),
        loss_weights={**tp["loss_weights"],
                      "reconstruction": tp["loss_weights"].get("reconstruction", 10)},
        transform_params=tp.get("transform_params"),
    )


def kth_ae_training_config() -> Dict[str, Any]:
    """Stage-1 training settings of the repository's configs/AE/kth.yaml: the
    ReconstructionModel kwargs (10 regions, 64 px, perceptual weights [10]*5
    at scales (1, 0.5, 0.25), TPS sigma_affine 0.05 / sigma_tps 0.005 / 5
    points), Adam's lr (2e-4) and MultiStepLR schedule ([150000] x 0.5), the
    device augmentation (flip + jitter) and the frame size."""
    cfg = load_config(str(KTH_AE_YAML))
    dp = cfg["dataset_params"]
    tp = cfg["flow_params"]["train_params"]
    aug = dp.get("augmentation_params") or {}
    return dict(model=ae_model_kwargs(cfg), lr=tp["lr"],
                milestones=tuple(tp["scheduler_param"]["milestones"]),
                gamma=tp["scheduler_param"]["gamma"],
                device_augment={k: aug[k] for k in ("flip_param", "jitter_param") if k in aug},
                frame_shape=dp["frame_shape"])
