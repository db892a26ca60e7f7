"""A configuration of the benchmark's shapes at a size the CPU runs in
seconds, for the tests: every layer of the KTH and Cityscapes
configurations at small widths, depths and frames, with a denoiser of each
conditioning family (``MODELS``)."""
import copy
import json
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]

FLOW = dict(num_regions=3, num_channels=3, estimate_affine=True, revert_axis_swap=True,
            bg_predictor_params=dict(block_expansion=8, max_features=32, num_blocks=2,
                                     bg_type="perspective"),
            region_predictor_params=dict(temperature=0.1, block_expansion=8, max_features=32,
                                         scale_factor=0.5, num_blocks=2, pca_based=True, pad=0),
            generator_params=dict(block_expansion=8, max_features=16, num_down_blocks=2,
                                  num_bottleneck_blocks=1, skips=True,
                                  pixelwise_flow_predictor_params=dict(
                                      block_expansion=8, max_features=16, num_blocks=2,
                                      scale_factor=0.5, use_deformed_source=True,
                                      use_covar_heatmap=True, estimate_occlusion_map=True)))
MODEL = dict(flow_params=FLOW, cond_frames=2, pred_frames=3, frame_shape=16, timesteps=1000,
             sampling_timesteps=3, ddim_eta=1.0, loss_type="l2", use_residual_flow=False, dim=16,
             dim_mults=[1, 2], window_size=[2, 4, 4], attn_heads=2, attn_dim_head=8,
             use_ref_features=True, conditioning="adaptor")
# The trajwarp family: 16 px frames, 8 px latents and 4 px features, so that the
# 2x2 max-pool of the lifted latents meets the features as at KTH (64, 32, 16);
# window (2, 4, 4) as w_ref/traj's; three levels, adaptors from level 1, so
# that the up levels past the first two have one.
TRAJ_MODEL = dict(MODEL, dim_mults=[1, 2, 2], conditioning="trajwarp", down_adaptor_from_level=1)
MODELS = {"adaptor": MODEL, "trajwarp": TRAJ_MODEL}


def config(cell: Optional[str] = None, family: Optional[str] = None,
           dtype: str = "float32") -> dict:
    """A benchmark configuration file's contents at the tiny size, with the
    denoiser of `family`, else of the conditioning that the configuration
    file of `cell` names, else the adaptor one."""
    family = family or (conditioning(cell) if cell else "adaptor")
    return {"name": "tiny", "dtype": dtype, "reduced": [], "model": copy.deepcopy(MODELS[family]),
            "test_pred_frames": 5, "train": {"lr": 2e-5, "milestones": [80000], "gamma": 0.75,
                                             "weight_decay": 0.01}}


def conditioning(cell: str) -> str:
    """The conditioning family of the configuration that `cell` runs."""
    bench = benchmark()
    name = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    path = next(c["file"] for c in bench["configs"] if c["name"] == name)
    return json.loads((ROOT / path).read_text())["model"].get("conditioning", "adaptor")


TRAFFIC = {"sample": dict(kind="sample", rows=6, check_calls=2, check_rows=3),
           "train": dict(kind="train", batch=4, pool=4, check_block=2)}


def traffic(cell: str) -> dict:
    """The tiny traffic of a cell's kind."""
    bench = benchmark()
    name = next(w["traffic"] for w in bench["workloads"] if w["name"] == cell)
    kind = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())["kind"]
    return TRAFFIC[kind]


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
