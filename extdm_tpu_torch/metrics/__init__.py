"""Video metrics: PSNR, SSIM, LPIPS and FVD, best of n trajectories."""
from extdm_tpu_torch.metrics.fvd import (
    I3DExtractor,
    best_trajectory_by_feature_distance,
    calculate_fvd1,
    calculate_fvd2,
    frechet_distance,
    get_feats,
    preprocess_videos,
)
from extdm_tpu_torch.metrics.i3d import InceptionI3d
from extdm_tpu_torch.metrics.lpips import LPIPS, AlexNetFeatures, LPIPSMetric
from extdm_tpu_torch.metrics.psnr import calculate_psnr1, calculate_psnr2, calculate_psnr3
from extdm_tpu_torch.metrics.ssim import calculate_ssim1, calculate_ssim2, calculate_ssim3

__all__ = ["I3DExtractor", "best_trajectory_by_feature_distance", "calculate_fvd1",
           "calculate_fvd2", "frechet_distance", "get_feats", "preprocess_videos",
           "InceptionI3d", "LPIPS", "AlexNetFeatures", "LPIPSMetric", "calculate_psnr1",
           "calculate_psnr2", "calculate_psnr3", "calculate_ssim1", "calculate_ssim2",
           "calculate_ssim3"]
