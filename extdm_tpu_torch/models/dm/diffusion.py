"""Gaussian diffusion over video latents, DDIM sampling (port of
extdm_tpu/models/dm/diffusion.py): the fp64 cosine schedule cast to float32
buffers, Imagen dynamic thresholding, and the reference's DDIM time grid.
Noise comes from an explicit ``torch.Generator``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    return np.clip(1 - (alphas_cumprod[1:] / alphas_cumprod[:-1]), 0, 0.9999)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Schedule buffers (numpy float32) of the sampling path."""

    num_timesteps: int
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray

    @staticmethod
    def create(timesteps: int = 1000) -> "DiffusionSchedule":
        betas = cosine_beta_schedule(timesteps)
        alphas_cumprod = np.cumprod(1.0 - betas)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        return DiffusionSchedule(
            num_timesteps=timesteps,
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(np.concatenate([[1.0], alphas_cumprod[:-1]])),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        )


def dynamic_threshold(x0: torch.Tensor, percentile: float = 0.9) -> torch.Tensor:
    """Clamp to the per-sample `percentile` of |x0| (at least 1), rescale into [-1, 1]."""
    b = x0.shape[0]
    s = torch.quantile(x0.reshape(b, -1).abs(), percentile, dim=-1, interpolation="linear")
    s = torch.clamp(s, min=1.0).reshape(b, *((1,) * (x0.ndim - 1)))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def ddim_time_pairs(num_timesteps: int, sampling_steps: int) -> np.ndarray:
    """linspace(0, T, steps+2)[:-1] as ints, reversed, consecutive pairs: (steps+1, 2)."""
    times = np.linspace(0.0, num_timesteps, sampling_steps + 2)[:-1].astype(np.int64)
    times = list(reversed(times.tolist()))
    return np.asarray(list(zip(times[:-1], times[1:])), dtype=np.int32)


DenoiseFn = Callable[..., torch.Tensor]  # (x, t, cond_frames, cond_fea) -> eps


@dataclass(frozen=True)
class GaussianDiffusion:
    schedule: DiffusionSchedule
    sampling_timesteps: int = 10
    ddim_eta: float = 1.0

    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        shape = (-1,) + (1,) * (x_t.ndim - 1)
        a = torch.as_tensor(s.sqrt_recip_alphas_cumprod, device=x_t.device)[t].reshape(shape)
        b = torch.as_tensor(s.sqrt_recipm1_alphas_cumprod, device=x_t.device)[t].reshape(shape)
        return a * x_t - b * noise

    def ddim_sample(self, denoise_fn: DenoiseFn, generator: torch.Generator,
                    x_cond: torch.Tensor, pred_frames: int, cond_fea: Optional[torch.Tensor],
                    init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_cond (B, tc, h, w, C) -> (B, pred_frames, h, w, C) float32 latents.
        `init_noise` replaces the drawn x_T (reproducible trajectories)."""
        B, _, h, w, C = x_cond.shape
        shape = (B, pred_frames, h, w, C)
        device = x_cond.device

        def normal():
            return torch.randn(shape, generator=generator, device=generator.device).to(device)

        img = normal() if init_noise is None else init_noise.to(device, torch.float32)
        alphas_prev = self.schedule.alphas_cumprod_prev
        eta = np.float32(self.ddim_eta)
        for time, time_next in ddim_time_pairs(self.schedule.num_timesteps,
                                               self.sampling_timesteps):
            alpha, alpha_next = alphas_prev[time], alphas_prev[time_next]  # float32 scalars
            t_b = torch.full((B,), int(time), dtype=torch.long, device=device)
            pred_noise = denoise_fn(img, t_b, x_cond, cond_fea)
            x_start = dynamic_threshold(self.predict_start_from_noise(img, t_b, pred_noise))
            sigma = eta * np.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c = np.sqrt(np.maximum((1 - alpha_next) - sigma ** 2, np.float32(0.0)))
            img = x_start * float(np.sqrt(alpha_next)) + float(c) * pred_noise
            if time_next > 0 and sigma > 0:
                img = img + float(sigma) * normal()
        return img
