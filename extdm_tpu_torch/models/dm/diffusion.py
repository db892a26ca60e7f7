"""Gaussian diffusion over video latents, DDIM and ancestral sampling and
the training loss (port of extdm_tpu/models/dm/diffusion.py): the fp64
cosine schedule cast to float32 buffers, q_sample, q_posterior and the
epsilon loss, Imagen dynamic thresholding, and the reference's DDIM time
grid. ``sample`` runs DDIM when it takes fewer steps than the schedule and
the ancestral ``p_sample_loop`` otherwise (at as many steps as the schedule
the last DDIM pair is (0, 0), whose sigma is 0/0). Timesteps and noise come
from an explicit ``torch.Generator``; ``init_noise`` and ``noises`` replace
the draws (reproducible trajectories, and the JAX draws in the tests).
``interpolate`` mixes two noised latents and denoises back ancestrally;
``guided_denoise_fn`` wraps a denoiser for classifier-free guidance.

With ``shard`` (a ``parallel.SpatialMesh``) ``sample`` runs on a rank's
batch rows and H rows of the latents (the spatial sampler's DDIM stage):
every rank draws the global x_T and step noise from the one generator and
keeps its part, so the result is the single process's whatever the mesh,
and the dynamic threshold's per-sample quantile reads |x0| gathered over the
H shards (a quantile does not reduce as a sum)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from extdm_tpu_torch.utils.profiler import span


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    return np.clip(1 - (alphas_cumprod[1:] / alphas_cumprod[:-1]), 0, 0.9999)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Schedule buffers (numpy float32), computed in float64, and the pinned
    host copies of those copied to a card (``pinned``)."""

    num_timesteps: int
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    def __post_init__(self):  # not a field: the fields are the tables
        object.__setattr__(self, "_pinned", {})

    def pinned(self, name: str) -> torch.Tensor:
        """Table `name` in pinned host memory, made at its first use and kept
        with the schedule."""
        table = self._pinned.get(name)
        if table is None:
            table = self._pinned[name] = torch.from_numpy(getattr(self, name)).pin_memory()
        return table

    @staticmethod
    def create(timesteps: int = 1000) -> "DiffusionSchedule":
        betas = cosine_beta_schedule(timesteps)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        return DiffusionSchedule(
            num_timesteps=timesteps,
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                     / (1.0 - alphas_cumprod)),
        )


def dynamic_threshold(x0: torch.Tensor, percentile: float = 0.9, shard=None) -> torch.Tensor:
    """Clamp to the per-sample `percentile` of |x0| (at least 1), rescale into
    [-1, 1]. With `shard`, x0 (B, T, HL, ...) is an H shard's rows and the
    quantile is taken on |x0| gathered over the shards."""
    b = x0.shape[0]
    a = x0.abs() if shard is None else shard.gather_h(x0.abs(), "threshold")
    s = torch.quantile(a.reshape(b, -1), percentile, dim=-1, interpolation="linear")
    s = torch.clamp(s, min=1.0).reshape(b, *((1,) * (x0.ndim - 1)))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def ddim_time_pairs(num_timesteps: int, sampling_steps: int) -> np.ndarray:
    """linspace(0, T, steps+2)[:-1] as ints, reversed, consecutive pairs: (steps+1, 2)."""
    times = np.linspace(0.0, num_timesteps, sampling_steps + 2)[:-1].astype(np.int64)
    times = list(reversed(times.tolist()))
    return np.asarray(list(zip(times[:-1], times[1:])), dtype=np.int32)


DenoiseFn = Callable[..., torch.Tensor]  # (x, t, cond_frames, cond_fea) -> eps


def _extract(s: DiffusionSchedule, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Table `name` of `s` at t, shaped (B, 1, ..., 1) to broadcast over a
    rank-`ndim` batch: the whole table copied to t's device (the span
    ``schedule_copy``). To a card the copy comes from the table's pinned
    host copy and the host does not wait for it (a copy from pageable memory
    drains the stream)."""
    with span("schedule_copy"):
        if t.is_cuda:
            table = s.pinned(name).to(t.device, non_blocking=True)
        else:
            table = torch.as_tensor(getattr(s, name), device=t.device)
        return table[t].reshape((-1,) + (1,) * (ndim - 1))


@dataclass(frozen=True)
class GaussianDiffusion:
    schedule: DiffusionSchedule
    sampling_timesteps: int = 10
    ddim_eta: float = 1.0
    loss_type: str = "l2"

    def q_sample(self, x_start, t, noise):
        s = self.schedule
        return (_extract(s, "sqrt_alphas_cumprod", t, x_start.ndim) * x_start
                + _extract(s, "sqrt_one_minus_alphas_cumprod", t, x_start.ndim) * noise)

    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (_extract(s, "sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t
                - _extract(s, "sqrt_recipm1_alphas_cumprod", t, x_t.ndim) * noise)

    def q_posterior(self, x_start, x_t, t):
        """Mean, variance and clipped log variance of q(x_{t-1} | x_t, x_0)."""
        s = self.schedule
        mean = (_extract(s, "posterior_mean_coef1", t, x_t.ndim) * x_start
                + _extract(s, "posterior_mean_coef2", t, x_t.ndim) * x_t)
        return (mean, _extract(s, "posterior_variance", t, x_t.ndim),
                _extract(s, "posterior_log_variance_clipped", t, x_t.ndim))

    def p_losses(self, denoise_fn: "DenoiseFn", generator: torch.Generator, x_cond: torch.Tensor,
                 x_pred: torch.Tensor, cond_fea: Optional[torch.Tensor],
                 t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, pred_x0) of one batch of (B, T, h, w, C) latents: t ~ U[0,
        num_timesteps) and standard normal noise, drawn from `generator` in
        that order unless given; pred_x0 is detached and dynamically
        thresholded."""
        b, device = x_pred.shape[0], x_pred.device
        if t is None:
            t = torch.randint(0, self.schedule.num_timesteps, (b,), generator=generator,
                              device=generator.device)
        if noise is None:
            noise = torch.randn(x_pred.shape, generator=generator, device=generator.device)
        t, noise = t.to(device, torch.long), noise.to(device, x_pred.dtype)
        x_noisy = self.q_sample(x_pred, t, noise)
        pred_noise = denoise_fn(x_noisy, t, x_cond, cond_fea)
        if self.loss_type == "l1":
            loss = (noise - pred_noise).abs().mean()
        elif self.loss_type == "l2":
            loss = ((noise * 10.0 - pred_noise * 10.0) ** 2).mean()
        else:
            raise NotImplementedError(self.loss_type)
        with torch.no_grad():
            pred_x0 = dynamic_threshold(self.predict_start_from_noise(x_noisy, t, pred_noise))
        return loss, pred_x0

    def ddim_sample(self, denoise_fn: DenoiseFn, generator: torch.Generator,
                    x_cond: torch.Tensor, pred_frames: int, cond_fea: Optional[torch.Tensor],
                    init_noise: Optional[torch.Tensor] = None,
                    noises: Optional[Sequence[torch.Tensor]] = None, shard=None) -> torch.Tensor:
        """x_cond (B, tc, h, w, C) -> (B, pred_frames, h, w, C) float32 latents.
        `init_noise` replaces the drawn x_T (reproducible trajectories);
        `noises`, one per step, replace the per-step draws. With `shard`,
        x_cond and the result are a rank's rows of the global batch and
        latent H, and `init_noise` and `noises` are global."""
        B, _, h, w, C = x_cond.shape
        shape = (B, pred_frames, h, w, C)
        device = x_cond.device
        normal = _normals(generator, shape, device, noises, shard)
        img = normal() if init_noise is None else _local(init_noise, shard).to(device,
                                                                              torch.float32)
        alphas_prev = self.schedule.alphas_cumprod_prev
        eta = np.float32(self.ddim_eta)
        for i, (time, time_next) in enumerate(ddim_time_pairs(self.schedule.num_timesteps,
                                                              self.sampling_timesteps)):
            with span("ddim.step"):
                alpha, alpha_next = alphas_prev[time], alphas_prev[time_next]  # float32 scalars
                t_b = torch.full((B,), int(time), dtype=torch.long, device=device)
                with span("ddim.denoise"):
                    pred_noise = denoise_fn(img, t_b, x_cond, cond_fea)
                with span("ddim.update"):
                    x_start = dynamic_threshold(
                        self.predict_start_from_noise(img, t_b, pred_noise), shard=shard)
                    sigma = eta * np.sqrt((1 - alpha / alpha_next) * (1 - alpha_next)
                                          / (1 - alpha))
                    c = np.sqrt(np.maximum((1 - alpha_next) - sigma ** 2, np.float32(0.0)))
                    img = x_start * float(np.sqrt(alpha_next)) + float(c) * pred_noise
                    if time_next > 0 and sigma > 0:
                        img = img + float(sigma) * normal(i)
        return img

    def p_sample_loop(self, denoise_fn: DenoiseFn, generator: torch.Generator,
                      x_cond: torch.Tensor, pred_frames: int, cond_fea: Optional[torch.Tensor],
                      init_noise: Optional[torch.Tensor] = None,
                      noises: Optional[Sequence[torch.Tensor]] = None,
                      shard=None) -> torch.Tensor:
        """Ancestral sampling over every step of the schedule, t = T-1 .. 0;
        the same arguments and result as ``ddim_sample``."""
        B, _, h, w, C = x_cond.shape
        shape = (B, pred_frames, h, w, C)
        device = x_cond.device
        normal = _normals(generator, shape, device, noises, shard)
        img = normal() if init_noise is None else _local(init_noise, shard).to(device,
                                                                              torch.float32)
        for i, t in enumerate(range(self.schedule.num_timesteps - 1, -1, -1)):
            with span("ddim.step"):
                t_b = torch.full((B,), t, dtype=torch.long, device=device)
                with span("ddim.denoise"):
                    eps = denoise_fn(img, t_b, x_cond, cond_fea)
                with span("ddim.update"):
                    x0 = dynamic_threshold(self.predict_start_from_noise(img, t_b, eps),
                                           shard=shard)
                    mean, _, log_var = self.q_posterior(x0, img, t_b)
                    img = mean + torch.exp(0.5 * log_var) * normal(i) if t > 0 else mean
        return img

    def interpolate(self, denoise_fn: DenoiseFn, generator: torch.Generator,
                    x_cond: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                    cond_fea: Optional[torch.Tensor] = None, t: Optional[int] = None,
                    lam: float = 0.5, noise: Optional[torch.Tensor] = None,
                    noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Latent interpolation (ref Diffusion.py:260-274): noise x1 and x2
        (B, T, h, w, C) to step t (default the last) with one shared draw,
        mix them with weight `lam`, then denoise ancestrally from t-1 to 0.
        `noise` replaces the shared draw, `noises` (one per step, step i at
        time t-1-i) the steps' draws."""
        t = self.schedule.num_timesteps - 1 if t is None else t
        B, device = x1.shape[0], x1.device
        normal = _normals(generator, x1.shape, device, noises)
        noise = normal() if noise is None else noise.to(device, torch.float32)
        tb = torch.full((B,), t, dtype=torch.long, device=device)
        img = (1 - lam) * self.q_sample(x1, tb, noise) + lam * self.q_sample(x2, tb, noise)
        for i, ti in enumerate(range(t - 1, -1, -1)):
            t_b = torch.full((B,), ti, dtype=torch.long, device=device)
            eps = denoise_fn(img, t_b, x_cond, cond_fea)
            x0 = dynamic_threshold(self.predict_start_from_noise(img, t_b, eps))
            mean, _, log_var = self.q_posterior(x0, img, t_b)
            img = mean + torch.exp(0.5 * log_var) * normal(i) if ti > 0 else mean
        return img

    @span("sample.ddim")
    def sample(self, denoise_fn: DenoiseFn, generator: torch.Generator, x_cond: torch.Tensor,
               pred_frames: int, cond_fea: Optional[torch.Tensor] = None,
               init_noise: Optional[torch.Tensor] = None,
               noises: Optional[Sequence[torch.Tensor]] = None, shard=None) -> torch.Tensor:
        """DDIM with fewer steps than the schedule, else the ancestral loop."""
        run = (self.ddim_sample if self.sampling_timesteps < self.schedule.num_timesteps
               else self.p_sample_loop)
        return run(denoise_fn, generator, x_cond, pred_frames, cond_fea, init_noise=init_noise,
                   noises=noises, shard=shard)


def guided_denoise_fn(denoise_fn: DenoiseFn, cond_scale: float = 1.0) -> DenoiseFn:
    """Classifier-free guidance (reference forward_with_cond_scale):
    eps = eps_null + cond_scale (eps - eps_null), the null prediction with
    every sample's condition replaced by the null embedding; scale 1 is
    `denoise_fn` itself, scale 0 the null prediction. `denoise_fn` takes a
    ``null_cond_mask`` keyword (B,) bool."""
    if cond_scale == 1.0:
        return denoise_fn

    def fn(x, t, cond_frames, cond_fea, **kw):
        b = x.shape[0]
        null = denoise_fn(x, t, cond_frames, cond_fea,
                          null_cond_mask=torch.ones(b, dtype=torch.bool, device=x.device), **kw)
        if cond_scale == 0.0:
            return null
        full = denoise_fn(x, t, cond_frames, cond_fea,
                          null_cond_mask=torch.zeros(b, dtype=torch.bool, device=x.device), **kw)
        return null + (full - null) * cond_scale

    return fn


def _local(x: torch.Tensor, shard) -> torch.Tensor:
    return x if shard is None else shard.local(x)


def _normals(generator: torch.Generator, shape, device, noises: Optional[Sequence[torch.Tensor]],
             shard=None):
    """normal() draws x_T; normal(i) step i's noise, taken from `noises`
    when given, else drawn. With `shard`, `shape` is a rank's part of the
    latents: the global draw is made and the part kept."""
    if shard is not None:
        B, T, h, w, C = shape
        shape = (B * shard.data, T, h * shard.model, w, C)

    def normal(step: Optional[int] = None) -> torch.Tensor:
        if step is not None and noises is not None:
            return _local(noises[step], shard).to(device, torch.float32)
        draw = torch.randn(shape, generator=generator, device=generator.device)
        return _local(draw, shard).to(device)
    return normal
