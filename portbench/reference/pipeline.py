"""Plain float32 ExtDM: the frozen LFAE and the denoiser under Gaussian
diffusion (cosine schedule), DDIM sampling of a call and the epsilon loss
and AdamW step of DM training.

``Reference(model)`` builds the modules from a configuration's ``model``
section (the configuration files under ``portbench/configs``), the
denoiser of the family that its ``conditioning`` names (``DENOISERS``);
``load_state_dict`` takes the benchmark's seeded weights under the
reference checkpoints' keys (``lfae.*`` and ``unet.*``). Rows of a batch
are independent in every function here, so a caller may run any subset
of a batch's rows, in blocks that fit. Nothing here is imported from the
program.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from portbench.reference.lfae import LFAE
from portbench.reference.trajwarp import TrajUnet3D
from portbench.reference.unet import Unet3D

# the denoiser of each conditioning family a configuration's ``conditioning`` names
DENOISERS = {"adaptor": Unet3D, "trajwarp": TrajUnet3D}


def cosine_alphas_cumprod(timesteps: int, s: float = 0.008) -> np.ndarray:
    """alpha-bar of the cosine schedule (betas clipped to 0.9999), float64."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.9999)
    return np.cumprod(1.0 - betas)


def ddim_steps(timesteps: int, sampling_steps: int):
    """[(t, t_next)] from t = T - T/(steps+1) down to 0 in steps+1 equal cuts."""
    times = np.linspace(0.0, timesteps, sampling_steps + 2)[:-1].astype(np.int64)[::-1].tolist()
    return list(zip(times[:-1], times[1:]))


def dynamic_threshold(x0: torch.Tensor, percentile: float = 0.9) -> torch.Tensor:
    """Imagen's dynamic thresholding: clamp to the per-sample percentile of
    |x0| (at least 1) and rescale into [-1, 1]."""
    b = x0.shape[0]
    s = torch.quantile(x0.abs().reshape(b, -1), percentile, dim=-1)
    s = torch.clamp(s, min=1.0).reshape(b, *((1,) * (x0.ndim - 1)))
    return torch.clamp(x0, -s, s) / s


def bottleneck_dim(flow_params: dict) -> int:
    gp = flow_params["generator_params"]
    return min(gp["max_features"], gp["block_expansion"] * 2 ** gp["num_down_blocks"])


class Reference(nn.Module):
    """model: the ``model`` section of a benchmark configuration."""

    def __init__(self, model: dict):
        super().__init__()
        self.tc, self.tp = model["cond_frames"], model["pred_frames"]
        self.timesteps = model["timesteps"]
        self.sampling_steps = model["sampling_timesteps"]
        self.eta = model["ddim_eta"]
        self.lfae = LFAE(model["flow_params"])
        conditioning = model.get("conditioning", "adaptor")
        if conditioning not in DENOISERS:
            raise ValueError(f"conditioning {conditioning!r}: the reference builds "
                             f"{' or '.join(DENOISERS)}")
        self.unet = DENOISERS[conditioning](
            dim=model["dim"], dim_mults=tuple(model["dim_mults"]),
            window_size=tuple(model["window_size"]), attn_heads=model["attn_heads"],
            attn_dim_head=model["attn_dim_head"], cond_num=self.tc, pred_num=self.tp,
            cond_feature_dim=bottleneck_dim(model["flow_params"]),
            down_adaptor_from_level=model.get("down_adaptor_from_level", 0))
        # the schedule's tables, computed in float64 and used in float32
        ac = cosine_alphas_cumprod(self.timesteps)
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        self.ac_prev = f32(np.concatenate([[1.0], ac[:-1]]))
        self.sqrt_ac, self.sqrt_1m_ac = f32(np.sqrt(ac)), f32(np.sqrt(1.0 - ac))
        self.sqrt_recip_ac = f32(np.sqrt(1.0 / ac))
        self.sqrt_recipm1_ac = f32(np.sqrt(1.0 / ac - 1))

    # --- the latent space --------------------------------------------------------------
    def encode(self, video: torch.Tensor):
        """(latents (B, T, h, w, 3) = [flow, 2 conf - 1], ref features) of a clip."""
        enc = self.lfae.encode_video(video, self.tc)
        fea = self.lfae.ref_features(video, self.tc, self.tp)
        return torch.cat([enc["flow"], enc["conf"] * 2.0 - 1.0], dim=-1), fea

    def _coef(self, table: np.ndarray, t: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(table, device=t.device)[t].reshape(-1, 1, 1, 1, 1)

    def predict_x0(self, x_t, t, eps):
        return self._coef(self.sqrt_recip_ac, t) * x_t - self._coef(self.sqrt_recipm1_ac, t) * eps

    # --- sampling ----------------------------------------------------------------------
    def sample(self, cond_video: torch.Tensor, init_noise: torch.Tensor,
               step_noise: Callable[[int], torch.Tensor], decode: bool = True
               ) -> Dict[str, torch.Tensor]:
        """One sampler call: cond_video (B, tc, H, W, C) in [0, 1], the
        starting noise (B, tp, h, w, 3), step_noise(i) the noise added after
        DDIM step i. Returns the predicted frames' flow (B, tp, h, w, 2),
        occlusion (B, tp, h, w, 1) and, with `decode`, pixels (B, tp, H, W, C)."""
        x_cond, fea = self.encode(cond_video)
        B, _, h, w, _ = x_cond.shape
        cond = self.unet.cond_term(fea, h, w)
        img = init_noise.float()
        for i, (t, t_next) in enumerate(ddim_steps(self.timesteps, self.sampling_steps)):
            a, a_next = self.ac_prev[t], self.ac_prev[t_next]
            tb = torch.full((B,), int(t), dtype=torch.long, device=img.device)
            eps = self.unet(img, tb, x_cond, cond_term=cond)
            x0 = dynamic_threshold(self.predict_x0(img, tb, eps))
            sigma = np.float32(self.eta) * np.sqrt((1 - a / a_next) * (1 - a_next) / (1 - a))
            c = np.sqrt(np.maximum((1 - a_next) - sigma ** 2, np.float32(0.0)))
            img = x0 * float(np.sqrt(a_next)) + float(c) * eps
            if t_next > 0 and sigma > 0:
                img = img + float(sigma) * step_noise(i)
        out = {"flow": img[..., :2], "conf": (img[..., 2:3] + 1.0) * 0.5}
        if decode:
            dec = self.lfae.decode_flows(cond_video[:, self.tc - 1], out["flow"], out["conf"])
            out["frames"] = dec["out_vid"]
        return out

    def noise_steps(self) -> List[int]:
        """The DDIM steps after which noise is drawn."""
        steps = []
        for i, (t, t_next) in enumerate(ddim_steps(self.timesteps, self.sampling_steps)):
            a, a_next = self.ac_prev[t], self.ac_prev[t_next]
            sigma = np.float32(self.eta) * np.sqrt((1 - a / a_next) * (1 - a_next) / (1 - a))
            if t_next > 0 and sigma > 0:
                steps.append(i)
        return steps

    # --- training ------------------------------------------------------------------------
    def loss(self, video: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Mean over the rows of the epsilon loss, mean((10 noise - 10 eps)^2)
        per row: video (B, tc + tp, H, W, C) in [0, 1], t (B,), noise
        (B, tp, h, w, 3). The LFAE gets no gradient."""
        with torch.no_grad():
            lat, fea = self.encode(video)
        x_cond, x0 = lat[:, :self.tc], lat[:, self.tc:]
        x_t = self._coef(self.sqrt_ac, t) * x0 + self._coef(self.sqrt_1m_ac, t) * noise
        eps = self.unet(x_t, t, x_cond, fea)
        return ((noise * 10.0 - eps * 10.0) ** 2).mean()


def adamw_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 state: List[Optional[tuple]], step: int, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One decoupled-weight-decay Adam update in place; `state` holds (m, v)
    per parameter and `step` counts from 1."""
    b1, b2 = betas
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            m, v = state[i] if state[i] is not None else (torch.zeros_like(p),
                                                         torch.zeros_like(p))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            state[i] = (m, v)
            m_hat = m / (1 - b1 ** step)
            v_hat = v / (1 - b2 ** step)
            p.mul_(1 - lr * weight_decay)
            p.sub_(lr * m_hat / (v_hat.sqrt() + eps))


def multi_step_lr(lr: float, milestones: Sequence[int], gamma: float, updates: int) -> float:
    """The learning rate after `updates` updates: gamma per milestone reached."""
    return lr * gamma ** sum(updates >= m for m in milestones)
