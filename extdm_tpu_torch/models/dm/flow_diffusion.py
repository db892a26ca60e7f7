"""FlowDiffusion: frozen LFAE + 3-D UNet + Gaussian diffusion, DDIM sampling
and the training loss (port of extdm_tpu/models/dm/flow_diffusion.py).

``FlowDiffusion(cfg, device="cuda")`` builds the modules with this package's
own initialisation (seeded) on the given device. The frozen LFAE is stored
in ``cfg.dtype``; the UNet keeps float32 master weights (trainable) and
computes in ``cfg.dtype``, as the JAX trainer does. Load converted JAX
weights with ``fd.lfae.load_state_dict(...)`` and ``fd.unet.load_state_dict(...)``
(see ``convert.py``). There is no silent CPU fallback: a CUDA device
without a card raises; the CPU runs only when asked.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from extdm_tpu_torch.models.dm.diffusion import DiffusionSchedule, GaussianDiffusion
from extdm_tpu_torch.models.dm.unet3d import Unet3D
from extdm_tpu_torch.models.lfae.bg_predictor import BGMotionPredictor
from extdm_tpu_torch.models.lfae.generator import Generator
from extdm_tpu_torch.models.lfae.region_predictor import RegionPredictor
from extdm_tpu_torch.ops.coords import make_coordinate_grid


def _merge_bt(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _split_bt(x: torch.Tensor, b: int) -> torch.Tensor:
    return x.reshape((b, x.shape[0] // b) + tuple(x.shape[1:]))


class LFAE(nn.Module):
    """Frozen stage-1 bundle used inside the DM (region + bg + generator)."""

    def __init__(self, flow_params: dict):
        super().__init__()
        fp = flow_params
        rp = {k: v for k, v in fp["region_predictor_params"].items() if k != "fast_svd"}
        self.region_predictor = RegionPredictor(
            num_regions=fp["num_regions"], num_channels=fp["num_channels"],
            estimate_affine=fp.get("estimate_affine", True), **rp)
        self.bg_predictor = BGMotionPredictor(num_channels=fp["num_channels"],
                                              **fp["bg_predictor_params"])
        self.generator = Generator(num_regions=fp["num_regions"],
                                   num_channels=fp["num_channels"],
                                   revert_axis_swap=fp.get("revert_axis_swap", True),
                                   **fp["generator_params"])

    def encode_video(self, video: torch.Tensor, cond_frames: int) -> Dict[str, torch.Tensor]:
        """video (B, T, H, W, C) in [0, 1] -> flow (B, T, h, w, 2), conf (B, T, h, w, 1)
        and the reference frame's region parameters."""
        B, T = video.shape[:2]
        ref_img = video[:, cond_frames - 1]
        source_params = self.region_predictor(ref_img)
        frames = _merge_bt(video)
        driving_params = self.region_predictor(frames)
        ref_rep = ref_img.repeat_interleave(T, dim=0)  # sample-major, as _merge_bt
        bg_params = self.bg_predictor(ref_rep, frames)
        src = {k: v.repeat_interleave(T, dim=0) for k, v in source_params.items()
               if k != "heatmap"}
        gen = self.generator(ref_rep, driving_params, src, bg_params, mode="encode_flow")
        conf = gen.get("occlusion_map")
        return {"flow": _split_bt(gen["optical_flow"], B),
                "conf": _split_bt(conf, B) if conf is not None else None,
                "source_region_params": source_params}

    def ref_features(self, video: torch.Tensor, cond_frames: int,
                     pred_frames: int) -> torch.Tensor:
        """(B, tc+tp, hf, wf, 256): per-frame bottleneck features of the cond
        frames 0..tc-2, then the reference frame's repeated 1+tp times."""
        B, tc = video.shape[0], cond_frames
        feats = self.generator(_merge_bt(video[:, :tc]), mode="bottle")["bottle_neck_feat"]
        feats = _split_bt(feats, B)
        return torch.cat([feats[:, :tc - 1],
                          feats[:, tc - 1:tc].repeat_interleave(1 + pred_frames, dim=1)], dim=1)

    def decode_flows(self, ref_img: torch.Tensor, flow: torch.Tensor,
                     conf: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Decode (B, T, h, w, 2) flows and (B, T, h, w, 1) conf to pixels; the
        encoder runs once per video and its features repeat over T."""
        B, T = flow.shape[:2]
        enc = self.generator(ref_img, mode="encode_feats")
        gen = self.generator(
            ref_img.repeat_interleave(T, dim=0), mode="flow_decode",
            optical_flow=_merge_bt(flow),
            occlusion_map=_merge_bt(conf) if conf is not None else None,
            feat=enc["feat"].repeat_interleave(T, dim=0),
            skips=tuple(s.repeat_interleave(T, dim=0) for s in enc["skips"]))
        return {"out_vid": _split_bt(gen["prediction"], B),
                "warped_vid": _split_bt(gen["deformed"], B)}


@dataclass(frozen=True)
class FlowDiffusionConfig:
    flow_params: dict
    cond_frames: int
    pred_frames: int
    frame_shape: int = 64
    timesteps: int = 1000
    sampling_timesteps: int = 10
    ddim_eta: float = 1.0
    loss_type: str = "l2"
    use_residual_flow: bool = False
    dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4, 4)
    window_size: Tuple[int, int, int] = (4, 4, 4)
    attn_heads: int = 8
    attn_dim_head: int = 32
    use_ref_features: bool = True
    conditioning: str = "adaptor"
    down_adaptor_from_level: int = 0
    path: int = 0  # 1 -> THW combined temporal bias
    with_rec_losses: bool = False  # loss() also reports no-grad reconstruction monitors
    remat: bool = True  # UNet: MotionAdaptors under torch.utils.checkpoint when training
    dtype: Any = None  # compute dtype (and the frozen LFAE's storage dtype); None -> float32
    # STW layout: "0" padded windows (kernel 1), "1" window-major (kernel 9),
    # "auto" window-major on unshifted layers at spatial >= 32; the JAX
    # package reads it from EXTDM_STW_WINDOW_MAJOR (pallas_stw._window_major)
    stw_window_major: str = "0"

    @property
    def bottleneck_dim(self) -> int:
        gp = self.flow_params["generator_params"]
        return min(gp.get("max_features", 512),
                   gp.get("block_expansion", 64) * 2 ** gp.get("num_down_blocks", 2))

    def make_unet(self) -> Unet3D:
        return Unet3D(cond_feature_dim=self.bottleneck_dim, dim=self.dim,
                      dim_mults=tuple(self.dim_mults), window_size=tuple(self.window_size),
                      attn_heads=self.attn_heads, attn_dim_head=self.attn_dim_head,
                      cond_num=self.cond_frames, pred_num=self.pred_frames,
                      use_ref_features=self.use_ref_features, conditioning=self.conditioning,
                      down_adaptor_from_level=self.down_adaptor_from_level, path=self.path,
                      remat=self.remat, dtype=self.dtype,
                      stw_window_major=self.stw_window_major)

    def make_lfae(self) -> LFAE:
        return LFAE(self.flow_params)

    def make_diffusion(self) -> GaussianDiffusion:
        return GaussianDiffusion(schedule=DiffusionSchedule.create(self.timesteps),
                                 sampling_timesteps=self.sampling_timesteps,
                                 ddim_eta=self.ddim_eta, loss_type=self.loss_type)


def resolve_device(device) -> torch.device:
    """The device asked for; a CUDA device needs a card (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


class FlowDiffusion:
    """Frozen LFAE + Unet3D + diffusion process, on one device."""

    def __init__(self, cfg: FlowDiffusionConfig, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.lfae = cfg.make_lfae()
            self.unet = cfg.make_unet()
        self.lfae = self.lfae.to(self.device, cfg.dtype or torch.float32)
        self.lfae.eval().requires_grad_(False)
        self.unet = self.unet.to(self.device)  # float32 master weights, trainable
        self._sampling_unet = None  # (weight versions, copy in the compute dtype)
        self.diffusion = cfg.make_diffusion()

    def sampling_unet(self) -> Unet3D:
        """The UNet the sampler runs: the weights themselves in float32, else
        a no-grad copy cast once to the compute dtype, made again whenever the
        weights have changed (an optimizer step or a load bumps their versions)."""
        dtype = self.cfg.dtype or torch.float32
        if all(p.dtype == dtype for p in self.unet.parameters()):
            return self.unet
        key = tuple((p.data_ptr(), p._version) for p in self.unet.parameters())
        if self._sampling_unet is None or self._sampling_unet[0] != key:
            unet = copy.deepcopy(self.unet).to(dtype).requires_grad_(False)
            for p in unet.parameters():
                p.grad = None
            self._sampling_unet = (key, unet)
        return self._sampling_unet[1]

    def _identity_grid(self, h: int, w: int) -> torch.Tensor:
        return make_coordinate_grid(h, w, device=self.device)[None, None]

    def latents_from_encode(self, enc: Dict[str, torch.Tensor]) -> torch.Tensor:
        """cat(flow, conf*2-1), channels-last; residual mode subtracts the identity grid."""
        flow, conf = enc["flow"], enc["conf"]
        if self.cfg.use_residual_flow:
            flow = flow - self._identity_grid(*flow.shape[2:4])
        conf = torch.zeros_like(flow[..., :1]) if conf is None else conf * 2.0 - 1.0
        return torch.cat([flow, conf], dim=-1)

    def flow_from_pred(self, pred: torch.Tensor) -> torch.Tensor:
        flow = pred[..., :2]
        if self.cfg.use_residual_flow:
            flow = flow + self._identity_grid(*flow.shape[2:4])
        return flow

    def denoise_fn(self, cond_cache=None, unet: Optional[Unet3D] = None):
        unet = unet or self.unet

        def fn(x, t, cond_frames, cond_fea):
            return unet(x, t, cond_frames, cond_fea, cond_cache=cond_cache)
        return fn

    def cond_cache(self, x_cond: torch.Tensor, fea: Optional[torch.Tensor],
                   unet: Optional[Unet3D] = None):
        """The (x, t)-invariant conditioning term, computed once per sampler call."""
        if fea is None:
            return None
        B, tc, h, w, C = x_cond.shape
        x_dummy = torch.zeros((B, self.cfg.pred_frames, h, w, C), device=x_cond.device)
        t_dummy = torch.zeros((B,), dtype=torch.long, device=x_cond.device)
        return (unet or self.unet)(x_dummy, t_dummy, x_cond, fea, cond_only=True)

    def loss(self, generator: torch.Generator, video: torch.Tensor,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The epsilon loss of one batch, differentiable in the UNet only.
        video (B, tc+tp, H, W, C) in [0, 1]. The frozen LFAE encodes under
        no_grad; `t` and `noise` replace the draws from `generator`. Returns
        (loss, aux): aux holds the detached loss and, with
        cfg.with_rec_losses, the no-grad reconstruction monitors."""
        cfg = self.cfg
        tc, tp = cfg.cond_frames, cfg.pred_frames
        video = video.to(self.device)
        with torch.no_grad():
            enc = self.lfae.encode_video(video, tc)
            fea = self.lfae.ref_features(video, tc, tp) if cfg.use_ref_features else None
            frames = self.latents_from_encode(enc).float()
        loss, pred_x0 = self.diffusion.p_losses(self.denoise_fn(), generator, frames[:, :tc],
                                                frames[:, tc:tc + tp], fea, t=t, noise=noise)
        aux = {"loss": loss.detach()}
        if cfg.with_rec_losses:
            with torch.no_grad():
                dec = self.lfae.decode_flows(video[:, tc - 1], self.flow_from_pred(pred_x0),
                                             (pred_x0[..., 2:3] + 1.0) * 0.5)
                gt = video[:, tc:tc + tp].float()
                aux["rec_loss"] = (gt * 10.0 - dec["out_vid"].float() * 10.0).abs().mean()
                aux["rec_warp_loss"] = (gt * 10.0 - dec["warped_vid"].float() * 10.0).abs().mean()
        return loss, aux

    def make_sampler(self):
        """fn(generator, cond_video, init_noise=None) -> dict with the keys of
        the JAX sampler: sample_vid_grid, sample_vid_conf, real_vid_grid,
        real_vid_conf, sample_out_vid and sample_warped_vid.
        cond_video (B, tc, H, W, C) in [0, 1]; only the tp predicted frames
        are decoded, the real cond frames are spliced in front."""
        cfg = self.cfg
        tc, tp = cfg.cond_frames, cfg.pred_frames

        @torch.no_grad()
        def sampler(generator: torch.Generator, cond_video: torch.Tensor,
                    init_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
            cond_video = cond_video.to(self.device)
            enc = self.lfae.encode_video(cond_video, tc)
            fea = self.lfae.ref_features(cond_video, tc, tp) if cfg.use_ref_features else None
            x_cond = self.latents_from_encode(enc)
            unet = self.sampling_unet()
            cache = self.cond_cache(x_cond, fea, unet)
            pred = self.diffusion.ddim_sample(self.denoise_fn(cache, unet), generator, x_cond, tp,
                                              fea, init_noise=init_noise)
            enc_flow, enc_conf = enc["flow"], enc["conf"]
            sample_flow = torch.cat([enc_flow, self.flow_from_pred(pred)], dim=1)
            sample_conf = None
            if enc_conf is not None:
                sample_conf = torch.cat([enc_conf, (pred[..., 2:3] + 1.0) * 0.5], dim=1)
            out = {"sample_vid_grid": sample_flow, "sample_vid_conf": sample_conf,
                   "real_vid_grid": enc_flow, "real_vid_conf": enc_conf}
            dec = self.lfae.decode_flows(cond_video[:, tc - 1], sample_flow[:, tc:],
                                         None if sample_conf is None else sample_conf[:, tc:])
            for key, name in (("sample_out_vid", "out_vid"), ("sample_warped_vid", "warped_vid")):
                out[key] = torch.cat([cond_video.to(dec[name].dtype), dec[name]], dim=1)
            return out

        return sampler
