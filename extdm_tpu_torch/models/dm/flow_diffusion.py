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
from extdm_tpu_torch.parallel.mesh import gather_batch, rank_generator
from extdm_tpu_torch.utils.profiler import span


def _merge_bt(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _split_bt(x: torch.Tensor, b: int) -> torch.Tensor:
    return x.reshape((b, x.shape[0] // b) + tuple(x.shape[1:]))


class LFAE(nn.Module):
    """Frozen stage-1 bundle used inside the DM (region + bg + generator)."""

    def __init__(self, flow_params: dict, dtype=None):
        super().__init__()
        fp = flow_params
        rp = {k: v for k, v in fp["region_predictor_params"].items() if k != "fast_svd"}
        self.region_predictor = RegionPredictor(
            num_regions=fp["num_regions"], num_channels=fp["num_channels"],
            estimate_affine=fp.get("estimate_affine", True), dtype=dtype, **rp)
        self.bg_predictor = BGMotionPredictor(num_channels=fp["num_channels"], dtype=dtype,
                                              **fp["bg_predictor_params"])
        self.generator = Generator(num_regions=fp["num_regions"],
                                   num_channels=fp["num_channels"],
                                   revert_axis_swap=fp.get("revert_axis_swap", True),
                                   dtype=dtype, **fp["generator_params"])

    def encode_video(self, video: torch.Tensor, cond_frames: int,
                     with_decode: bool = False) -> Dict[str, torch.Tensor]:
        """video (B, T, H, W, C) in [0, 1] -> flow (B, T, h, w, 2), conf (B, T, h, w, 1)
        and the reference frame's region parameters. With `with_decode` the
        generator runs in full mode and also gives out_vid and warped_vid
        (B, T, H, W, C): the reference frame warped to every frame."""
        B, T = video.shape[:2]
        ref_img = video[:, cond_frames - 1]
        source_params = self.region_predictor(ref_img)
        frames = _merge_bt(video)
        driving_params = self.region_predictor(frames)
        ref_rep = ref_img.repeat_interleave(T, dim=0)  # sample-major, as _merge_bt
        bg_params = self.bg_predictor(ref_rep, frames)
        src = {k: v.repeat_interleave(T, dim=0) for k, v in source_params.items()
               if k != "heatmap"}
        gen = self.generator(ref_rep, driving_params, src, bg_params,
                             mode="full" if with_decode else "encode_flow")
        conf = gen.get("occlusion_map")
        out = {"flow": _split_bt(gen["optical_flow"], B),
               "conf": _split_bt(conf, B) if conf is not None else None,
               "source_region_params": source_params}
        if with_decode:
            out["out_vid"] = _split_bt(gen["prediction"], B)
            out["warped_vid"] = _split_bt(gen["deformed"], B)
        return out

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
        return LFAE(self.flow_params, self.dtype)

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

    def denoise_fn(self, cond_cache=None, unet: Optional[Unet3D] = None, shard=None):
        unet = unet or self.unet

        def fn(x, t, cond_frames, cond_fea, **kw):
            return unet(x, t, cond_frames, cond_fea, cond_cache=cond_cache, shard=shard, **kw)
        return fn

    @span("sample.cond_cache")
    def cond_cache(self, x_cond: torch.Tensor, fea: Optional[torch.Tensor],
                   unet: Optional[Unet3D] = None, shard=None):
        """The (x, t)-invariant conditioning term, computed once per sampler
        call; None without features and for the trajwarp conditioning, which
        depends on x and runs at every denoising step. With `shard`, x_cond
        and the term are an H shard's rows."""
        if fea is None or self.cfg.conditioning == "trajwarp":
            return None
        B, tc, h, w, C = x_cond.shape
        x_dummy = torch.zeros((B, self.cfg.pred_frames, h, w, C), device=x_cond.device)
        t_dummy = torch.zeros((B,), dtype=torch.long, device=x_cond.device)
        return (unet or self.unet)(x_dummy, t_dummy, x_cond, fea, cond_only=True, shard=shard)

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

    def make_monitor(self):
        """fn(generator, video, t=None, noise=None) -> the DM training shots'
        tensors (JAX ``make_monitor``, ref scripts/DM/train.py:281-399), under
        no_grad: ref_imgs, real_out_vid, real_warped_vid, real_vid_grid and
        real_vid_conf from the LFAE's full encode of `video` (B, tc+tp, H, W,
        C) in [0, 1]; fake_out_vid, fake_warped_vid, fake_vid_grid and
        fake_vid_conf decoded from ``p_losses``' pred_x0 at a diffusion time t
        and noise drawn from `generator` (or given), the UNet as the train
        step runs it."""
        cfg = self.cfg
        tc, tp = cfg.cond_frames, cfg.pred_frames

        @torch.no_grad()
        def monitor(generator: Optional[torch.Generator], video: torch.Tensor,
                    t: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> Dict[str, Optional[torch.Tensor]]:
            video = video.to(self.device)
            enc = self.lfae.encode_video(video, tc, with_decode=True)
            fea = self.lfae.ref_features(video, tc, tp) if cfg.use_ref_features else None
            frames = self.latents_from_encode(enc).float()
            _, pred_x0 = self.diffusion.p_losses(self.denoise_fn(), generator, frames[:, :tc],
                                                 frames[:, tc:tc + tp], fea, t=t, noise=noise)
            fake_flow = self.flow_from_pred(pred_x0)
            fake_conf = None if enc["conf"] is None else (pred_x0[..., 2:3] + 1.0) * 0.5
            dec = self.lfae.decode_flows(video[:, tc - 1], fake_flow, fake_conf)
            return {"ref_imgs": video[:, tc - 1],
                    "real_out_vid": enc["out_vid"], "real_warped_vid": enc["warped_vid"],
                    "real_vid_grid": enc["flow"], "real_vid_conf": enc["conf"],
                    "fake_out_vid": dec["out_vid"], "fake_warped_vid": dec["warped_vid"],
                    "fake_vid_grid": fake_flow, "fake_vid_conf": fake_conf}

        return monitor

    @span("sample.encode")
    def _encode(self, cond_video: torch.Tensor):
        """The LFAE's encode of the cond frames: (enc, ref features, latents)."""
        cfg = self.cfg
        enc = self.lfae.encode_video(cond_video, cfg.cond_frames)
        fea = (self.lfae.ref_features(cond_video, cfg.cond_frames, cfg.pred_frames)
               if cfg.use_ref_features else None)
        return enc, fea, self.latents_from_encode(enc)

    def _sample(self, generator: torch.Generator, cond_video: torch.Tensor, decode: bool,
                init_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        cond_video = cond_video.to(self.device)
        enc, fea, x_cond = self._encode(cond_video)
        unet = self.sampling_unet()
        cache = self.cond_cache(x_cond, fea, unet)
        pred = self.diffusion.sample(self.denoise_fn(cache, unet), generator, x_cond,
                                     self.cfg.pred_frames, fea, init_noise=init_noise)
        return self._finalize(cond_video, enc, pred, decode)

    @span("sample.decode")
    def _finalize(self, cond_video: torch.Tensor, enc: Dict[str, torch.Tensor],
                  pred: torch.Tensor, decode: bool) -> Dict[str, torch.Tensor]:
        """The sampler's dict from the encode and the predicted latents:
        the sampled flows and conf after the real ones and, with `decode`,
        the predicted frames decoded after the cond frames."""
        tc = self.cfg.cond_frames
        enc_flow, enc_conf = enc["flow"], enc["conf"]
        sample_flow = torch.cat([enc_flow, self.flow_from_pred(pred)], dim=1)
        sample_conf = None
        if enc_conf is not None:
            sample_conf = torch.cat([enc_conf, (pred[..., 2:3] + 1.0) * 0.5], dim=1)
        out = {"sample_vid_grid": sample_flow, "sample_vid_conf": sample_conf,
               "real_vid_grid": enc_flow, "real_vid_conf": enc_conf}
        if decode:
            dec = self.lfae.decode_flows(cond_video[:, tc - 1], sample_flow[:, tc:],
                                         None if sample_conf is None else sample_conf[:, tc:])
            for key, name in (("sample_out_vid", "out_vid"), ("sample_warped_vid", "warped_vid")):
                out[key] = torch.cat([cond_video.to(dec[name].dtype), dec[name]], dim=1)
        return out

    def make_sampler(self, decode: bool = True):
        """fn(generator, cond_video, init_noise=None) -> dict with the keys of
        the JAX sampler: sample_vid_grid, sample_vid_conf, real_vid_grid and
        real_vid_conf, and with `decode` sample_out_vid and sample_warped_vid.
        cond_video (B, tc, H, W, C) in [0, 1]; only the tp predicted frames
        are decoded, the real cond frames are spliced in front. Without
        `decode` the LFAE's decoder does not run."""

        @torch.no_grad()
        @span("sample")
        def sampler(generator: torch.Generator, cond_video: torch.Tensor,
                    init_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
            return self._sample(generator, cond_video, decode, init_noise)

        return sampler

    def make_sharded_sampler(self, group, decode: bool = True):
        """The data-parallel sampler (JAX ``make_sharded_sampler``,
        flow_diffusion.py:479-548) over a ``parallel.DataGroup``: fn(generator,
        cond_video, init_noise=None) with the global batch on every rank;
        each rank runs this sampler on its rows (``group.rows``) with its
        rank's generator (``rank_generator``) and the global result is
        gathered on every rank. `init_noise`, where given, is the global
        batch's x_T. The batch must divide over the group's ranks."""
        @torch.no_grad()
        @span("sample")
        def sampler(generator: torch.Generator, cond_video: torch.Tensor,
                    init_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
            rows = group.rows(cond_video.shape[0])
            out = self._sample(rank_generator(generator, group.rank), cond_video[rows], decode,
                               None if init_noise is None else init_noise[rows])
            return gather_batch(out, group)

        return sampler

    def make_spatial_sampler(self, mesh, decode: bool = True):
        """The spatial (sequence-parallel) sampler (JAX ``make_spatial_sampler``,
        flow_diffusion.py:551-693) over a ``parallel.SpatialMesh``:
        fn(generator, cond_video, init_noise=None) with the global batch on
        every rank, returning the plain sampler's dict (the global batch) on
        every rank. The LFAE encode runs on the rank's data rows (the same on
        each model rank of a row); the DDIM stage runs on its rows and its
        shard of the latent H (``Unet3D.forward(shard=...)``), every rank
        drawing the global x_T and step noise from `generator`, so that the
        result is ``make_sampler``'s on the same generator whatever the
        mesh; the latents are gathered over H, decoded on the data rows and
        the rows gathered. `init_noise`, where given, is the global x_T. The
        batch must divide over the data ranks, and every level's latent H
        over the model ranks. Inference only. Both conditioning families
        run: the adaptor family's cond stream once a call on the global H,
        cut to the shard; the trajwarp family's warp at every step on the
        shard's query rows against the whole cond features, its resize
        reading one clamped halo row of each neighbour
        (``Unet3D.forward``)."""

        @torch.no_grad()
        @span("sample")
        def sampler(generator: torch.Generator, cond_video: torch.Tensor,
                    init_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
            cond_video = cond_video[mesh.rows(cond_video.shape[0])].to(self.device)
            enc, fea, x_cond = self._encode(cond_video)
            x_cond = mesh.slice_h(x_cond)
            unet = self.sampling_unet()
            cache = self.cond_cache(x_cond, fea, unet, shard=mesh)
            pred = self.diffusion.sample(self.denoise_fn(cache, unet, shard=mesh), generator,
                                         x_cond, self.cfg.pred_frames, fea,
                                         init_noise=init_noise, shard=mesh)
            out = self._finalize(cond_video, enc, mesh.gather_h(pred), decode)
            return mesh.gather_rows(out)

        return sampler

    @torch.no_grad()
    @span("sample")
    def sample_video(self, generator: torch.Generator, cond_video: torch.Tensor,
                     decode: bool = True,
                     init_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One sampler call (JAX ``sample_video``, ref sample_one_video): the
        latents of the tc + tp window and, with `decode`, the pixels; the
        same computation and draws as ``make_sampler(decode)``; `init_noise`
        replaces the drawn x_T."""
        return self._sample(generator, cond_video, decode, init_noise)
