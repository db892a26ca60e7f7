"""JAX msgpack checkpoints -> the port's ``.pth`` files (the port's
counterpart of scripts/convert_checkpoint.py, which converts the other way).

    python -m extdm_tpu_torch.convert_checkpoint --src logs/dm/flowdiff.ckpt \\
        --out flowdiff.pth --kind dm --config configs/DM/kth.yaml
    python -m extdm_tpu_torch.convert_checkpoint --src logs/ae/RegionMM.ckpt \\
        --out RegionMM.pth --kind ae --config configs/AE/kth.yaml
    python -m extdm_tpu_torch.convert_checkpoint --src i3d.msgpack --out i3d.pth --kind i3d

Kinds:
- ``dm``: a JAX DM job's checkpoint -> the DM payload (the UNet under
  ``denoise_fn.``, AdamW's moments and counts, the example and step):
  ``train_dm --checkpoint <out> --set_start`` resumes at the JAX run's
  step, ``valid_dm --checkpoint <out>`` samples with it. Needs the yaml
  (``--arch``, ``--path`` as train_dm takes them) to build the UNet and its
  optimizer.
- ``ae``: a JAX AE job's checkpoint -> the AE payload (the three LFAE
  modules, the VGG19, the loss weights, Adam): ``train_ae --checkpoint``,
  ``valid_dm`` / ``train_dm --flowae_checkpoint``. Needs the AE yaml.
- ``lfae``, ``unet``: JAX variables -> an ``LFAE`` / ``Unet3D`` state dict
  (``--flowae_checkpoint`` / ``--checkpoint``).
- ``vgg19``, ``lpips``, ``i3d``: the networks scripts/convert_checkpoint.py
  writes -> their state dicts (``--lpips_state_dict``, ``--i3d_state_dict``).

Reference ``.pth`` files need no conversion: their key names are the
port's. The conversion rearranges arrays on the host (the models are built
on the CPU only to order the optimizer's state), so it takes no
``--device``. The file is written to a tmp file and moved into place.
"""
from __future__ import annotations

import argparse

import torch

from extdm_tpu_torch import convert
from extdm_tpu_torch.train.checkpoint import save_checkpoint
from extdm_tpu_torch.utils.msgpack import load_jax_checkpoint

KINDS = ("dm", "ae") + convert.WEIGHT_KINDS


def convert_dm(ckpt, config: str, arch: str, path: int = 0) -> dict:
    """`ckpt` (a JAX DM checkpoint's tree) as the DM job's payload."""
    from extdm_tpu_torch.config import dm_config_from_yaml, load_config
    from extdm_tpu_torch.train.dm_trainer import make_optimizer

    cfg_raw = load_config(config)
    tp = cfg_raw["diffusion_params"]["train_params"]
    unet = dm_config_from_yaml(cfg_raw, arch=arch, path=path).make_unet()
    sched = tp["scheduler_param"]
    opt = make_optimizer(unet.parameters(), tp["lr"], sched["milestones"], sched["gamma"])
    return convert.dm_payload_from_jax(ckpt, unet, opt)


def convert_ae(ckpt, config: str) -> dict:
    """`ckpt` (a JAX AE checkpoint's tree) as the AE job's payload."""
    from extdm_tpu_torch.config import ae_model_kwargs, load_config
    from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
    from extdm_tpu_torch.train.ae_trainer import AETrainer, make_optimizer

    cfg = load_config(config)
    tp = cfg["flow_params"]["train_params"]
    sched = tp["scheduler_param"]
    trainer = AETrainer(ReconstructionModel(**ae_model_kwargs(cfg)),
                        make_optimizer(tp["lr"], sched["milestones"], sched["gamma"]),
                        learnable_loss_weights=ckpt["state"].get("loss_weights") is not None,
                        device="cpu")
    return convert.ae_payload_from_jax(ckpt, trainer)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True, help="JAX checkpoint (flax msgpack)")
    p.add_argument("--out", required=True, help="the port's .pth")
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--config", default=None, help="the yaml (DM for --kind dm, AE for ae)")
    p.add_argument("--arch", default="w_ref_u22/ada_u22", help="--kind dm: the UNet preset")
    p.add_argument("--path", type=int, default=0, help="--kind dm: 1 -> THW bias variant")
    args = p.parse_args(argv)
    if args.kind in ("dm", "ae") and not args.config:
        p.error(f"--kind {args.kind} needs --config")
    ckpt = load_jax_checkpoint(args.src)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the models' init, overwritten by the checkpoint
        if args.kind == "dm":
            payload = convert_dm(ckpt, args.config, args.arch, args.path)
        elif args.kind == "ae":
            payload = convert_ae(ckpt, args.config)
        else:
            payload = convert.weights_state_dict(args.kind, ckpt)
    save_checkpoint(args.out, payload)
    extra = "" if args.kind not in ("dm", "ae") else (
        f" (example {payload['example']}, step {payload['step']}"
        + ("" if "optimizer" in payload else ", weights only: no optimizer state") + ")")
    print(f"wrote {args.out}{extra}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
