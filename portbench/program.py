"""What the benchmark takes from the program (the PyTorch port): its
configuration object, its FlowDiffusion built on the card with the
benchmark's seeded weights, and the shapes of its latents."""
from __future__ import annotations

import torch

from portbench import weights


def latent_size(model: dict) -> int:
    """The latents' height and width: the LFAE's flow resolution."""
    pf = model["flow_params"]["generator_params"]["pixelwise_flow_predictor_params"]
    return int(model["frame_shape"] * pf["scale_factor"])


def program_config(config: dict, **extra):
    """The program's configuration of the benchmark configuration `config`,
    computing in the configuration's dtype; the program's own defaults for
    everything the configuration does not state (its layouts, remat)."""
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusionConfig

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items()}
    return FlowDiffusionConfig(**kw, dtype=getattr(torch, config["dtype"]), **extra)


def build(run, **extra):
    """The program's FlowDiffusion with the run's seeded weights, its
    modules made on the device."""
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion

    with torch.device(run.device):
        fd = FlowDiffusion(program_config(run.config, **extra), device=run.device)
    load_weights(fd, run.config, run.seed, run.device)
    return fd


def load_weights(fd, config: dict, seed: int, device) -> None:
    sd = weights.state_dict(config["model"], seed, device)
    fd.lfae.load_state_dict(weights.split(sd, "lfae."))
    fd.unet.load_state_dict(weights.split(sd, "unet."))
