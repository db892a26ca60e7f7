"""The benchmark's plain float32 reference against the program's plain
path (the port on the CPU, float32, where every kernel runs its plain
version) at a small size, from the benchmark's seeded weights.

Tolerances: both sides compute the same float32 arithmetic in other
orders (F.group_norm against per-group sums, F.grid_sample against a
four-corner gather, conv3d against per-frame conv2d), through 3 DDIM steps
of ~30 layers and the LFAE; such differences stay at a few float32 ulps
amplified by the depth (measured: 1.4e-6 relative on the latents). 1e-5 is
ten times that and ~10^4 below the bfloat16 gaps the card's check sees.
The gradient tolerance is looser (1e-4): a parameter whose gradient is
small against the loss's scale collects the rounding of the whole
backward."""
import hashlib
import json

import pytest
import torch

from portbench import harness, weights
from portbench.reference.pipeline import Reference
from portbench.tests import tiny

SAMPLE_TOL = 1e-5
GRAD_TOL = 1e-4


def rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def build_sides(model: dict):
    """The reference and the program's FlowDiffusion on the CPU, in float32,
    with the same seeded weights; the reference's keys must be the program's."""
    from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

    sd = weights.state_dict(model, 1234, "cpu")
    ref = Reference(model)
    ref.load_state_dict(sd)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items()}
    fd = FlowDiffusion(FlowDiffusionConfig(**kw), device="cpu")
    fd.lfae.load_state_dict(weights.split(sd, "lfae."))
    fd.unet.load_state_dict(weights.split(sd, "unet."))
    return ref, fd


def program_keys(fd) -> set:
    return {f"lfae.{k}" for k in fd.lfae.state_dict()} | {f"unet.{k}" for k in fd.unet.state_dict()}


def assert_sampler_matches(ref, fd):
    """A sampler call of 3 rows (tiny's 2 + 3 frames at 16 px) on both sides."""
    tc, tp, h = 2, 3, 8
    video = weights.clips(5, 1, 3, tc, 16, "cpu")
    noise = torch.randn(3, tp, h, h, 3, generator=torch.Generator().manual_seed(2))
    out = fd.make_sampler()(torch.Generator().manual_seed(9), video, init_noise=noise)
    g = torch.Generator().manual_seed(9)
    draws = {i: torch.randn(3, tp, h, h, 3, generator=g) for i in ref.noise_steps()}
    with torch.no_grad():
        r = ref.sample(video, noise, draws.__getitem__)
    assert rel(out["sample_vid_grid"][:, tc:], r["flow"]) < SAMPLE_TOL
    assert rel(out["sample_vid_conf"][:, tc:], r["conf"]) < SAMPLE_TOL
    assert rel(out["sample_out_vid"][:, tc:], r["frames"]) < SAMPLE_TOL


def assert_gradients_match(ref, fd):
    """The loss of 3 clips and every denoiser parameter's gradient on both sides."""
    video = weights.clips(7, 1, 3, 5, 16, "cpu")
    t = torch.tensor([3, 400, 999])
    noise = torch.randn(3, 3, 8, 8, 3, generator=torch.Generator().manual_seed(4))
    fd.unet.zero_grad()
    ref.unet.zero_grad()
    loss_p, _ = fd.loss(None, video, t=t, noise=noise)
    loss_p.backward()
    loss_r = ref.loss(video, t, noise)
    loss_r.backward()
    assert abs(loss_p.item() - loss_r.item()) <= SAMPLE_TOL * abs(loss_r.item())
    got = dict(fd.unet.named_parameters())
    for name, p in ref.unet.named_parameters():
        assert got[name].grad is not None and p.grad is not None, name
        scale = max(p.grad.norm().item(), 1e-3 * loss_r.item())
        assert (got[name].grad - p.grad).norm().item() <= GRAD_TOL * scale, name


@pytest.fixture(scope="module")
def sides():
    return build_sides(tiny.MODEL)


def test_state_dict_keys_are_the_programs(sides):
    ref, fd = sides
    assert set(ref.state_dict()) == program_keys(fd)


def test_sampler_call_matches_program(sides):
    assert_sampler_matches(*sides)


def test_rows_are_independent(sides):
    """The check runs only some rows of a call through the reference."""
    ref, _ = sides
    video = weights.clips(6, 1, 4, 2, 16, "cpu")
    noise = torch.randn(4, 3, 8, 8, 3, generator=torch.Generator().manual_seed(3))
    draws = {i: torch.randn(4, 3, 8, 8, 3, generator=torch.Generator().manual_seed(i))
             for i in ref.noise_steps()}
    with torch.no_grad():
        whole = ref.sample(video, noise, draws.__getitem__)
        part = ref.sample(video[[1, 3]], noise[[1, 3]], lambda i: draws[i][[1, 3]])
    for key in ("flow", "conf", "frames"):
        assert rel(part[key], whole[key][[1, 3]]) < SAMPLE_TOL


def test_loss_and_gradients_match_program(sides):
    assert_gradients_match(*sides)


def test_block_gradients_sum_to_the_batch(sides):
    """The check sums the reference's gradient over blocks of rows."""
    ref, _ = sides
    video = weights.clips(8, 1, 4, 5, 16, "cpu")
    t = torch.tensor([1, 200, 500, 900])
    noise = torch.randn(4, 3, 8, 8, 3, generator=torch.Generator().manual_seed(5))
    ref.unet.zero_grad()
    ref.loss(video, t, noise).backward()
    whole = {n: p.grad.clone() for n, p in ref.unet.named_parameters()}
    ref.unet.zero_grad()
    for part in (slice(0, 2), slice(2, 4)):
        (ref.loss(video[part], t[part], noise[part]) * 0.5).backward()
    for n, p in ref.unet.named_parameters():
        assert (p.grad - whole[n]).norm() <= GRAD_TOL * max(whole[n].norm(), 1e-6), n


# sha256 of the reference's state-dict entries, "key shape dtype" a line in
# order: the seeded weights are one draw in this order, so a cell's weights
# stay bit for bit what they were only while these hold.
KEY_ORDER = {"kth64_u22": "d35dfe1280869dbba70f60b33b0e19c4186f3cf542d06c5b12388708a1ec1323",
             "city128_u22": "e4a6fa1238f384143aa8122490bbb9cad7ac9f7bdf91bab1e63e9737dd78d715"}


@pytest.mark.parametrize("name", sorted(KEY_ORDER))
def test_adaptor_configurations_keep_their_key_order(name):
    model = json.loads((harness.PKG / "configs" / f"{name}.json").read_text())["model"]
    with torch.device("meta"):
        sd = Reference(model).state_dict()
    lines = "\n".join(f"{k} {tuple(v.shape)} {v.dtype}" for k, v in sd.items())
    assert hashlib.sha256(lines.encode()).hexdigest() == KEY_ORDER[name]
