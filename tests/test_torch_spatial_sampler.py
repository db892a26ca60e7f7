"""The port's spatial sampler (``FlowDiffusion.make_spatial_sampler``) and
``valid_dm --mesh_model`` on the CPU, float32, in spawned gloo ranks
(``torch_spatial_ranks.samplers``, one spawn per world):

- at meshes (data 1, model 2), (2, 2) and (1, 4), every rank's result
  equals the port's single-process ``make_sampler`` on the same generator,
  drawn and given x_T alike (every rank draws the global x_T and step noise
  and keeps its part): the latents to 1e-5, the pixels to 1e-5 against the
  decode of those latents and to 2e-4 against the plain sampler's;
- given JAX's global x_T at DDIM eta 0, the (2, 2) result matches JAX's
  ``make_spatial_sampler`` on a (data 2, model 2) mesh of CPU devices to
  2e-4 (tests/test_parallel.py's bound against the plain sampler), the JAX
  program compiled at XLA's lowest optimisation level;
- ``valid_dm.main --mesh_data 2 --mesh_model 2`` on synthetic videos
  writes the single-process run's metric lines (but the sampling rate);
- the trajwarp family (``w_ref/traj``, tests/test_torch_traj.py's tiny
  config) in the same spawns: at the same meshes its spatial sampler
  equals its plain sampler as above; given JAX's global x_T its (2, 2)
  result matches JAX's ``make_spatial_sampler`` of that config to 2e-4;
  per UNet call its exchanges are those of the adaptor family of the same
  widths (``TRAJ_TWIN``) plus the init noise conv's halo and one clamped
  halo of kind "traj" (the resize of the warped features); ``valid_dm.main
  --mesh_model 2`` with the traj arch writes the single-process metric
  lines;
- the refusals: a world that is not data x model, a batch that does not
  divide over the data ranks, a trajwarp shard of odd rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
import torch_spatial_ranks as sranks
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu.parallel.mesh import make_mesh
from extdm_tpu_torch import config, convert
from extdm_tpu_torch.eval import valid_dm
from extdm_tpu_torch.models.dm.diffusion import ddim_time_pairs
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from extdm_tpu_torch.parallel import World, make_spatial_mesh
from extdm_tpu_torch.parallel.spatial import SpatialMesh
from extdm_tpu_torch.models.dm.adaptor import TrajWarp
from test_torch_jobs import TINY_ARCH, tiny_yaml
from test_torch_sampler import _jax_draws
from test_torch_traj import CFG as TRAJ_CFG
from test_torch_traj import TRAJ
from torch_port_helpers import close, random_variables, tiny_flow_params

t_ = torch.from_numpy
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# JAX's tiny spatial-sampler config (__graft_entry__._tiny_fd), DDIM at eta 0
CFG = dict(cond_frames=2, pred_frames=2, frame_shape=32, timesteps=50, sampling_timesteps=3,
           ddim_eta=0.0, dim=16, dim_mults=(1, 2), attn_heads=2, attn_dim_head=8)
BATCH, SEED = 4, 21
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
LATENT_KEYS = ("sample_vid_grid", "sample_vid_conf", "real_vid_grid", "real_vid_conf")
PIXEL_KEYS = {"sample_out_vid": "out_vid", "sample_warped_vid": "warped_vid"}
SAMPLER_KEYS = LATENT_KEYS + tuple(PIXEL_KEYS)
VALID_ARGV = ["--arch", "tiny", "--device", "cpu", "--synthetic_videos", "4",
              "--num_sample_video", "2", "--batch_size", "2", "--metrics", "psnr,ssim"]
# the adaptor family at the trajwarp config's widths: the exchanges it would make
TRAJ_TWIN = dict(TRAJ_CFG, conditioning="adaptor")


def jax_side(devices):
    """JAX's spatial sampler at (data 2, model 2) on a seeded tiny model,
    its global x_T, and the port's inputs (the converted weights)."""
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 71)
    unet_params = random_variables(dict(shapes[1]["params"]), 72)
    cond = np.random.default_rng(73).uniform(
        size=(BATCH, CFG["cond_frames"], 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(74)
    mesh = make_mesh(data=2, model=2, devices=devices[:4])
    spatial = jfd.make_spatial_sampler(lfae_vars, {"params": unet_params}, mesh)
    compiled = jax.jit(spatial).lower(key, jnp.asarray(cond)).compile(FAST_COMPILE)
    want = {k: np.asarray(v) for k, v in compiled(key, jnp.asarray(cond)).items()
            if v is not None}
    x_T = _jax_draws(key, (BATCH, CFG["pred_frames"], 16, 16, 3), 0)[0]
    inp = {"flow_params": tiny_flow_params(), "cfg": CFG,
           "lfae": convert.lfae_state_dict(lfae_vars),
           "unet": convert.unet_state_dict(unet_params),
           "cond": t_(cond), "x_T": t_(x_T), "seed": SEED}
    return inp, want


def jax_traj_side(devices):
    """``jax_side`` for the trajwarp config of tests/test_torch_traj.py."""
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, **TRAJ_CFG))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    lfae_vars = random_variables(dict(shapes[0]), 81)
    unet_params = random_variables(dict(shapes[1]["params"]), 82)
    cond = np.random.default_rng(83).uniform(
        size=(BATCH, TRAJ_CFG["cond_frames"], 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(84)
    mesh = make_mesh(data=2, model=2, devices=devices[:4])
    spatial = jfd.make_spatial_sampler(lfae_vars, {"params": unet_params}, mesh)
    compiled = jax.jit(spatial).lower(key, jnp.asarray(cond)).compile(FAST_COMPILE)
    want = {k: np.asarray(v) for k, v in compiled(key, jnp.asarray(cond)).items()
            if v is not None}
    x_T = _jax_draws(key, (BATCH, TRAJ_CFG["pred_frames"], 16, 16, 3), 0)[0]
    inp = {"flow_params": tiny_flow_params(), "cfg": TRAJ_CFG,
           "lfae": convert.lfae_state_dict(lfae_vars),
           "unet": convert.unet_state_dict(unet_params),
           "cond": t_(cond), "x_T": t_(x_T), "seed": SEED, "twin": TRAJ_TWIN}
    return inp, want


def _plain(inp):
    fd = ranks.dm_fd(inp)
    sampler = fd.make_sampler()
    return fd, {"drawn": sampler(torch.Generator().manual_seed(SEED), inp["cond"]),
                "given": sampler(torch.Generator().manual_seed(SEED), inp["cond"],
                                 init_noise=inp["x_T"])}


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """JAX's programs, the port's single-process samplers and evals, then
    one spawn per world running every mesh of both families (and the
    evals: the traj arch's at world 2, the adaptor arch's at world 4)."""
    inp, want = jax_side(devices)
    traj_inp, traj_want = jax_traj_side(devices)
    fd, plain = _plain(inp)
    traj_fd, traj_plain = _plain(traj_inp)
    tmp = tmp_path_factory.mktemp("spatial_sampler")
    cfg_path, _ = tiny_yaml(tmp)
    mp = pytest.MonkeyPatch()
    try:
        for name, arch in (("single", TINY_ARCH), ("traj_single", TRAJ)):
            mp.setitem(config.ARCH_PRESETS, "tiny", arch)
            valid_dm.main(["--config", cfg_path, "--log_dir", str(tmp / name)] + VALID_ARGV)
    finally:
        mp.undo()
    got = {}
    for world, meshes in MESHES.items():
        wdir = tmp / f"w{world}"
        wdir.mkdir()
        if world == 4:
            jobs, arch = [("valid_dm", ["--config", cfg_path, "--log_dir", str(tmp / "spatial"),
                                        "--mesh_data", "2", "--mesh_model", "2"] + VALID_ARGV)
                          ], TINY_ARCH
        else:
            jobs, arch = [("valid_dm", ["--config", cfg_path, "--log_dir",
                                        str(tmp / "traj_spatial"), "--mesh_model", "2"]
                           + VALID_ARGV)], TRAJ
        torch.save(dict(inp, meshes=meshes, jobs=jobs, arch=arch, traj=traj_inp),
                   wdir / "inputs.pt")
        ranks.spawn(sranks.samplers, world, str(wdir / "store"), str(wdir / "inputs.pt"),
                    str(wdir), limit_s=300.0)
        got[world] = [torch.load(wdir / f"rank{r}.pt", weights_only=False)
                      for r in range(world)]
    return dict(got=got, plain=plain, want=want, tmp=tmp, fd=fd, cond=inp["cond"],
                traj_plain=traj_plain, traj_want=traj_want, traj_fd=traj_fd,
                traj_cond=traj_inp["cond"])


def _equals_the_plain_sampler(got, plain, fd, cond):
    tc = CFG["cond_frames"]
    for how in ("drawn", "given"):
        first, want = got[0][how], plain[how]
        assert sorted(k for k, v in first.items() if v is not None) == sorted(SAMPLER_KEYS)
        for s in got[1:]:
            assert all(torch.equal(s[how][k], first[k]) for k in SAMPLER_KEYS), how
        for k in SAMPLER_KEYS:
            assert first[k].shape == want[k].shape, (how, k)
        for k in LATENT_KEYS:
            close(first[k], want[k], 1e-5)
        with torch.no_grad():
            dec = fd.lfae.decode_flows(cond[:, tc - 1], first["sample_vid_grid"][:, tc:],
                                       first["sample_vid_conf"][:, tc:])
        for k, name in PIXEL_KEYS.items():
            close(first[k][:, tc:], dec[name], 1e-5)
            close(first[k], want[k], 2e-4)


@pytest.mark.parametrize("mesh", [m for ms in MESHES.values() for m in ms])
def test_spatial_sampler_equals_the_plain_sampler(runs, mesh):
    """Every rank returns the same global dict; its latents equal the plain
    sampler's to 1e-5. Its pixels are its latents decoded (1e-5); against
    the plain sampler's pixels they hold to JAX's 2e-4, since the warp
    multiplies a latent's last-digit differences by the random image's
    slope (~5e-6 in the flows gives up to ~4e-5 in the pixels here)."""
    world = mesh[0] * mesh[1]
    got = [g[mesh] for g in runs["got"][world]]
    for r, s in enumerate(got):
        assert s["place"] == divmod(r, mesh[1])
    _equals_the_plain_sampler(got, runs["plain"], runs["fd"], runs["cond"])


@pytest.mark.parametrize("mesh", [m for ms in MESHES.values() for m in ms])
def test_traj_spatial_sampler_equals_the_plain_sampler(runs, mesh):
    """The trajwarp family, as ``test_spatial_sampler_equals_the_plain_sampler``."""
    world = mesh[0] * mesh[1]
    got = [g["traj"][mesh] for g in runs["got"][world]]
    _equals_the_plain_sampler(got, runs["traj_plain"], runs["traj_fd"], runs["traj_cond"])


@pytest.mark.parametrize("mesh", [m for ms in MESHES.values() for m in ms])
def test_spatial_sampler_exchanges(runs, mesh):
    """Every kind of exchange ran on every rank, as often on each; the
    threshold's |x0| gather once per denoising step."""
    world = mesh[0] * mesh[1]
    counts = [g[mesh]["exchanges"] for g in runs["got"][world]]
    assert all(c == counts[0] for c in counts)
    steps = len(ddim_time_pairs(CFG["timesteps"], CFG["sampling_timesteps"]))
    assert counts[0]["threshold"] == steps
    assert counts[0]["halo"] > 0 and counts[0]["stats"] > 0
    assert ("gather" in counts[0]) == (mesh[0] > 1)


@pytest.mark.parametrize("mesh", [m for ms in MESHES.values() for m in ms])
def test_traj_spatial_sampler_exchanges(runs, mesh):
    """Per UNet call, the trajwarp family's exchanges are its adaptor twin's
    (the same widths; its cond stream runs on the global H, with none) plus
    the init noise conv's halo and the warped features' clamped halo (kind
    "traj"); per sampler call, one UNet call's worth a denoising step, the
    threshold's gather and the latents' gather."""
    world = mesh[0] * mesh[1]
    runs_ = [g["traj"][mesh] for g in runs["got"][world]]
    assert all(r["exchanges"] == runs_[0]["exchanges"] for r in runs_)
    traj, twin = runs_[0]["unet_exchanges"], runs_[0]["twin_exchanges"]
    assert traj == dict(twin, halo=twin["halo"] + 1, traj=1)
    steps = len(ddim_time_pairs(TRAJ_CFG["timesteps"], TRAJ_CFG["sampling_timesteps"]))
    want = {k: steps * v for k, v in traj.items()}
    want["threshold"] = steps
    want["gather_h"] = want.get("gather_h", 0) + 1
    if mesh[0] > 1:
        want["gather"] = runs_[0]["exchanges"]["gather"]
    assert runs_[0]["exchanges"] == want


@pytest.mark.parametrize("family", ["adaptor", "traj"])
def test_spatial_sampler_matches_jax_given_its_x_T(runs, family):
    want = runs["want"] if family == "adaptor" else runs["traj_want"]
    assert sorted(want) == sorted(SAMPLER_KEYS)
    for r, g in enumerate(runs["got"][4]):
        given = (g if family == "adaptor" else g["traj"])[(2, 2)]["given"]
        for k, v in want.items():
            np.testing.assert_allclose(given[k].numpy(), v, rtol=2e-4, atol=2e-4,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("family", ["adaptor", "traj"])
def test_valid_dm_mesh_model_writes_the_single_process_metrics(runs, family):
    tmp = runs["tmp"]
    dirs = ("single", "spatial") if family == "adaptor" else ("traj_single", "traj_spatial")
    single, spatial = (open(tmp / d / "metrics.txt").read().splitlines() for d in dirs)
    assert [line.split(":")[0] for line in spatial] == [
        "psnr2 (best-of-2)", "ssim2 (best-of-2)", "sampling_frames_per_sec"]
    assert spatial[:-1] == single[:-1]


def test_spatial_sampler_refusals():
    world3 = World(rank=0, size=3, local_rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match=r"needs 4 ranks; the world has 3"):
        make_spatial_mesh(world3, 2, 2)
    # a (data 2, model 1) mesh's first rank: the batch of 3 does not split
    world2 = World(rank=0, size=2, local_rank=0, device=torch.device("cpu"), backend="gloo")
    mesh = SpatialMesh(data=2, model=1, world=world2, d=0, m=0)
    fd = FlowDiffusion(FlowDiffusionConfig(flow_params=tiny_flow_params(), **CFG), device="cpu")
    cond = torch.rand(3, CFG["cond_frames"], 32, 32, 3)
    with pytest.raises(ValueError, match="batch 3 does not split over 2 data ranks"):
        fd.make_spatial_sampler(mesh)(torch.Generator().manual_seed(0), cond)
    # a trajwarp shard of 3 rows: its 2x2 max-pool would read across shards
    warp = TrajWarp(8, 1, 1, heads=2)
    with pytest.raises(ValueError, match="a shard's rows must be even"):
        warp(torch.rand(1, 1, 3, 4, 8), torch.rand(1, 2, 4, 2, 8), shard=mesh)
