"""The JAX package's checkpoints in the port, on the CPU at tiny sizes.

- ``utils.msgpack`` against ``flax.serialization.msgpack_restore`` on files
  written by ``extdm_tpu.train.save_checkpoint``: the same structure, leaf
  types, dtypes and values, exactly (a bf16 leaf as a torch.bfloat16 tensor
  of the same bits): a DM train state with its adamw state, with and
  without the nan guard; an AE train state with batch statistics and
  learnable loss weights; bf16 leaves, numpy scalars, a complex number,
  leaves chunked at a lowered ``MAX_CHUNK_SIZE``. A malformed file raises
  ValueError.
- ``convert_checkpoint`` of those states: the converted UNet's forward and
  the converted LFAE's ``encode_video`` against JAX's on the same inputs
  (2e-4, float32); one optimizer step from the converted state against
  optax's ``tx.update`` on the same gradients, parameters and moments
  within 1e-6 of max(1, |p|); the counts carried; ``start_step`` from the
  carried example as JAX computes it.
The optax states are ``tx.init`` with seeded moments and counts: no JAX
train step is compiled.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from extdm_tpu.config import ae_model_kwargs as j_ae_model_kwargs
from extdm_tpu.models.dm.flow_diffusion import LFAE as JLFAE
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusion as JFlowDiffusion
from extdm_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JConfig
from extdm_tpu.models.lfae import recon_model as j_recon
from extdm_tpu.train import ae_trainer as j_ae_trainer
from extdm_tpu.train import checkpoint as jckpt
from extdm_tpu.train import dm_trainer as j_dm_trainer
from extdm_tpu_torch import config, convert, convert_checkpoint
from extdm_tpu_torch.eval import valid_dm
from extdm_tpu_torch.models.dm.flow_diffusion import LFAE
from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
from extdm_tpu_torch.train import ae_trainer, checkpoint, dm_trainer
from extdm_tpu_torch.utils import msgpack
from test_torch_jobs import TINY_ARCH, tiny_yaml
from torch_port_helpers import close, random_variables, tiny_flow_params

t_ = torch.from_numpy
TC = 2
LFAE_PARTS = ("region_predictor", "bg_predictor", "generator")


def same(got, want, path="tree"):
    """`got` (utils.msgpack) is `want` (flax) exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def seeded_adam(opt_state, params, seed, count, schedule_count):
    """optax adam(w) state (a tx.init) with seeded moments and the counts."""
    rng = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(
        lambda p: (1e-3 * rng.normal(size=np.shape(p))).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda p: rng.uniform(1e-7, 1e-5, size=np.shape(p)).astype(np.float32), params)
    parts = list(opt_state)
    parts[0] = parts[0]._replace(count=jnp.int32(count), mu=mu, nu=nu)
    parts[-1] = parts[-1]._replace(count=jnp.int32(schedule_count))
    return tuple(parts)


def dm_state(params, tp, guard):
    sched = tp["scheduler_param"]
    tx = j_dm_trainer.make_optimizer(tp["lr"], sched["milestones"], sched["gamma"],
                                     nan_guard=2 if guard else 0)
    opt = tx.init(params)
    if guard:
        inner = seeded_adam(opt.inner_state, params, 3, 7, 5)
        opt = opt._replace(inner_state=inner, notfinite_count=jnp.int32(1))
    else:
        opt = seeded_adam(opt, params, 3, 7, 5)
    return tx, j_dm_trainer.DMTrainState(step=jnp.int32(7), unet_params=params, opt_state=opt)


@pytest.fixture(scope="module")
def dm(tmp_path_factory):
    """The tiny DM yaml (milestone at update 5, so the carried schedule count
    5 takes the decayed rate), the JAX UNet's seeded params and the two
    checkpoints (nan guard off, on) at example 21, step 5."""
    tmp = tmp_path_factory.mktemp("dm")
    cfg_path, cfg = tiny_yaml(tmp)
    cfg["diffusion_params"]["train_params"]["scheduler_param"] = dict(milestones=[5], gamma=0.5)
    open(cfg_path, "w").write(yaml.safe_dump(cfg))
    tp = cfg["diffusion_params"]["train_params"]
    jfd = JFlowDiffusion(JConfig(flow_params=tiny_flow_params(), remat=False, cond_frames=TC,
                                 pred_frames=2, frame_shape=32, sampling_timesteps=2, **TINY_ARCH))
    shapes = jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0))
    params = random_variables(dict(shapes[1]["params"]), 2)
    out = {"cfg_path": cfg_path, "tp": tp, "jfd": jfd, "params": params}
    for guard in (False, True):
        tx, state = dm_state(params, tp, guard)
        path = str(tmp / f"flowdiff_{int(guard)}.ckpt")
        jckpt.save_checkpoint(path, {"example": 21, "step": 5, "state": state})
        out[guard] = (tx, state, path)
    return out


@pytest.fixture(scope="module")
def ae(tmp_path_factory):
    """The tiny AE yaml (no perceptual loss: no VGG19), the JAX
    ReconstructionModel's seeded variables, learnable loss weights and
    the checkpoint."""
    tmp = tmp_path_factory.mktemp("ae")
    cfg_path, cfg = tiny_yaml(tmp)
    tp = cfg["flow_params"]["train_params"]
    tp["loss_weights"]["perceptual"] = [0, 0, 0, 0, 0]
    open(cfg_path, "w").write(yaml.safe_dump(cfg))
    jmodel = j_recon.ReconstructionModel(train=True, **j_ae_model_kwargs(cfg))
    zeros = jnp.zeros((2, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "tps": jax.random.PRNGKey(1)},
        {"source": zeros, "driving": zeros}))
    variables = random_variables(dict(shapes), 5)
    params, stats = variables["params"], variables["batch_stats"]
    lw = {k: np.float32(1.0 + 0.1 * i) for i, k in enumerate(ae_trainer.LOSS_KEYS)}
    sched = tp["scheduler_param"]
    tx = j_ae_trainer.make_optimizer(tp["lr"], sched["milestones"], sched["gamma"])
    opt = seeded_adam(tx.init((params, lw)), (params, lw), 6, 4, 4)
    state = j_ae_trainer.AETrainState(step=jnp.int32(4), params=params, batch_stats=stats,
                                      loss_weights=lw, opt_state=opt)
    path = str(tmp / "RegionMM.ckpt")
    jckpt.save_checkpoint(path, {"example": 8, "step": 4, "state": state})
    return {"cfg_path": cfg_path, "tp": tp, "tx": tx, "state": state, "path": path}


# ------------------------------------------------------------------ reader
@pytest.mark.parametrize("case", ["dm", "dm_nan_guard", "ae"])
def test_reader_matches_flax_on_train_states(case, dm, ae):
    path = {"dm": dm[False][2], "dm_nan_guard": dm[True][2], "ae": ae["path"]}[case]
    raw = open(path, "rb").read()
    got, want = msgpack.load_jax_checkpoint(path), serialization.msgpack_restore(raw)
    same(got, want)
    opt = got["state"]["opt_state"]
    assert ("inner_state" in opt) == (case == "dm_nan_guard")


def _leaves_payload():
    rng = np.random.default_rng(9)
    return {"bf16": {"w": jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16),
                     "s": jnp.bfloat16(2.5)},
            "scalars": {"f32": np.float32(1.25), "i64": np.int64(-3), "u8": np.uint8(7),
                        "b": np.bool_(True), "py_int": 12, "py_float": 0.5, "py_bool": False,
                        "none": None, "k" * 40: 1, "key" * 100: 2},
            "complex": complex(1.5, -2.0),
            "arrays": {"i32": rng.integers(-9, 9, size=(2, 3)).astype(np.int32),
                       "f64": rng.normal(size=(70000,)), "empty": np.zeros((0, 4), np.float32),
                       "c64": np.asarray([1 + 2j, -3j], np.complex64)},
            "tuple": (np.float32(1.0), {"x": np.arange(3)})}


def test_reader_matches_flax_on_leaf_kinds(tmp_path):
    """bf16 arrays and scalars, numpy and python scalars, complex numbers,
    keys of each str length class, a 560 kB array (bin 32), an empty array,
    a tuple (a map of "0", "1")."""
    path = str(tmp_path / "leaves.ckpt")
    jckpt.save_checkpoint(path, _leaves_payload())
    got = msgpack.load_jax_checkpoint(path)
    same(got, serialization.msgpack_restore(open(path, "rb").read()))
    assert got["bf16"]["w"].dtype == torch.bfloat16 and got["complex"] == complex(1.5, -2.0)


def test_reader_joins_chunked_leaves(tmp_path, monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into
    {"__msgpack_chunked_array__", "shape", "chunks"}; lowered to 64 bytes,
    every array here is chunked (a bf16 one too)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(10)
    payload = {"a": rng.normal(size=(5, 7)).astype(np.float32),
               "nested": {"b": np.arange(40, dtype=np.int32).reshape(2, 4, 5),
                          "c": jnp.asarray(rng.normal(size=(9, 9)), jnp.bfloat16)},
               "small": np.float32(3.0)}
    path = str(tmp_path / "chunked.ckpt")
    jckpt.save_checkpoint(path, payload)
    raw = open(path, "rb").read()
    assert raw.count(b"__msgpack_chunked_array__") == 3
    same(msgpack.load_jax_checkpoint(path), serialization.msgpack_restore(raw))


@pytest.mark.parametrize("fault", ["truncated", "trailing", "unknown_ext", "reserved_byte",
                                   "bad_ndarray", "bad_dtype", "empty"])
def test_malformed_file_raises(tmp_path, fault):
    import msgpack as real_msgpack

    good = serialization.msgpack_serialize({"a": np.arange(4.0), "b": {"c": 1}})
    data = {"truncated": good[:-3], "trailing": good + b"\x00",
            "unknown_ext": real_msgpack.packb({"a": real_msgpack.ExtType(9, b"xy")}),
            "reserved_byte": b"\x81\xa1a\xc1",
            "bad_ndarray": real_msgpack.packb(real_msgpack.ExtType(1, real_msgpack.packb([1, 2]))),
            "bad_dtype": real_msgpack.packb(real_msgpack.ExtType(
                1, real_msgpack.packb(((2,), "float33", b"\x00" * 8), use_bin_type=True))),
            "empty": b""}[fault]
    path = tmp_path / "bad.ckpt"
    path.write_bytes(data)
    with pytest.raises(ValueError):
        msgpack.load_jax_checkpoint(str(path))


# ----------------------------------------------------------------- the DM
def _convert(tmp_path, monkeypatch, src, kind, cfg_path):
    monkeypatch.setitem(config.ARCH_PRESETS, "tiny", TINY_ARCH)
    out = str(tmp_path / f"{kind}.pth")
    assert convert_checkpoint.main(["--src", src, "--out", out, "--kind", kind, "--config",
                                    cfg_path, "--arch", "tiny"]) == 0
    return checkpoint.load_checkpoint(out)


def _port_dm(dm, payload, guard):
    cfg_raw = yaml.safe_load(open(dm["cfg_path"]))
    unet = config.dm_config_from_yaml(cfg_raw, arch="tiny").make_unet()
    tp = dm["tp"]
    opt = dm_trainer.make_optimizer(unet.parameters(), tp["lr"],
                                    tp["scheduler_param"]["milestones"],
                                    tp["scheduler_param"]["gamma"], nan_guard=2 if guard else 0)
    checkpoint.restore_dm(payload, unet, opt)
    return unet, opt


def test_converted_unet_forward_matches_jax(dm, tmp_path, monkeypatch):
    payload = _convert(tmp_path, monkeypatch, dm[False][2], "dm", dm["cfg_path"])
    assert (payload["example"], payload["step"]) == (21, 5)
    unet, _ = _port_dm(dm, payload, False)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 2, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, TC, 16, 16, 3)).astype(np.float32)
    fea = rng.normal(size=(2, 4, 8, 8, 32)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    ref = jax.jit(lambda p, *a: dm["jfd"].unet.apply({"params": p}, *a))(
        dm["params"], *map(jnp.asarray, (x, t, cond, fea)))
    with torch.no_grad():
        out = unet(t_(x), t_(t).long(), t_(cond), t_(fea))
    close(out, ref, 2e-4)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (1e-2 * rng.normal(size=np.shape(p))).astype(np.float32), params)


def _max_rel(got, want):
    return max(float((g - torch.tensor(np.asarray(w))).abs().max())
               / max(1.0, float(np.abs(np.asarray(w)).max())) for g, w in zip(got, want))


@pytest.mark.parametrize("guard", [False, True], ids=["adamw", "adamw_nan_guard"])
def test_dm_optimizer_step_matches_optax(dm, tmp_path, monkeypatch, guard):
    """One AdamW step from the converted state (Adam's count 7, the
    schedule's 5 at milestone 5: the decayed rate) against tx.update on the
    same gradients; the nan guard's count 1 carried and reset by the step."""
    tx, state, src = dm[guard]
    payload = _convert(tmp_path, monkeypatch, src, "dm", dm["cfg_path"])
    assert (payload["optimizer"]["count"], payload["optimizer"]["notfinite_count"]) == (
        5, 1 if guard else 0)
    assert {float(s["step"]) for s in payload["optimizer"]["state"].values()} == {7.0}
    unet, opt = _port_dm(dm, payload, guard)
    grads = _grads(dm["params"], 11)
    gsd = convert.unet_state_dict(grads)
    for name, p in unet.named_parameters():
        p.grad = gsd[name].clone()
    assert opt.step()
    updates, new_opt = jax.jit(tx.update)(grads, state.opt_state, state.unet_params)
    want = convert.unet_state_dict(jax.tree_util.tree_map(
        np.asarray, j_dm_trainer.optax.apply_updates(state.unet_params, updates)))
    names = [n for n, _ in unet.named_parameters()]
    assert _max_rel([p.detach() for _, p in unet.named_parameters()],
                    [want[n] for n in names]) <= 1e-6
    adam = convert.optax_adam_state(serialization.to_state_dict(new_opt))
    mu = convert.unet_state_dict(jax.tree_util.tree_map(np.asarray, adam["mu"]))
    nu = convert.unet_state_dict(jax.tree_util.tree_map(np.asarray, adam["nu"]))
    st = [opt.opt.state[p] for _, p in unet.named_parameters()]
    assert _max_rel([s["exp_avg"] for s in st], [mu[n] for n in names]) <= 1e-6
    assert _max_rel([s["exp_avg_sq"] for s in st], [nu[n] for n in names]) <= 1e-6
    assert opt.count == adam["schedule_count"] == 6 and opt.notfinite_count == 0


def test_start_step_from_carried_example(dm, tmp_path, monkeypatch):
    payload = _convert(tmp_path, monkeypatch, dm[False][2], "dm", dm["cfg_path"])
    for batch in (1, 2, 4, 5):
        assert checkpoint.start_step_from_example(payload["example"], batch) == \
            jckpt.start_step_from_example(21, batch)


def test_weights_only_dm_loads_for_sampling_not_training(dm, tmp_path, monkeypatch):
    """JAX's convert_checkpoint.py --kind dm layout ({"state": {"unet_params"}},
    "example"): a payload without "optimizer"; valid_dm loads it, a resume
    raises."""
    src = str(tmp_path / "weights.msgpack")
    jckpt.save_checkpoint(src, {"state": {"unet_params": dm["params"]}, "example": 0})
    payload = _convert(tmp_path, monkeypatch, src, "dm", dm["cfg_path"])
    assert "optimizer" not in payload
    cfg_raw = yaml.safe_load(open(dm["cfg_path"]))
    unet = config.dm_config_from_yaml(cfg_raw, arch="tiny").make_unet()
    checkpoint.restore_dm(payload, unet)
    ref = convert.unet_state_dict(dm["params"])
    assert all(torch.equal(v, ref[k]) for k, v in unet.state_dict().items() if k in ref)
    opt = dm_trainer.make_optimizer(unet.parameters(), 1e-3, (5,), 0.5)
    with pytest.raises(ValueError, match="weights only"):
        checkpoint.restore_dm(payload, unet, opt)


# ----------------------------------------------------------------- the AE
def test_converted_lfae_encode_matches_jax(ae, tmp_path, monkeypatch):
    """--kind ae, then the LFAE valid_dm --flowae_checkpoint builds from it,
    against JAX's LFAE on the AE state's three modules (as
    scripts/train_dm.py's load_lfae_variables takes them)."""
    _convert(tmp_path, monkeypatch, ae["path"], "ae", ae["cfg_path"])
    lfae = LFAE(tiny_flow_params()).eval()
    valid_dm.load_lfae(lfae, str(tmp_path / "ae.pth"))
    st = ae["state"]
    jvars = {"params": {k: st.params[k] for k in LFAE_PARTS},
             "batch_stats": {k: st.batch_stats.get(k, {}) for k in LFAE_PARTS}}
    video = np.random.default_rng(12).uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)
    jl = JLFAE(flow_params=tiny_flow_params())
    ref = jax.jit(lambda v, x: jl.apply(v, x, TC, method=JLFAE.encode_video))(
        jvars, jnp.asarray(video))
    with torch.no_grad():
        out = lfae.encode_video(t_(video), TC)
    close(out["flow"], ref["flow"], 2e-4)
    close(out["conf"], ref["conf"], 2e-4)


def test_ae_optimizer_step_matches_optax(ae, tmp_path, monkeypatch):
    """Adam(0.5, 0.999) over the model and the learnable loss weights: one
    step from the converted state against tx.update."""
    payload = _convert(tmp_path, monkeypatch, ae["path"], "ae", ae["cfg_path"])
    assert (payload["example"], payload["step"], payload["optimizer"]["count"]) == (8, 4, 4)
    cfg = yaml.safe_load(open(ae["cfg_path"]))
    tp = ae["tp"]
    trainer = ae_trainer.AETrainer(
        ReconstructionModel(**config.ae_model_kwargs(cfg)),
        ae_trainer.make_optimizer(tp["lr"], tp["scheduler_param"]["milestones"],
                                  tp["scheduler_param"]["gamma"]),
        learnable_loss_weights=True, device="cpu")
    checkpoint.restore_ae(payload, trainer.model, trainer.optimizer, trainer.loss_weights)
    st = ae["state"]
    gparams = _grads(st.params, 13)
    glw = {k: np.float32(0.01 * (i + 1)) for i, k in enumerate(ae_trainer.LOSS_KEYS)}
    gsd = convert.recon_state_dict({"params": gparams})
    for name, p in trainer.model.named_parameters():
        p.grad = gsd[name].clone()
    for k, w in trainer.loss_weights.items():
        w.grad = torch.tensor(glw[k])
    assert trainer.optimizer.step()
    updates, _ = jax.jit(ae["tx"].update)((gparams, glw), st.opt_state,
                                          (st.params, st.loss_weights))
    new_params, new_lw = j_ae_trainer.optax.apply_updates((st.params, st.loss_weights), updates)
    want = convert.recon_state_dict({"params": jax.tree_util.tree_map(np.asarray, new_params)})
    named = list(trainer.model.named_parameters())
    assert _max_rel([p.detach() for _, p in named], [want[n] for n, _ in named]) <= 1e-6
    assert _max_rel([trainer.loss_weights[k].detach() for k in ae_trainer.LOSS_KEYS],
                    [new_lw[k] for k in ae_trainer.LOSS_KEYS]) <= 1e-6


def test_weights_only_kinds(dm, ae, tmp_path):
    """--kind lfae / unet through a file: the maps of the existing converters
    (unet from its variables or their "params"); a bf16 leaf converts to
    float32 of its value; an unknown kind raises."""
    st = ae["state"]
    lfae_vars = {"params": {k: st.params[k] for k in LFAE_PARTS},
                 "batch_stats": {k: st.batch_stats.get(k, {}) for k in LFAE_PARTS}}
    cases = [("lfae", lfae_vars, convert.lfae_state_dict(lfae_vars)),
             ("unet", {"params": dm["params"]}, convert.unet_state_dict(dm["params"])),
             ("unet", dm["params"], convert.unet_state_dict(dm["params"]))]
    for i, (kind, tree, want) in enumerate(cases):
        src, out = str(tmp_path / f"{i}.msgpack"), str(tmp_path / f"{i}.pth")
        jckpt.save_checkpoint(src, tree)
        assert convert_checkpoint.main(["--src", src, "--out", out, "--kind", kind]) == 0
        got = checkpoint.load_checkpoint(out)
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    rng = np.random.default_rng(14)
    tree = {"params": {"w": jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16)}}
    path = str(tmp_path / "bf16.msgpack")
    jckpt.save_checkpoint(path, tree)
    leaf = msgpack.load_jax_checkpoint(path)["params"]["w"]
    np.testing.assert_array_equal(convert._array(leaf),
                                  np.asarray(tree["params"]["w"]).astype(np.float32))
    with pytest.raises(ValueError, match="kind"):
        convert.weights_state_dict("resnet", tree)
