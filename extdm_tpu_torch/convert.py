"""JAX variables -> this package's state dicts.

Input: the JAX package's variables as a nested dict of numpy arrays (what
``flax.core.unfreeze`` + ``np.asarray`` give). Output: PyTorch state dicts
for ``LFAE``, ``ReconstructionModel``, ``Unet3D`` and the metrics' LPIPS and
I3D, whose keys are the reference PyTorch model's (torchvision's for the
VGG19, the lpips package's and pytorch_i3d's for the metrics), so this is the
inverse of the JAX package's torch -> flax mapping
(``extdm_tpu/convert/torch2jax.py``). The split init conv of the JAX UNet
(latent part + cond-feature part) is joined back into one conv.

Whole JAX checkpoints (``utils.msgpack.load_jax_checkpoint``) become the
payloads of the port's jobs: ``dm_payload_from_jax`` / ``ae_payload_from_jax``
carry the weights, the example and step counts and the optax Adam(W)
state (its moments through the same tree map as the weights, its counts
into ``ScheduledOptimizer``'s); ``weights_state_dict`` maps a weights-only
file. ``python -m extdm_tpu_torch.convert_checkpoint`` writes them.

The trajwarp UNet's own parameters (``init_noise_conv``, ``init_traj``'s
``linear_q`` / ``linear_k`` / ``linear_v`` / ``linear_o`` and ``fuser``) and
the guidance's ``null_cond_emb`` are named after the JAX tree's modules:
no checkpoint of the reference's traj denoisers is at hand to read its
names from, so a reference traj checkpoint may need a rename.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from extdm_tpu_torch.metrics.lpips import ALEX_CONV_IDX, ScalingLayer
from extdm_tpu_torch.models.lfae.vgg import VGG19_CONV_IDX

StateDict = Dict[str, torch.Tensor]


def _array(v) -> np.ndarray:
    """A leaf as numpy; a bfloat16 tensor (``utils.msgpack``'s leaf) as float32."""
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, _array(v)


def conv_weight(kernel: np.ndarray) -> np.ndarray:
    """flax (*spatial, I, O) -> torch (O, I, *spatial)."""
    nd = kernel.ndim
    return np.transpose(kernel, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def conv_transpose_weight(kernel: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (D, H, W, I, O), spatially flipped -> torch (I, O, D, H, W)."""
    return np.transpose(kernel[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))


def _leaf(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """Leaf renames shared by every module: kernel/scale/mean/var."""
    head, _, leaf = path.rpartition("/")
    if leaf == "kernel":
        value = value.T if value.ndim == 2 else conv_weight(value)
        leaf = "weight"
    leaf = {"scale": "weight", "mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
    return f"{head}/{leaf}" if head else leaf, value


def _tensors(items) -> StateDict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in items}


# ------------------------------------------------------------------------ LFAE
_LFAE_SEGMENTS = [
    (re.compile(r"^(down|up)(\d+)$"), r"\1_blocks.\2"),          # Encoder / Decoder
    (re.compile(r"^(down_blocks|up_blocks)_(\d+)$"), r"\1.\2"),  # Generator lists
    (re.compile(r"^bottleneck_(\d+)$"), r"bottleneck.r\1"),
]


def _lfae_segment(s: str) -> str:
    for pattern, repl in _LFAE_SEGMENTS:
        s = pattern.sub(repl, s)
    return s


def lfae_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``LFAE`` variables ({"params", "batch_stats"}) -> ``LFAE`` state dict."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            segs = path.split("/")
            # the flax Conv/BatchNorm wrappers hold an inner "conv"/"bn" module
            if len(segs) >= 3 and segs[-2] in ("conv", "bn"):
                del segs[-2]
            path, value = _leaf("/".join(_lfae_segment(s) for s in segs), value)
            sd[path.replace("/", ".")] = value
    out = _tensors(sd.items())
    for key in [k for k in out if k.endswith(".running_var")]:
        out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def recon_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``ReconstructionModel`` variables ({"params", "batch_stats"}:
    region_predictor, bg_predictor, generator, vgg) -> the port's
    ``ReconstructionModel`` state dict. A gradient tree given as {"params":
    grads} converts the same way, key by key."""
    params = dict(variables.get("params", {}))
    vgg = params.pop("vgg", {})
    out = lfae_state_dict({"params": params, "batch_stats": variables.get("batch_stats", {})})
    if vgg:
        out.update({f"vgg.{k}": v for k, v in vgg19_state_dict({"params": vgg}).items()})
    return out


def vgg19_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``Vgg19Features`` variables ({"params": {"conv<j>"}}) -> the port's
    ``Vgg19Features`` state dict (torchvision's ``features.<i>`` names)."""
    p = variables["params"]
    sd = {}
    for j, i in enumerate(VGG19_CONV_IDX):
        sd[f"features.{i}.weight"] = conv_weight(_array(p[f"conv{j}"]["kernel"]))
        sd[f"features.{i}.bias"] = _array(p[f"conv{j}"]["bias"])
    return _tensors(sd.items())


# ---------------------------------------------------------------------- Unet3D
class _Builder:
    def __init__(self, params: Mapping[str, Any]):
        self.p = params
        self.sd: Dict[str, np.ndarray] = {}

    def get(self, path: str) -> np.ndarray:
        node = self.p
        for part in path.split("/"):
            node = node[part]
        return _array(node)

    def has(self, path: str) -> bool:
        try:
            self.get(path)
            return True
        except KeyError:
            return False

    def conv(self, src: str, dst: str, bias: bool = True):
        self.sd[f"{dst}.weight"] = conv_weight(self.get(f"{src}/kernel"))
        if bias and self.has(f"{src}/bias"):
            self.sd[f"{dst}.bias"] = self.get(f"{src}/bias")

    def linear(self, src: str, dst: str):
        self.sd[f"{dst}.weight"] = self.get(f"{src}/kernel").T
        if self.has(f"{src}/bias"):
            self.sd[f"{dst}.bias"] = self.get(f"{src}/bias")

    def gamma(self, src: str, dst: str):
        self.sd[dst] = self.get(src).reshape(1, -1, 1, 1, 1)

    def resnet(self, src: str, dst: str):
        if self.has(f"{src}/mlp"):
            self.linear(f"{src}/mlp", f"{dst}.mlp.1")
        for blk in ("block1", "block2"):
            self.conv(f"{src}/{blk}/proj/Conv_0", f"{dst}.{blk}.proj")
            self.sd[f"{dst}.{blk}.norm.weight"] = self.get(f"{src}/{blk}/norm/scale")
            self.sd[f"{dst}.{blk}.norm.bias"] = self.get(f"{src}/{blk}/norm/bias")
        if self.has(f"{src}/res_conv"):
            self.conv(f"{src}/res_conv", f"{dst}.res_conv")

    def stw(self, src: str, dst: str):
        self.gamma(f"{src}/norm/gamma", f"{dst}.fn.norm.gamma")
        a = f"{dst}.fn.fn.attn"
        self.sd[f"{a}.relative_position_bias_table"] = self.get(
            f"{src}/fn/attn/relative_position_bias_table")
        self.linear(f"{src}/fn/attn/qkv", f"{a}.qkv")
        self.linear(f"{src}/fn/attn/proj/Dense_0", f"{a}.proj")

    def temporal(self, src: str, dst: str):
        self.gamma(f"{src}/norm/gamma", f"{dst}.fn.norm.gamma")
        inner = f"{dst}.fn.fn.fn"
        self.sd[f"{inner}.norm.weight"] = self.get(f"{src}/fn/norm/scale")
        self.sd[f"{inner}.norm.bias"] = self.get(f"{src}/fn/norm/bias")
        self.linear(f"{src}/fn/attn/to_qkv", f"{inner}.attn.to_qkv")
        self.linear(f"{src}/fn/attn/to_out", f"{inner}.attn.to_out")

    def adaptor(self, src: str, dst: str):
        self.gamma(f"{src}/adaptors/predictor_norm/gamma", f"{dst}.adaptors.predictor.fn.norm.gamma")
        self.conv(f"{src}/adaptors/predictor/Conv_0", f"{dst}.adaptors.predictor.fn.fn")
        i = 0
        while self.has(f"{src}/adaptors/extrapolator{i}/kernel"):
            self.conv(f"{src}/adaptors/extrapolator{i}", f"{dst}.adaptors.extrapolators.{i}.fn",
                      bias=False)
            i += 1
        self.conv(f"{src}/Tmodulator", f"{dst}.Tmodulator")
        self.gamma(f"{src}/fuser_norm/gamma", f"{dst}.fuser.norm.gamma")
        self.conv(f"{src}/fuser/Conv_0", f"{dst}.fuser.fn")


    def trajwarp(self, src: str, dst: str):
        for lin in ("linear_q", "linear_k", "linear_v", "linear_o"):
            self.linear(f"{src}{lin}", f"{dst}{lin}")
        self.conv(f"{src}fuser/Conv_0", f"{dst}fuser")


def trajwarp_state_dict(params: Mapping[str, Any]) -> StateDict:
    """JAX ``TrajWarp`` params -> ``TrajWarp`` state dict."""
    b = _Builder(params)
    b.trajwarp("", "")
    return _tensors(b.sd.items())


def unet_state_dict(params: Mapping[str, Any]) -> StateDict:
    """JAX ``Unet3D`` params (the "params" collection) -> ``Unet3D`` state dict."""
    b = _Builder(params)
    if b.has("init_noise_conv"):
        b.conv("init_noise_conv/Conv_0", "init_noise_conv")
        b.trajwarp("init_traj/", "init_traj.")
    if b.has("null_cond_emb"):
        b.sd["null_cond_emb"] = b.get("null_cond_emb")
    w = conv_weight(b.get("init_conv/Conv_0/kernel"))
    if b.has("init_conv_cond/kernel"):
        w = np.concatenate([w, conv_weight(b.get("init_conv_cond/kernel"))], axis=1)
    b.sd["init_conv.weight"] = w
    b.sd["init_conv.bias"] = b.get("init_conv/Conv_0/bias")
    if b.has("time_rel_pos_bias"):
        b.sd["time_rel_pos_bias.relative_attention_bias.weight"] = b.get(
            "time_rel_pos_bias/relative_attention_bias")
    if b.has("rel_pos_bias_thw"):
        b.sd["rel_pos_bias_thw.relative_attention_bias.weight"] = b.get(
            "rel_pos_bias_thw/relative_attention_bias")
        b.sd["alpha"], b.sd["beta"] = b.get("alpha"), b.get("beta")
    b.temporal("init_temporal_attn", "init_temporal_attn")
    if b.has("cond_temporal_attn"):
        b.temporal("cond_temporal_attn", "cond_temporal_attn")
        b.adaptor("cond_adaptor", "cond_adaptor")
    b.linear("time_mlp_0", "time_mlp.1")
    b.linear("time_mlp_1", "time_mlp.3")

    n_levels = 1 + max(int(m.group(1)) for k in params
                       for m in [re.match(r"down(\d+)_block1$", k)] if m)
    for side, lists in (("down", "downs"), ("up", "ups")):
        for i in range(n_levels):
            src, dst = f"{side}{i}", f"{lists}.{i}"
            b.resnet(f"{src}_block1", f"{dst}.0")
            b.stw(f"{src}_stw1", f"{dst}.1")
            b.resnet(f"{src}_block2", f"{dst}.2")
            b.stw(f"{src}_stw2", f"{dst}.3")
            if b.has(f"{src}_adaptor"):
                b.adaptor(f"{src}_adaptor", f"{dst}.4")
            b.temporal(f"{src}_tattn", f"{dst}.5")
            if b.has(f"{src}_downsample"):
                b.conv(f"{src}_downsample/Conv_0", f"{dst}.6")
            if b.has(f"{src}_upsample"):
                b.sd[f"{dst}.6.weight"] = conv_transpose_weight(b.get(f"{src}_upsample/conv/kernel"))
                b.sd[f"{dst}.6.bias"] = b.get(f"{src}_upsample/conv/bias")
    b.resnet("mid_block1", "mid_block1")
    b.stw("mid_attn1", "mid_attn1")
    b.resnet("mid_block2", "mid_block2")
    b.stw("mid_attn2", "mid_attn2")
    if b.has("mid_adaptor"):
        b.adaptor("mid_adaptor", "mid_adaptor")
    b.resnet("final_block", "final_conv.0")
    b.conv("final_conv", "final_conv.1")
    b.resnet("occlusion_block", "occlusion_map.0")
    b.conv("occlusion_conv", "occlusion_map.1")
    return _tensors(b.sd.items())


# --------------------------------------------------------------------- metrics
def lpips_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``LPIPS`` variables ({"params": {"net": {"conv<j>"}, "lin<j>"}}) ->
    the port's ``LPIPS`` state dict (the lpips package's names)."""
    p = variables["params"]
    sd = {}
    for j, i in enumerate(ALEX_CONV_IDX):
        conv = p["net"][f"conv{j}"]
        sd[f"net.slice{j + 1}.{i}.weight"] = conv_weight(_array(conv["kernel"]))
        sd[f"net.slice{j + 1}.{i}.bias"] = _array(conv["bias"])
        lin = _array(p[f"lin{j}"])  # (C, 1)
        sd[f"lin{j}.model.1.weight"] = lin.T.reshape(1, -1, 1, 1)
    out = _tensors(sd.items())
    out.update({f"scaling_layer.{k}": v for k, v in ScalingLayer().state_dict().items()})
    return out


def i3d_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``InceptionI3d`` variables ({"params", "batch_stats"}) -> the port's
    ``InceptionI3d`` state dict (pytorch_i3d's names: the flax module paths)."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            path, value = _leaf(path, value)
            sd[path.replace("/", ".")] = value
    out = _tensors(sd.items())
    for key in [k for k in out if k.endswith(".running_var")]:
        out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


# ----------------------------------------------------------------- checkpoints
WEIGHT_KINDS = ("lfae", "unet", "vgg19", "lpips", "i3d")


def weights_state_dict(kind: str, tree: Mapping[str, Any]) -> StateDict:
    """A weights-only JAX file's tree (``utils.msgpack.load_jax_checkpoint``)
    -> the port's state dict: "lfae" an ``LFAE``'s variables, "unet" a
    ``Unet3D``'s (its variables or their "params"), "vgg19", "lpips" and
    "i3d" the converted networks ``scripts/convert_checkpoint.py`` writes."""
    if kind == "unet":
        return unet_state_dict(tree.get("params", tree))
    fns = {"lfae": lfae_state_dict, "vgg19": vgg19_state_dict, "lpips": lpips_state_dict,
           "i3d": i3d_state_dict}
    if kind not in fns:
        raise ValueError(f"kind {kind!r} is none of {WEIGHT_KINDS}")
    return fns[kind](tree)


def optax_adam_state(opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX trainers' optax state as flax stores it: adam(w)'s chain
    ({"0": {count, mu, nu}, ..., {count}: the schedule's}), under
    apply_if_finite's {"inner_state", "notfinite_count", ...} with the nan
    guard. -> {"count": Adam's, "mu", "nu", "schedule_count",
    "notfinite_count": None without the guard}."""
    notfinite = None
    if "inner_state" in opt_state:
        notfinite = int(opt_state["notfinite_count"])
        opt_state = opt_state["inner_state"]
    parts = [opt_state[str(i)] for i in range(len(opt_state))]
    adam = [p for p in parts if "mu" in p]
    sched = [p for p in parts if set(p) == {"count"}]
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError(f"not an adam(w) chain of optax: parts {[sorted(p) for p in parts]}")
    return {"count": int(adam[0]["count"]), "mu": adam[0]["mu"], "nu": adam[0]["nu"],
            "schedule_count": int(sched[0]["count"]), "notfinite_count": notfinite}


def fill_optimizer(optimizer, named_params, opt_state: Mapping[str, Any], moments) -> None:
    """Set a ``ScheduledOptimizer`` over Adam(W) to a JAX optax state:
    `moments` maps the mu / nu trees to state dicts keyed like
    `named_params`; Adam's count is each parameter's step, the schedule's
    count the update count, apply_if_finite's count the nan guard's."""
    st = optax_adam_state(opt_state)
    mu, nu = moments(st["mu"]), moments(st["nu"])
    named_params = list(named_params)
    missing = sorted({n for n, _ in named_params} - set(mu))
    if missing:
        raise ValueError(f"the optimizer state has no moments for {missing[:5]}")
    for name, p in named_params:
        optimizer.opt.state[p] = {"step": torch.tensor(float(st["count"])),
                                  "exp_avg": mu[name].to(p), "exp_avg_sq": nu[name].to(p)}
    optimizer.count = st["schedule_count"]
    optimizer.notfinite_count = st["notfinite_count"] or 0


def dm_payload_from_jax(ckpt: Mapping[str, Any], unet: torch.nn.Module, optimizer
                        ) -> Dict[str, Any]:
    """A JAX DM checkpoint ({"example", "step", "state": DMTrainState}, as
    ``scripts/train_dm.py`` writes it; JAX's ``convert_checkpoint.py --kind
    dm`` writes the state's "unet_params" alone) loaded into `unet` and
    `optimizer` (``train.dm_trainer.make_optimizer`` over its parameters)
    -> ``train.checkpoint.dm_payload``, which ``train_dm --checkpoint``
    resumes. A state without "opt_state" gives a payload without
    "optimizer" (weights for sampling and evaluation)."""
    from extdm_tpu_torch.train.checkpoint import dm_payload

    state = ckpt["state"]
    unet.load_state_dict(unet_state_dict(state["unet_params"]))
    if "opt_state" in state:
        fill_optimizer(optimizer, unet.named_parameters(), state["opt_state"], unet_state_dict)
    out = dm_payload(unet, optimizer, int(ckpt.get("step", 0)), int(ckpt.get("example", 0)))
    if "opt_state" not in state:
        del out["optimizer"]
    return out


def ae_payload_from_jax(ckpt: Mapping[str, Any], trainer) -> Dict[str, Any]:
    """A JAX AE checkpoint ({"example", "step", "state": AETrainState}, as
    ``scripts/train_ae.py`` writes it) loaded into an ``AETrainer``'s model,
    loss weights and Adam (the trainer made with learnable loss weights
    where the state has them) -> ``train.checkpoint.ae_payload``."""
    from extdm_tpu_torch.train.checkpoint import ae_payload

    state, model, lw = ckpt["state"], trainer.model, trainer.loss_weights
    if (lw is None) != (state.get("loss_weights") is None):
        raise ValueError("the trainer's learnable loss weights and the checkpoint's disagree")
    model.load_state_dict(recon_state_dict({"params": state["params"],
                                            "batch_stats": state.get("batch_stats", {})}))
    named = list(model.named_parameters())
    if lw is not None:
        with torch.no_grad():
            for k, w in lw.items():
                w.copy_(torch.tensor(_array(state["loss_weights"][k])))
        named += [(f"loss_weights.{k}", w) for k, w in lw.items()]

    def moments(tree):
        params, weights = (tree["0"], tree["1"]) if lw is not None else (tree, {})
        out = recon_state_dict({"params": params})
        out.update({f"loss_weights.{k}": torch.tensor(_array(v), dtype=torch.float32)
                    for k, v in weights.items()})
        return out

    fill_optimizer(trainer.optimizer, named, state["opt_state"], moments)
    return ae_payload(model, trainer.optimizer, int(ckpt.get("step", 0)),
                      int(ckpt.get("example", 0)), loss_weights=lw)
