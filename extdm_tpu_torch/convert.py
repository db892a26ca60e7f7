"""JAX variables -> this package's state dicts.

Input: the JAX package's variables as a nested dict of numpy arrays (what
``flax.core.unfreeze`` + ``np.asarray`` give). Output: PyTorch state dicts
for ``LFAE``, ``ReconstructionModel``, ``Unet3D`` and the metrics' LPIPS and
I3D, whose keys are the reference PyTorch model's (torchvision's for the
VGG19, the lpips package's and pytorch_i3d's for the metrics), so this is the
inverse of the JAX package's torch -> flax mapping
(``extdm_tpu/convert/torch2jax.py``). The split init conv of the JAX UNet
(latent part + cond-feature part) is joined back into one conv.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from extdm_tpu_torch.metrics.lpips import ALEX_CONV_IDX, ScalingLayer
from extdm_tpu_torch.models.lfae.vgg import VGG19_CONV_IDX

StateDict = Dict[str, torch.Tensor]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


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
    sd = {}
    for j, i in enumerate(VGG19_CONV_IDX if vgg else []):
        sd[f"vgg.features.{i}.weight"] = conv_weight(np.asarray(vgg[f"conv{j}"]["kernel"]))
        sd[f"vgg.features.{i}.bias"] = vgg[f"conv{j}"]["bias"]
    out.update(_tensors(sd.items()))
    return out


# ---------------------------------------------------------------------- Unet3D
class _Builder:
    def __init__(self, params: Mapping[str, Any]):
        self.p = params
        self.sd: Dict[str, np.ndarray] = {}

    def get(self, path: str) -> np.ndarray:
        node = self.p
        for part in path.split("/"):
            node = node[part]
        return np.asarray(node)

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


def unet_state_dict(params: Mapping[str, Any]) -> StateDict:
    """JAX ``Unet3D`` params (the "params" collection) -> ``Unet3D`` state dict."""
    b = _Builder(params)
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
        sd[f"net.slice{j + 1}.{i}.weight"] = conv_weight(np.asarray(conv["kernel"]))
        sd[f"net.slice{j + 1}.{i}.bias"] = conv["bias"]
        lin = np.asarray(p[f"lin{j}"])  # (C, 1)
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
