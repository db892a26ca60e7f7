"""Guards of the PyTorch port: it imports nothing of JAX or the JAX package,
its entry points refuse to fall back to the CPU silently, and its kernel
wrappers take their plain versions only for CPU tensors."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from extdm_tpu_torch.config import kth_sampling_config
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
from extdm_tpu_torch.ops import fused_resnet, fused_stw, fused_warp

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "extdm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "extdm_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_flow_diffusion_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FlowDiffusion(kth_sampling_config())


def test_wrappers_take_plain_path_on_cpu():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    counters = (fused_warp.grid_sample, fused_stw.fused_stw_layer,
                fused_stw.fused_temporal_layer, fused_resnet.fused_resnet_block)
    before = [f.launches for f in counters]

    img, grid = t(1, 8, 8, 3), t(1, 4, 4, 2)
    assert torch.equal(fused_warp.grid_sample(img, grid), fused_warp.grid_sample_plain(img, grid))

    x, heads, dh = t(1, 4, 4, 4, 16), 2, 8
    stw_args = (x, t(16), t(48, 16), t(16, 16), t(16), t(heads, 64, 64))
    kw = dict(window=(4, 4, 4), shift=(2, 0, 0), heads=heads, dim_head=dh)
    assert torch.equal(fused_stw.fused_stw_layer(*stw_args, **kw),
                       fused_stw.stw_layer_plain(*stw_args, **kw))
    tmp_args = (x, t(16), t(16), t(16), t(48, 16), t(16, 16), t(heads, 4, 4))
    assert torch.equal(fused_stw.fused_temporal_layer(*tmp_args, heads=heads, dim_head=dh),
                       fused_stw.temporal_layer_plain(*tmp_args, heads=heads, dim_head=dh))
    res_args = (x, t(8, 16, 1, 3, 3), t(8), t(8), t(8), t(1, 16), t(8, 8, 1, 3, 3), t(8), t(8),
                t(8), t(8, 16, 1, 1, 1), t(8))
    assert torch.equal(fused_resnet.fused_resnet_block(*res_args, groups=4),
                       fused_resnet.resnet_block_plain(*res_args, groups=4))
    assert [f.launches for f in counters] == before  # no kernel ran


def test_backward_wrappers_take_plain_path_on_cpu_and_refuse_other_devices():
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    wrappers = (fused_stw.stw_layer_bwd, fused_stw.temporal_layer_bwd,
                fused_resnet.resnet_block_bwd)
    before = [f.launches for f in wrappers]
    x, heads, dh = t(1, 4, 4, 4, 16), 2, 8
    cases = [
        (fused_stw.stw_layer_bwd, fused_stw.stw_layer_plain_vjp, x,
         (x, t(16), t(48, 16), t(16, 16), t(16), t(heads, 64, 64)),
         dict(window=(4, 4, 4), shift=(2, 0, 0), heads=heads, dim_head=dh)),
        (fused_stw.temporal_layer_bwd, fused_stw.temporal_layer_plain_vjp, x,
         (x, t(16), t(16), t(16), t(48, 16), t(16, 16), t(heads, 4, 4)),
         dict(heads=heads, dim_head=dh)),
        (fused_resnet.resnet_block_bwd, fused_resnet.resnet_block_plain_vjp, t(1, 4, 4, 4, 8),
         (x, t(8, 16, 1, 3, 3), t(8), t(8), t(8), t(1, 16), t(8, 8, 1, 3, 3), t(8), t(8), t(8),
          t(8, 16, 1, 1, 1), t(8)), dict(groups=4)),
    ]
    for wrapper, plain, g, args, kw in cases:
        for got, want in zip(wrapper(g, *args, **kw), plain(g, *args, **kw)):
            assert torch.equal(got, want)
        with pytest.raises(ValueError):  # neither CPU nor CUDA: no kernel, no fallback
            wrapper(g.to("meta"), *[a.to("meta") for a in args], **kw)
    assert [f.launches for f in wrappers] == before  # no kernel ran


def test_kernel_calls_match_their_c_entry_points():
    """Every ``_build.launch(source, name, *args)`` call passes as many
    arguments as the C entry it names declares, and every entry is called."""
    from extdm_tpu_torch import _build

    calls = {}
    for path in sorted((ROOT / "extdm_tpu_torch" / "ops").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"):
                source, name = (a.value for a in node.args[:2])
                calls[(source, name)] = len(node.args) - 2
    entries = {(src.stem, name): len(types) for src in (ROOT / "extdm_tpu_torch" / "csrc").glob("*.cu")
               for name, types in _build.entry_points(src.stem).items()}
    assert calls == entries
