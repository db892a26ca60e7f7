"""Guards of the PyTorch port: it imports nothing of JAX or the JAX package
(nor flax's msgpack: the JAX checkpoint reader is the port's own), its entry
points refuse to fall back to the CPU silently, and its kernel wrappers
take their plain versions only for CPU tensors."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from extdm_tpu_torch.config import kth_sampling_config
from extdm_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
from extdm_tpu_torch.models.lfae.recon_model import ReconstructionModel
from extdm_tpu_torch.ops import fused_resnet, fused_stw, fused_warp
from extdm_tpu_torch.train.ae_trainer import AETrainer, make_optimizer
from torch_port_helpers import tiny_flow_params

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "extdm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "extdm_tpu")


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


def test_ae_trainer_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fp = tiny_flow_params()
    model = ReconstructionModel(region_predictor_cfg=fp["region_predictor_params"],
                                bg_predictor_cfg=fp["bg_predictor_params"],
                                generator_cfg=fp["generator_params"], num_regions=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        AETrainer(model, make_optimizer(2e-4, (10,), 0.5))
    assert AETrainer(model, make_optimizer(2e-4, (10,), 0.5), device="cpu").device.type == "cpu"


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
                fused_resnet.resnet_block_bwd, fused_warp.grid_sample_bwd)
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
        (fused_warp.grid_sample_bwd, fused_warp.grid_sample_plain_vjp, t(1, 4, 4, 3),
         (t(1, 8, 8, 3), t(1, 4, 4, 2)), dict(padding_mode="border")),
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


def test_window_major_wrapper_takes_plain_path_on_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    counters = (fused_stw.fused_stw_layer_wm, fused_stw.fused_stw_layer)
    before = [f.launches for f in counters]
    heads, dh = 2, 8
    args = (t(2, 3, 64, 16), t(16), t(48, 16), t(16, 16), t(16), t(heads, 64, 64), t(3, 64, 64))
    kw = dict(heads=heads, dim_head=dh)
    assert torch.equal(fused_stw.fused_stw_layer_wm(*args, **kw),
                       fused_stw.stw_layer_wm_plain(*args, **kw))
    x = t(1, 4, 8, 8, 16)
    layer = (x, t(16), t(48, 16), t(16, 16), t(16), t(heads, 64, 64))
    for mode in fused_stw.WINDOW_MAJOR_MODES:
        fused_stw.fused_stw_layer(*layer, window=(4, 4, 4), shift=(0, 0, 0), window_major=mode,
                                  **kw)
    assert [f.launches for f in counters] == before  # no kernel ran
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no kernel, no fallback
        fused_stw.fused_stw_layer_wm(*[a.to("meta") for a in args], **kw)


def test_metrics_need_a_card_unless_asked_for_cpu():
    from extdm_tpu_torch.metrics import I3DExtractor, LPIPSMetric

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (LPIPSMetric, I3DExtractor):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert LPIPSMetric(device="cpu").device.type == "cpu"


def test_window_major_kernel_call_matches_its_c_entry():
    """The launch of kernel 9 passes the 20 arguments of ``stw_layer_wm``."""
    from extdm_tpu_torch import _build

    src = (ROOT / "extdm_tpu_torch" / "ops" / "fused_stw.py").read_text()
    calls = [node for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
             and node.func.attr == "launch" and node.args[1].value == "stw_layer_wm"]
    assert len(calls) == 1
    assert len(calls[0].args) - 2 == len(_build.entry_points("attention")["stw_layer_wm"]) == 20


def _tiny_dumps(d):
    rng = np.random.default_rng(3)
    for name in ("origin", "result"):
        np.save(d / f"{name}.npy", rng.uniform(size=(2, 4, 16, 16, 3)).astype(np.float32))


def _tiny_v2v_yaml(d):
    import yaml

    cfg = yaml.safe_load(open(ROOT / "configs" / "DM" / "kth.yaml"))
    cfg["dataset_params"].update(frame_shape=32)
    cfg["dataset_params"]["valid_params"]["cond_frames"] = 2
    cfg["flow_params"]["model_params"] = tiny_flow_params()
    (d / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    return str(d / "tiny.yaml")


NEW_MAINS = {
    "analyze_dumps": ("extdm_tpu_torch.eval.analyze_dumps",
                      lambda d: (_tiny_dumps(d), ["--dump_dir", str(d), "--cond_frames", "2",
                                                  "--metrics", "psnr,ssim"])[1]),
    "video2video": ("extdm_tpu_torch.eval.video2video",
                    lambda d: ["--config", _tiny_v2v_yaml(d), "--synthetic_videos", "2",
                               "--motion_indices", "1", "--num_frames", "3", "--log_dir",
                               str(d / "v2v")]),
    "metrics_demo": ("extdm_tpu_torch.metrics.demo",
                     lambda d: ["--num_videos", "2", "--video_length", "8", "--size", "32"]),
}


@pytest.mark.parametrize("name", sorted(NEW_MAINS))
def test_new_mains_default_to_cuda_and_run_on_cpu(name, tmp_path, capsys):
    """Each tool's --device defaults to cuda (no card here: it raises, no
    silent CPU run) and --device cpu runs it to its end."""
    import importlib

    module, argv = NEW_MAINS[name]
    main = importlib.import_module(module).main
    args = argv(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)
    assert main(args + ["--device", "cpu"]) == 0


def test_convert_checkpoint_takes_no_device():
    """The checkpoint converter only rearranges arrays on the host: no
    --device to default."""
    from extdm_tpu_torch import convert_checkpoint

    with pytest.raises(SystemExit):
        convert_checkpoint.main(["--src", "a", "--out", "b", "--kind", "unet", "--device", "cpu"])


@pytest.mark.parametrize("entry,module", [
    ("analyze_dumps_main", "extdm_tpu_torch.eval.analyze_dumps"),
    ("video2video_main", "extdm_tpu_torch.eval.video2video"),
    ("metrics_demo_main", "extdm_tpu_torch.metrics.demo"),
    ("convert_checkpoint_main", "extdm_tpu_torch.convert_checkpoint")])
def test_new_cli_entry_points_reach_port_mains(monkeypatch, entry, module):
    import importlib

    from extdm_tpu_torch import cli

    monkeypatch.setattr(importlib.import_module(module), "main", lambda argv=None: 7)
    with pytest.raises(SystemExit) as exit_:
        getattr(cli, entry)()
    assert exit_.value.code == 7
    name = "extdm-torch-" + entry[:-len("_main")].replace("_", "-")
    assert f'{name} = "extdm_tpu_torch.cli:{entry}"' in (ROOT / "pyproject.toml").read_text()
