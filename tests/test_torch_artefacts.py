"""The port's evaluation pictures, FVD functions, metrics demo and text
conditioning against the JAX package's, on the CPU at tiny sizes.

- ``utils.visualize`` / ``utils.flow_viz``: video_strip, comparison_grid,
  bordered_video, grid_to_flow and flow2fig return JAX's arrays exactly;
  visualize_comparison_gif, lfae_visualize and visualize_ori_pre_flow_diff
  compose JAX's frames exactly (each package's writer replaced by a
  recorder: the frames, not the file bytes, since the port writes its own
  3-3-2 palette GIF) under the same file names.
- ``calculate_fvd1`` / ``get_feats`` against JAX's with the same I3D weights
  (He-scaled random, carried by ``convert.i3d_state_dict``): features within
  1e-4 of max(1, max|feature|), FVD within 1e-3 of its size (the bounds of
  tests/test_torch_metrics.py and tests/test_torch_eval.py); the I3D and
  LPIPS weights as JAX msgpack (``--i3d_params`` / ``--lpips_params``) load
  the networks their ``.pth`` load, exactly.
- ``metrics.demo`` on zeros against ones: PSNR and SSIM (means, stds, per
  frame) equal scripts/metrics_demo.py's within 1e-10, the same JSON keys in
  the same order (JAX's FVD and LPIPS replaced by stubs there: the demo's
  document is under test, tests/test_torch_metrics.py holds the networks).
- ``models.dm.text``: tokens equal and embeddings within 1e-6 of JAX's
  text.py, both given one tiny BertModel and vocab in tmp_path; without
  model_dir the port raises ValueError before loading anything.
"""
import contextlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extdm_tpu import metrics as jm
from extdm_tpu.metrics.i3d import InceptionI3d as JInceptionI3d
from extdm_tpu.train import checkpoint as jckpt
from extdm_tpu.utils import flow_viz as jflow
from extdm_tpu.utils import visualize as jvis
from extdm_tpu_torch import convert, metrics
from extdm_tpu_torch.eval import valid_dm
from extdm_tpu_torch.metrics import demo
from extdm_tpu_torch.train import checkpoint
from extdm_tpu_torch.utils import flow_viz, visualize
from torch_port_helpers import he_scaled, random_variables

REPO = Path(__file__).resolve().parents[1]


def _videos(seed, n=2, t=5, size=16):
    return np.random.default_rng(seed).uniform(size=(n, t, size, size, 3)).astype(np.float32)


def _grids(seed, n=2, t=5, size=8):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, size=(n, t, size, size, 2)).astype(
        np.float32)


@pytest.fixture
def recorded(monkeypatch):
    """Both packages' save_gif / save_image replaced by recorders:
    {"jax": [...], "port": [...]} of (basename, frames) in call order."""
    calls = {"jax": [], "port": []}
    for key, mod in (("jax", jvis), ("port", visualize)):
        monkeypatch.setattr(mod, "save_gif", lambda path, frames, fps=10, key=key: calls[
            key].append((os.path.basename(path), [np.array(f) for f in frames], fps)))
        monkeypatch.setattr(mod, "save_image", lambda path, img, key=key: calls[key].append(
            (os.path.basename(path), [np.array(img)], None)))
    return calls


def _same_calls(calls):
    assert len(calls["port"]) == len(calls["jax"]) > 0
    for (pn, pf, pfps), (jn, jf, jfps) in zip(calls["port"], calls["jax"]):
        assert (pn, pfps, len(pf)) == (jn, jfps, len(jf))
        for a, b in zip(pf, jf):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_frames", [3, 10])
def test_strips_grids_and_borders_equal_jax(max_frames):
    v1, v2 = _videos(0, n=1, t=7)[0], _videos(1, n=1, t=7, size=16)[0]
    np.testing.assert_array_equal(visualize.video_strip(v1, max_frames),
                                  jvis.video_strip(v1, max_frames))
    np.testing.assert_array_equal(visualize.comparison_grid([v1, v2, v1[:4]], max_frames),
                                  jvis.comparison_grid([v1, v2, v1[:4]], max_frames))
    for a, b in zip(visualize.bordered_video(v1, 3), jvis.bordered_video(v1, 3)):
        np.testing.assert_array_equal(a, b)


def test_flow_pictures_equal_jax():
    g = _grids(2, n=1, t=1, size=9)[0, 0]
    np.testing.assert_array_equal(flow_viz.grid_to_flow(g), jflow.grid_to_flow(g))
    np.testing.assert_array_equal(flow_viz.flow2fig(g), jflow.flow2fig(g))
    ident = np.stack(np.meshgrid(np.linspace(-1, 1, 6), np.linspace(-1, 1, 5)), -1)
    np.testing.assert_array_equal(flow_viz.flow2fig(ident), jflow.flow2fig(ident))


def test_comparison_gif_and_lfae_grid_frames_equal_jax(recorded, tmp_path):
    real, sample = _videos(3, n=1, t=6)[0], _videos(4, n=1, t=6)[0]
    for mod in (jvis, visualize):
        mod.visualize_comparison_gif(str(tmp_path / "sample0.gif"), real, sample, 2)
        mod.lfae_visualize(str(tmp_path / "ae"), real, sample)
        mod.lfae_visualize(str(tmp_path / "ae_w"), real, sample, warped=real[::-1], max_frames=4)
    _same_calls(recorded)
    assert [c[0] for c in recorded["port"]] == ["sample0.gif", "ae_grid.png", "ae_w_grid.png"]


def test_ori_pre_flow_diff_frames_and_names_equal_jax(recorded, tmp_path):
    origin, result = _videos(5, n=3, t=6), _videos(6, n=3, t=6)
    result[1] = origin[1]  # a perfect video: PSNR at the 1e-12 floor
    of, rf = _videos(7, n=3, t=6), _videos(8, n=3, t=6)
    paths = {}
    for key, mod in (("jax", jvis), ("port", visualize)):
        paths[key] = mod.visualize_ori_pre_flow_diff(str(tmp_path / key), origin, result, of, rf,
                                                     epoch_or_step_num=7, cond_frame_num=2)
    _same_calls(recorded)
    rel = {k: [os.path.relpath(p, tmp_path / k) for p in v] for k, v in paths.items()}
    assert rel["port"] == rel["jax"] and rel["port"][1] == os.path.join(
        "7", "gif_grid", "001_psnr120.000.gif")
    assert (tmp_path / "port" / "7" / "gif_grid").is_dir()


@pytest.fixture(scope="module")
def i3d_vars():
    shapes = jax.eval_shape(JInceptionI3d().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 224, 224, 3)))
    return he_scaled(random_variables(dict(shapes), 13))


def test_calculate_fvd1_and_get_feats_match_jax(i3d_vars):
    v1 = _videos(9, n=3, t=8, size=32)
    v2 = np.clip(v1 + 0.3 * np.random.default_rng(10).normal(size=v1.shape), 0, 1).astype(
        np.float32)
    jex = jm.I3DExtractor(params=i3d_vars)
    port = metrics.I3DExtractor(convert.i3d_state_dict(i3d_vars), device="cpu")
    want_feats = jm.get_feats(v1, jex, bs=3)
    got_feats = metrics.get_feats(v1, port, bs=3)
    np.testing.assert_allclose(got_feats, want_feats, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want_feats).max()))
    want = jm.calculate_fvd1(v1, v2, jex, bs=3)
    got = metrics.calculate_fvd1(v1, v2, port, bs=3)
    assert want > 0 and abs(got - want) <= 1e-3 * max(1.0, abs(want))


class _StubI3D:
    pretrained = False

    def __init__(self, *a, **k):
        pass


class _StubLPIPS(_StubI3D):
    def calculate_lpips1(self, v1, v2):
        z = np.zeros(np.shape(v1)[1])
        return {"lpips": 0.0, "lpips_per_frame": z}, {"lpips": 0.0, "lpips_per_frame": z}


def test_metrics_demo_matches_jax_document(capsys, monkeypatch):
    args = ["--num_videos", "2", "--video_length", "8", "--size", "32", "--batch", "2"]
    assert demo.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    got = json.loads(out.out)
    assert "WARNING: random-init" in out.err
    spec = importlib.util.spec_from_file_location("_metrics_demo_cli",
                                                  REPO / "scripts" / "metrics_demo.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(jm, "I3DExtractor", _StubI3D)
    monkeypatch.setattr(jm, "LPIPSMetric", _StubLPIPS)
    monkeypatch.setattr(jm, "calculate_fvd1", lambda *a, **k: 0.0)
    monkeypatch.setattr(sys, "argv", ["metrics_demo.py"] + args)
    cli.main()
    want = json.loads(capsys.readouterr().out)
    assert list(got) == list(want)
    for k in ("psnr", "psnr_std", "ssim", "ssim_std", "psnr_per_frame", "ssim_per_frame"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10)
    assert len(got["lpips_per_frame"]) == 8 and np.isfinite(got["fvd"])
    assert got["fvd_backbone_pretrained"] is got["lpips_backbone_pretrained"] is False


# ------------------------------------------------------------------- text
@contextlib.contextmanager
def _stubs_hidden():
    """transformers probes optional packages with importlib.util.find_spec,
    which raises on a module without a spec: the stand-ins that
    tests/reference_stubs.py puts in sys.modules (every worker collects the
    reference parity tests) are taken out while it runs. Its TensorFlow and
    flax back ends stay unloaded (USE_TF / USE_FLAX), which saves seconds."""
    top = {k for k, m in sys.modules.items()
           if "." not in k and k != "__main__" and getattr(m, "__spec__", False) is None}
    stubs = {k: m for k, m in sys.modules.items() if k.split(".")[0] in top}
    for k in stubs:
        del sys.modules[k]
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("USE_TF", "0")
            mp.setenv("USE_FLAX", "0")
            yield
    finally:
        sys.modules.update(stubs)


@pytest.fixture
def no_stubs():
    with _stubs_hidden():
        yield


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A tiny BertModel (2 layers, 32 wide, seeded) and its vocab, saved as
    from_pretrained reads a directory."""
    with _stubs_hidden():
        from transformers import BertConfig, BertModel, BertTokenizer

    d = tmp_path_factory.mktemp("bert")
    words = ["the", "a", "person", "walks", "runs", "boxing", "hand", "waving", "clapping",
             "jogging", "left", "right", "slowly", "##s", "##ing", ".", ","]
    (d / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
                                 + "\n")
    with _stubs_hidden():
        BertTokenizer(str(d / "vocab.txt"), do_lower_case=False).save_pretrained(str(d))
        torch.manual_seed(0)
        BertModel(BertConfig(vocab_size=22, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=2, intermediate_size=64,
                             max_position_embeddings=256)).save_pretrained(str(d))
    return str(d)


def test_text_matches_jax(bert_dir, no_stubs):
    from extdm_tpu.models.dm import text as jtext
    from extdm_tpu_torch.models.dm import text

    texts = ["a person walks left", "the person runs slowly .", "hand waving , clapping"]
    tokens, jtokens = text.tokenize(texts, bert_dir), jtext.tokenize(texts, bert_dir)
    for k in ("input_ids", "attention_mask"):
        assert tokens[k].shape == (3, text.MAX_LENGTH)
        assert torch.equal(tokens[k], jtokens[k])
    for cls in (False, True):
        got = text.bert_embed(tokens, return_cls_repr=cls, model_dir=bert_dir)
        want = jtext.bert_embed(jtokens, return_cls_repr=cls, model_dir=bert_dir)
        assert isinstance(got, torch.Tensor) and got.device == tokens["input_ids"].device
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_text_without_model_dir_raises_and_loads_nothing(monkeypatch, no_stubs):
    import transformers

    from extdm_tpu_torch.models.dm import text

    def never(*a, **k):
        raise AssertionError("from_pretrained called")

    monkeypatch.setattr(transformers.BertModel, "from_pretrained", never)
    monkeypatch.setattr(transformers.BertTokenizer, "from_pretrained", never)
    for call in (lambda: text.tokenize(["a"]),
                 lambda: text.bert_embed({"input_ids": torch.zeros(1, 4, dtype=torch.long),
                                          "attention_mask": torch.ones(1, 4)})):
        with pytest.raises(ValueError, match="bert-base-cased"):
            call()


def test_backbones_from_jax_msgpack_or_pth(i3d_vars, tmp_path):
    """--i3d_params / --lpips_params (the JAX package's converted weights,
    flax msgpack) load the networks --i3d_state_dict / --lpips_state_dict
    load from the same weights as .pth; giving both for one raises."""
    lpips_vars = jax.tree_util.tree_map(np.asarray, jm.LPIPSMetric(seed=0).params)
    paths = {}
    for name, tree, to_sd in (("i3d", i3d_vars, convert.i3d_state_dict),
                              ("lpips", lpips_vars, convert.lpips_state_dict)):
        paths[name] = (str(tmp_path / f"{name}.msgpack"), str(tmp_path / f"{name}.pth"))
        jckpt.save_checkpoint(paths[name][0], tree)
        checkpoint.save_checkpoint(paths[name][1], to_sd(tree))
    from_msgpack = valid_dm.load_backbones("cpu", i3d_params=paths["i3d"][0],
                                           lpips_params=paths["lpips"][0])
    from_pth = valid_dm.load_backbones("cpu", i3d_state_dict=paths["i3d"][1],
                                       lpips_state_dict=paths["lpips"][1])
    for a, b in zip(from_msgpack, from_pth):
        assert a.pretrained and b.pretrained
        sa, sb = a.model.state_dict(), b.model.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert valid_dm.load_backbones("cpu") == (None, None)
    with pytest.raises(ValueError, match="both given"):
        valid_dm.load_backbones("cpu", i3d_params=paths["i3d"][0],
                                i3d_state_dict=paths["i3d"][1])
