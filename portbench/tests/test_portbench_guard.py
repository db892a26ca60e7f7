"""What the benchmark may import, that every name in BENCHMARK.json finds
its files, that unknown names fail, and that a run without a card prints
no result."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import tiny

PKG = harness.PKG
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".", 1)[0]


def sources(where: Path):
    return sorted(where.rglob("*.py"))


def test_nothing_imports_jax_or_the_jax_package():
    bad = [(str(p.relative_to(ROOT)), n) for p in sources(PKG) for n in imported_top_names(p)
           if n in harness.FORBIDDEN]
    assert not bad
    # whole top-level names: the port's name begins with the JAX package's
    assert "extdm_tpu_torch".split(".", 1)[0] not in harness.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    bad = [(str(p.relative_to(ROOT)), n) for p in sources(PKG / "reference")
           for n in imported_top_names(p) if n == "extdm_tpu_torch"]
    assert not bad


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "extdm_tpu_torch_fake", object())
    assert "extdm_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert "flax.core" in harness.forbidden_modules()


@pytest.fixture(scope="module")
def benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files(benchmark):
    configs = {c["name"]: c for c in benchmark["configs"]}
    for c in benchmark["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in benchmark["workloads"]:
        assert w["config"] in configs, w["name"]
        traffic = PKG / "traffic" / f"{w['traffic']}.json"
        assert traffic.is_file(), w["name"]
        kind = json.loads(traffic.read_text())["kind"]
        assert (PKG / "traffic" / f"{kind}.py").is_file(), w["name"]
        assert (PKG / "limits" / f"{w['name']}.json").is_file(), w["name"]
        for m in harness.cell_metrics(benchmark, w["name"], True):
            assert (PKG / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(benchmark):
    for w in benchmark["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(benchmark, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.cell_metrics(benchmark, w["name"], True), w["name"]


def test_limits_are_positive(benchmark):
    for w in benchmark["workloads"]:
        limits = json.loads((PKG / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v >= 0 for v in limits.values()), w["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in tiny.benchmark()["workloads"]])
def test_limits_name_the_drivers_numbers(cell):
    """Every limit of a cell names a number that its driver's check reads,
    at the tiny size; a limit whose number is not read fails the run."""
    run = harness.make_run(cell, 2 ** 31 + 3, 0.5, False, "cpu", config=tiny.config(cell),
                           traffic=tiny.traffic(cell))
    result = harness.execute(run)
    assert set(result["checks"]) == set(run.limits) and run.limits, cell
    assert all(c["value"] is not None for c in result["checks"].values()), result["checks"]
    assert result["correct"], result["checks"]
    run.limits = dict(run.limits, no_such_number=1.0)
    result = harness.execute(run)
    assert result["checks"]["no_such_number"]["value"] is None and not result["correct"]


def test_benchmark_json_keeps_the_contract_shapes(benchmark):
    assert set(benchmark) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert benchmark["paths"] == ["portbench"] and benchmark["command"][1] == "portbench/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in benchmark[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in benchmark["end_to_end"] + benchmark["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in benchmark["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in benchmark["end_to_end"]}
    for m in benchmark["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert all(w["chips"] == 1 and len(w["why"]) <= 200 for w in benchmark["workloads"])
    assert all(len(c["source"]) <= 200 for c in benchmark["configs"])


def test_unknown_names_fail(benchmark, tmp_path):
    with pytest.raises(KeyError):
        harness.make_run("no-such-cell", 1, 1.0, False, "cpu")
    bad = json.loads(json.dumps(benchmark))
    bad["workloads"][0]["config"] = "no_such_config"
    with pytest.raises(KeyError):
        harness.make_run(bad["workloads"][0]["name"], 1, 1.0, False, "cpu", benchmark=bad)
    bad = json.loads(json.dumps(benchmark))
    bad["workloads"][0]["traffic"] = "no_such_traffic"
    with pytest.raises(FileNotFoundError):
        harness.make_run(bad["workloads"][0]["name"], 1, 1.0, False, "cpu", benchmark=bad)
    run = harness.make_run(benchmark["workloads"][0]["name"], 1, 1.0, False, "cpu")
    run.traffic = dict(run.traffic, kind="no_such_kind")
    with pytest.raises(FileNotFoundError):
        harness.driver(run)
    with pytest.raises(FileNotFoundError):
        harness.load_module(PKG / "metrics" / "no_such_metric.py", "x")


def test_a_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    name = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                           str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
