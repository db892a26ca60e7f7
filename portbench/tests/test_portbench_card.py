"""On the card: a checkout that holds only BENCHMARK.json and the
benchmark's own files runs no cell (the program is not there) and prints
no result."""
import shutil
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.card
def test_bare_checkout_prints_no_result(card, tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kth-sample-traj100",
                           "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
