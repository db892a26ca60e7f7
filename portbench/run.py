"""Run one cell of the port's benchmark on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Sets up the cell from its seed, measures a
closed loop for `--seconds`, checks what the timed path produced against
the plain float32 reference, and prints the result as the last line of
standard output (with ``--trace 1`` the per-layer metrics from a
``torch.profiler`` trace of the window). Exits non-zero with no result
where there is no card, or fewer cards than the cell asks for, and where a
module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.cache_dirs()
    import torch

    run = harness.make_run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    chips = run.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = harness.execute(run)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    harness.emit(run, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
