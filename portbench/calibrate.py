"""Readings that a cell's limits are set from, on the card:

    python3 portbench/calibrate.py --workload <name> --seeds 12 --control 3 --base <seed>

For seeds base, base + 1, ...: the numbers that a run of the cell compares,
read from the program as a run drives it (a short window: the calls or
steps that a run checks, a training cell's window as far as its checked step), and, on the first `--control` seeds, from the
control: the plain reference computed with its products in fp8
(``reference/lowp.py``), put in the program's place. A training cell also
reads the faults of half of each batch left out (the mean taken over the
rest, planted in the reference) and of a step that returns its state
unchanged (no run: the program's readings with no change). One JSON line
a seed, also appended to ``chiprun_out/calibrate_<name>.jsonl``. The program is built once and
given each seed's weights, as set-up is the longest part of a run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import harness, program, weights  # noqa: E402
from portbench.reference.lowp import Fp8Products  # noqa: E402


def sample_seed(drv, run, shared: dict, control: bool) -> dict:
    if "fd" not in shared:
        shared["fd"] = program.build(run)
        shared["sampler"] = shared["fd"].make_sampler()
    else:
        program.load_weights(shared["fd"], run.config, run.seed, run.device)
    calls = drv.Calls(run)
    state = dict(fd=shared["fd"], sampler=shared["sampler"], calls=calls, records={},
                 rows=calls.check_rows())
    cond = None
    for k in range(run.traffic["check_calls"]):
        cond = drv.call(state, k, cond)
    torch.cuda.synchronize()
    ref = weights.reference(run.config["model"], run.seed, run.device)
    line = {"program": drv.check(run, state, ref)}
    if control:
        readings = []
        for k in drv.chosen_calls(run, state["records"]):
            rec = state["records"][k]
            want = drv.reference_rows(ref, calls, k, state["rows"], rec["cond"])
            with Fp8Products():
                got = drv.reference_rows(ref, calls, k, state["rows"], rec["cond"])
            readings.append(drv.compare(got, want, ref, rec["cond"]))
        line["control_fp8"] = drv.worst(readings)
    return line


def worst_leaves(got: dict, want: dict, key: str, n: int = 4) -> list:
    """The parameters with the widest gaps of one per-parameter norm:
    [name, program's norm, reference's norm, median reference norm]."""
    order = [want["names"].index(name) for name in got["names"]]
    w = want[key][order]
    gap = (got[key] - w).abs() / torch.clamp(w, min=w.median().item())
    top = torch.argsort(gap, descending=True)[:n].tolist()
    return [[got["names"][i], got[key][i].item(), w[i].item(), w.median().item()] for i in top]


def train_seed(drv, run, shared: dict, control: bool) -> dict:
    state = drv.prepare(run)
    drv.measure(run, state)  # a window of no length: as far as the checked step
    drv.release(state)
    torch.cuda.empty_cache()

    def in_place(**kw):  # the reference put in the program's place, changed by `kw`
        return {**drv.compare(drv.reference_steps(run, state["pool"], **kw), want),
                **drv.compare_window(drv.reference_window(run, state, **kw), want_window)}
    want = drv.reference_steps(run, state["pool"])
    want_window = drv.reference_window(run, state)
    got, got_window = state["readings"], drv.window_readings(state)
    line = {"program": {**drv.compare(got, want), **drv.compare_window(got_window, want_window)},
            "checked_step": state["window"]["step"],
            "losses": [got["loss"].tolist(), want["loss"].tolist()],
            "window_losses": [got_window["loss"].tolist(), want_window["loss"].tolist()],
            "grad_leaves": worst_leaves(got, want, "grad"),
            "update_leaves": worst_leaves(got, want, "change"),
            "window_update_leaves": worst_leaves(got_window, want_window, "change")}
    if control:
        line["control_fp8"] = in_place(product_mode=Fp8Products())
        line["fault_state_unchanged"] = {  # reads without a run
            **drv.compare(dict(got, change=torch.zeros_like(got["change"])), want),
            **drv.compare_window(dict(got_window, change=torch.zeros_like(got_window["change"])),
                                 want_window)}
        line["fault_half_batch"] = in_place(rows=slice(0, run.traffic["batch"] // 2))
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--base", type=int, required=True)
    args = p.parse_args(argv)
    harness.cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = harness.ROOT / "chiprun_out" / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    shared: dict = {}
    for i in range(args.seeds):
        run = harness.make_run(args.workload, args.base + i, 0.0, False, "cuda")
        drv = harness.driver(run)
        t0 = time.perf_counter()
        read = train_seed if run.traffic["kind"] == "train" else sample_seed
        line = {"workload": args.workload, "seed": run.seed,
                **read(drv, run, shared, i < args.control),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
