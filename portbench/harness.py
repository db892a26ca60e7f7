"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the cell's configuration (``portbench/configs/<config>.json``),
its traffic mix (``portbench/traffic/<traffic>.json``, a data file whose
``kind`` names the driver ``portbench/traffic/<kind>.py``), its limits
(``portbench/limits/<cell>.json``) and the readers of its per-layer
metrics (``portbench/metrics/<metric>.py``). A driver module has
``prepare(run)`` (set-up, ending with the cell's shapes warmed up; returns
its state), ``spans(state, spans)`` (the program's layers to wrap in a
traced run), ``measure(run, state)`` (the closed loop over the window;
returns ``Window``), ``release(state)`` (frees the program), ``check(run,
state)`` (the numbers read against the reference: name -> value; the
cell's limits name those compared, and a limit whose number is not read
fails) and
``unit_flops(run)`` (model flops of one unit of work).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import trace as tracing
from portbench.cost import kernels as cost

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "extdm_tpu")


@dataclasses.dataclass
class Window:
    """What the closed loop did: `units` calls or steps completed from the
    window's start to the last completion (`elapsed_s`)."""
    units: int
    elapsed_s: float
    rates: Dict[str, float]  # end-to-end rate name -> value
    attempted: int
    failed: int


@dataclasses.dataclass
class Run:
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    limits: Dict[str, float]
    benchmark: dict
    started: float  # perf_counter() at process start

    @property
    def name(self) -> str:
        return self.workload["name"]

    def log(self, *parts) -> None:
        print(f"[portbench {self.name}]", *parts, file=sys.stderr, flush=True)


def process_start() -> float:
    """perf_counter() at the moment this process was started."""
    try:
        with open("/proc/self/stat") as f:
            started_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - started_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def cache_dirs() -> None:
    """Build and kernel caches of anything the program builds, at fixed paths
    inside the checkout (the program's own kernels build into its package)."""
    base = PKG / "_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell_metrics(benchmark: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace 1)."""
    e2e = [m for m in benchmark["end_to_end"] if reports(m, cell)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if m["moves"] in names and (cell in m["workloads"] if "workloads" in m else True)]


def make_run(name: str, seed: int, seconds: float, trace: bool, device,
             benchmark: Optional[dict] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> Run:
    """The run of cell `name`; `benchmark`, `config` and `traffic` replace the files'."""
    benchmark = benchmark or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    workload = cells[name]
    configs = {c["name"]: c for c in benchmark["configs"]}
    if workload["config"] not in configs:
        raise KeyError(f"workload {name!r} names config {workload['config']!r}, not in configs")
    config = config or load_json(ROOT / configs[workload["config"]]["file"])
    traffic = traffic or load_json(PKG / "traffic" / f"{workload['traffic']}.json")
    limits_path = PKG / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.is_file() else {}
    return Run(workload=workload, config=config, traffic=traffic, seed=seed, seconds=seconds,
               trace=trace, device=torch.device(device), limits=limits, benchmark=benchmark,
               started=process_start())


def driver(run: Run):
    kind = run.traffic["kind"]
    return load_module(PKG / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}")


def execute(run: Run, drv=None) -> dict:
    """Set up, measure, check: the result object of the run."""
    drv = drv or driver(run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = run.device.type == "cuda"
    state = drv.prepare(run)
    run.log(f"set-up done at {time.perf_counter() - run.started:.2f} s")
    spans = tracing.Spans(marked=cuda)
    prof = None
    if run.trace:
        drv.spans(state, spans)
        add_op_spans(spans, training=run.traffic["kind"] == "train")
        spans.reset()
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - run.started
    with torch.profiler.record_function(f"{tracing.SPAN}window"):
        win = drv.measure(run, state)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    spans.restore()
    drv.release(state)
    gc.collect()  # the program's modules hold reference cycles
    if cuda:
        torch.cuda.empty_cache()
    run.log(f"window: {win.units} units in {win.elapsed_s:.3f} s; peak {peak} bytes")
    t_check = time.perf_counter()
    numbers = drv.check(run, state)
    run.log(f"check took {time.perf_counter() - t_check:.2f} s; read {numbers}")
    checks = {k: {"value": numbers.get(k), "limit": limit} for k, limit in run.limits.items()}
    correct = bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                                   for c in checks.values())  # a number not read fails its limit
    metrics: Dict[str, dict] = {}
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": device_info(run.device, peak)}
    wanted = cell_metrics(run.benchmark, run.name, run.trace)
    if not run.trace:
        values = dict(win.rates, setup_s=setup_s)
        for m in wanted:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        t_trace = time.perf_counter()
        summary = tracing.summarize(prof, spans.marks)
        run.log(f"trace read in {time.perf_counter() - t_trace:.2f} s; "
                f"{len(spans.marks)} span marks, {summary['marks_found']} found")
        summary.update(window_s=win.elapsed_s, units=win.units,
                       unit_flops=drv.unit_flops(run), bounds=dict(spans.bounds))
        for m in wanted:
            value = load_module(PKG / "metrics" / f"{m['name']}.py",
                                f"portbench_metric_{m['name'].replace('.', '_')}").read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=summary["busy_s"], window_s=win.elapsed_s)
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    return result


# The program's kernel entry points, as its modules call them.
FORWARD_OPS = (("extdm_tpu_torch.models.dm.unet3d", "fused_stw_layer", "stw_layer"),
               ("extdm_tpu_torch.models.dm.unet3d", "fused_temporal_layer", "temporal_layer"),
               ("extdm_tpu_torch.models.dm.unet3d", "fused_resnet_block", "resnet_block"),
               ("extdm_tpu_torch.models.lfae.generator", "grid_sample", "grid_sample"),
               ("extdm_tpu_torch.models.lfae.pixelwise_flow", "grid_sample", "grid_sample"))
BACKWARD_OPS = (("extdm_tpu_torch.ops.fused_stw", "stw_layer_bwd", "stw_layer_bwd"),
                ("extdm_tpu_torch.ops.fused_stw", "temporal_layer_bwd", "temporal_layer_bwd"),
                ("extdm_tpu_torch.ops.fused_resnet", "resnet_block_bwd", "resnet_block_bwd"),
                ("extdm_tpu_torch.ops.fused_resnet", "resnet_block_bwd_decomposed",
                 "resnet_block_bwd"))


def add_op_spans(spans: tracing.Spans, training: bool) -> None:
    table = FORWARD_OPS + (BACKWARD_OPS if training else ())
    for module, attr, kind in table:
        fn = cost.FORWARD.get(kind) or cost.BACKWARD[kind]
        spans.op(importlib.import_module(module), attr, kind, fn)


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}
    limit = power_limit()
    if limit is not None:
        info["power_limit_w"] = limit
    return info


def power_limit() -> Optional[float]:
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", card],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run must not import."""
    return sorted({n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN})


def emit(run: Run, result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, and the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
