"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. All sources are compiled at
first use, one ``nvcc`` process each, started together. The libraries go to
``extdm_tpu_torch/_build/<hash>/``, keyed by a hash of every source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Processes that build at once (the ranks of a data-parallel launch) take an
exclusive lock on ``_build/<hash>.lock`` (``flock``: the system drops it
with a process that dies) and build once: the first compiles, the others
wait for it and find the libraries built.

Each C entry point (``extern "C" int name(...)``) takes a dtype code,
device pointers, sizes and the stream, and returns ``cudaGetLastError()``.
:func:`launch` reads the entry's parameter types from its declaration in
the source, declares them to ctypes, calls it and raises on a non-zero code.
A size query (``extern "C" long long name(...)``) returns the bytes a layout
of the source takes, or -1 for a shape it refuses; :func:`query` calls it,
so that a layout is written once, in the source that uses it.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

from extdm_tpu_torch.utils.profiler import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRY = re.compile(r'extern "C" (int|long long) (\w+)\(([^)]*)\)')
_CTYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _key() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def build_lock(path: Path):
    """An exclusive ``flock`` on `path` (created if missing) for the block."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _unbuilt(out_dir: Path) -> List[Path]:
    return [s for s in sorted(CSRC.glob("*.cu")) if not (out_dir / f"lib{s.stem}.so").exists()]


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that is not built yet, under the build
    lock; return the build dir."""
    out_dir = BUILD_ROOT / _key()
    if not _unbuilt(out_dir):
        return out_dir
    with build_lock(BUILD_ROOT / f"{out_dir.name}.lock"):
        todo = _unbuilt(out_dir)  # empty where another process built them meanwhile
        if todo:
            _compile(todo, out_dir)
    return out_dir


def _compile(todo: List[Path], out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *FLAGS, "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def _declarations(source: str) -> Dict[str, tuple]:
    """name -> (ctypes result type, parameter types) of each ``extern "C"``
    function in ``csrc/<source>.cu``."""
    text = (CSRC / f"{source}.cu").read_text()
    decls = {}
    for result, name, params in _ENTRY.findall(text):
        types = [ctypes.c_void_p if "*" in param else _CTYPES[param.strip().rsplit(None, 1)[0]]
                 for param in params.split(",")]
        decls[name] = (_CTYPES[result], types)
    return decls


def entry_points(source: str) -> Dict[str, List[type]]:
    """ctypes parameter types of each ``extern "C" int`` entry (a launch) in
    ``csrc/<source>.cu``."""
    return {name: types for name, (result, types) in _declarations(source).items()
            if result is ctypes.c_int}


def size_queries(source: str) -> Dict[str, List[type]]:
    """ctypes parameter types of each ``extern "C" long long`` size query in
    ``csrc/<source>.cu``."""
    return {name: types for name, (result, types) in _declarations(source).items()
            if result is ctypes.c_longlong}


_FNS: Dict[tuple, ctypes._CFuncPtr] = {}


def _function(source: str, name: str):
    fn = _FNS.get((source, name))
    if fn is None:
        fn = getattr(library(source), name)
        fn.restype, fn.argtypes = _declarations(source)[name]
        _FNS[(source, name)] = fn
    return fn


def launch(source: str, name: str, *args) -> None:
    """Call entry point `name` of ``csrc/<source>.cu``, in the span
    ``launch.<name>``; raise on a CUDA error."""
    with span("launch." + name):
        code = _function(source, name)(*args)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def query(source: str, name: str, *args) -> int:
    """The value of size query `name` of ``csrc/<source>.cu``; raise where
    it refuses the shape (-1)."""
    value = _function(source, name)(*args)
    if value < 0:
        raise ValueError(f"{name}{args}: refused by csrc/{source}.cu")
    return value


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {dtype}")
    return code


def ptr(t) -> Optional[int]:
    """Device address of a tensor, or None (a null pointer)."""
    return t.data_ptr() if t is not None else None


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(t) -> int:
    """PyTorch's current stream on the tensor's device (its raw handle, read
    without making a Stream object where this build of torch allows)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream
