"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. All sources are compiled at
first use, one ``nvcc`` process each, started together. The libraries go to
``extdm_tpu_torch/_build/<hash>/``, keyed by a hash of every source and the
flags, so an edited source rebuilds and an unchanged one loads at once.

Each C entry point (``extern "C" int name(...)``) takes a dtype code,
device pointers, sizes and the stream, and returns ``cudaGetLastError()``.
:func:`launch` reads the entry's parameter types from its declaration in
the source, declares them to ctypes, calls it and raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


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


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that is not built yet; return the build dir."""
    out_dir = BUILD_ROOT / _key()
    todo = [s for s in sorted(CSRC.glob("*.cu")) if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
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
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def entry_points(source: str) -> Dict[str, List[type]]:
    """ctypes parameter types of each ``extern "C"`` entry in ``csrc/<source>.cu``."""
    text = (CSRC / f"{source}.cu").read_text()
    entries = {}
    for name, params in _ENTRY.findall(text):
        types = []
        for param in params.split(","):
            ptype = param.strip().rsplit(None, 1)[0]
            types.append(ctypes.c_void_p if "*" in param
                         else {"int": ctypes.c_int, "float": ctypes.c_float}[ptype])
        entries[name] = types
    return entries


def launch(source: str, name: str, *args) -> None:
    """Call entry point `name` of ``csrc/<source>.cu``; raise on a CUDA error."""
    fn = getattr(library(source), name)
    if fn.argtypes is None:
        fn.argtypes = entry_points(source)[name]
        fn.restype = ctypes.c_int
    code = fn(*args)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {dtype}")
    return code


def ptr(t) -> Optional[int]:
    """Device address of a tensor, or None (a null pointer)."""
    return t.data_ptr() if t is not None else None


def stream(t) -> int:
    """PyTorch's current stream on the tensor's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
