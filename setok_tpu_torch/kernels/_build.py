"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `setok_tpu_torch/csrc/<name>.cu` becomes its own shared library with a
plain C interface, `lib<name>-<hash>.so` in `BUILD_DIR`
(`build/torch_kernels` in the checkout unless `set_build_dir` or the CLIs'
`--compile-cache`, utils/compile_cache.py, chose another), built at first
use. The hash covers the sources and the flags, so an edited source is
rebuilt and a library already in the directory is loaded as it is. A
library loaded once stays loaded: a new directory serves the libraries
loaded after it is set. `build_all()` starts one nvcc per source, all at once,
and keeps each nvcc's output (ptxas's registers, spills and stack per
kernel, from `-Xptxas -v`) beside its library; `build_log()` reads it.
Nothing here falls back: a missing nvcc, a failed build or a failed load
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
                     / "torch_kernels")
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc on PATH first, then the toolkit's default install location
NVCC_CANDIDATES = ("nvcc", "/usr/local/cuda/bin/nvcc")

_loaded: Dict[str, ctypes.CDLL] = {}


def set_build_dir(path) -> Path:
    """Build into and load from `path` from now on (created if missing)."""
    global BUILD_DIR
    BUILD_DIR = Path(os.path.abspath(os.path.expanduser(path)))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def _nvcc() -> str:
    for candidate in NVCC_CANDIDATES:
        found = shutil.which(candidate)
        if found is not None:
            return found
    raise RuntimeError("nvcc not found: the CUDA kernels of setok_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def _library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    if not source.exists():
        raise FileNotFoundError(source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Build every source not yet built, one nvcc each, in parallel."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    targets = {name: _library_path(name) for name in names}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """nvcc's output for csrc/<name>.cu, building it if needed."""
    path = _library_path(name)
    if not path.exists():
        build_all()
    return path.with_suffix(".log").read_text()


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Per kernel (its mangled name) in a `-Xptxas -v` log: registers, spill
    stores and loads (bytes), stack frame (bytes)."""
    usage: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
