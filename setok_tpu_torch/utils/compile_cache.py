"""The kernels' persistent build cache for the CLIs: `--compile-cache`.

The counterpart of `setok_tpu/utils/compile_cache.py`. There the persistent
artefacts are XLA executables; in the port they are the nvcc libraries of
`kernels/_build.py`: each `csrc/<name>.cu` is built once into
`lib<name>-<hash>.so`, keyed by the hash of its sources and nvcc's flags, so
a later process of the same sources loads the library from the directory
without running nvcc, and an edited source builds anew.
`enable_compilation_cache` chooses that directory (`_build.set_build_dir`).
It serves the libraries loaded after the call; one already loaded stays
loaded, as the JAX flags affect only later compiles.

The JAX function's `min_compile_time_secs` and `min_entry_size_bytes` are
left out: they choose which XLA executables are worth writing, while a
process loads an nvcc library from the file it was built into, so every
library is written.

Wired into `scripts/{serve,train_setok,train_setokim,eval_recon,demo}.py`
by `add_cli_flag` (default `auto`), as in the JAX CLIs.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional

from setok_tpu_torch.kernels import _build

DEFAULT_DIR = str(_build.DEFAULT_BUILD_DIR)


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """Build the kernels into and load them from a directory; returns it.

    cache_dir: a path (created if missing); None or "auto":
      $SETOK_COMPILE_CACHE, else the checkout's `build/torch_kernels`;
      "off" or "": a directory of this process's own, removed at exit, so
      that nothing is reused (the JAX function returns None there).
    """
    if cache_dir in ("off", ""):
        path = tempfile.mkdtemp(prefix="setok_kernels_")
        atexit.register(shutil.rmtree, path, True)
    else:
        if cache_dir in (None, "auto"):
            cache_dir = os.environ.get("SETOK_COMPILE_CACHE") or DEFAULT_DIR
        path = os.path.expanduser(cache_dir)
    return str(_build.set_build_dir(path))


def add_cli_flag(parser) -> None:
    """Attach the shared --compile-cache flag to an argparse parser."""
    parser.add_argument(
        "--compile-cache", default="auto", metavar="DIR|auto|off",
        help="directory of the built CUDA kernels (default: auto = "
             "$SETOK_COMPILE_CACHE or build/torch_kernels; 'off' builds "
             "into a directory of this process's own)")
