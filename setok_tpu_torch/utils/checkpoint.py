"""Checkpoint I/O: step checkpoints, lazy restores, adapter subtrees.

The counterpart of `setok_tpu/utils/checkpoint.py`, with the JAX names, over
a state that is a dict of named parts, each a (nested) dict of tensors and
plain values, such as a trainer's `state_dict()`:
{'params': {name: tensor}, 'train': {...}}. The format is the port's own
(the port cannot read orbax):

  * one directory per step, `<dir>/<step>/`, each part in its own
    `torch.save` file `<part>.pt`, so that a trainer's parameters and its
    optimizer moments, step and generator states lie apart, and
    `restore_lazy` reads only the files of the parts it is asked for (a
    server never reads the Adam moments); `index.json` lists every leaf's
    path in each file;
  * a step is written into a hidden temporary directory and renamed into
    place, so a half-written step is never `latest_step`; the oldest steps
    beyond `max_to_keep` (3) are deleted after each write.

A leaf's path is flax's `keystr` form, "['params']['tokenizer']['out']
['weight']": the part, then the dotted name of a flat dict split at its
dots, then the keys of any deeper dict. `filter_subtree`, `restore_lazy`
and the predicates read these paths; a leaf that fails the predicate is
left out (the JAX package puts None or orbax's placeholder there).

`CheckpointRunner` saves in the background. A PyTorch optimizer step
mutates parameters in place (a JAX array is immutable, so orbax may write
after `save` returns), so `save` first copies every tensor to the host
and returns when that copy is done; only the file write runs on the
background thread. A step saved twice (a preemption save racing the
periodic one) logs a warning and keeps the first. A SIGTERM sets
`preempted`; the hook is installed only from the main thread.

`save_subtree` / `load_subtree` write and read `.npz` files keyed by the
flax `keystr` paths of the JAX package ("['params']['mm_in_proj']
['kernel']", Dense kernels (in, out)), through `utils/from_flax`'s key
map, so that an adapter file written by either package loads in the other.
bf16 leaves are written as float32 (exact); a load casts to the model's
types, as the JAX package's does.

Not ported: `abstract_like`, `restore_sharded`, `restore_partial` and
`checkpoint_metadata` are orbax and sharding forms that wait for the
parallel item (ROADMAP.md, Queue A item 7).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import signal
import threading
import time
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from setok_tpu_torch.utils.from_flax import flax_entries, from_flax_leaf, \
    to_numpy

logger = logging.getLogger(__name__)

INDEX = "index.json"
_TMP = ".tmp-"


def keystr(*keys: str) -> str:
    """flax's path string of a sequence of keys: "['a']['b']"."""
    return "".join(f"['{k}']" for k in keys)


def _walk(tree, keys=()):
    """(path keys, leaf) of a nested dict; a str key holding dots is split
    into its components, as the flax module names are."""
    for key, value in tree.items():
        path = keys + tuple(str(key).split("."))
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, value


def leaf_paths(state: Mapping) -> Dict[str, list]:
    """{part: [keystr of each leaf]} of a state of named parts."""
    out = {}
    for part, value in state.items():
        if isinstance(value, Mapping):
            out[part] = [keystr(part, *p) for p, _ in _walk(value)]
        else:
            out[part] = [keystr(part)]
    return out


def to_host(tree):
    """A copy of the tree with every tensor copied to host memory (dicts,
    lists and tuples walked; other values kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step under `ckpt_dir` (a temporary directory
    left by an interrupted write is not one), or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _write(ckpt_dir: str, step: int, state: Mapping,
           max_to_keep: int) -> None:
    """Write a host-side state as step `step`: into a temporary directory,
    then renamed; then the steps beyond `max_to_keep` go."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"{_TMP}{step}-{os.getpid()}-"
                                 f"{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for part, value in state.items():
        torch.save(value, os.path.join(tmp, f"{part}.pt"))
    with open(os.path.join(tmp, INDEX), "w") as f:
        json.dump({"step": step, "parts": leaf_paths(state)}, f)
    os.rename(tmp, os.path.join(ckpt_dir, str(step)))
    for old in _steps(ckpt_dir)[:-max_to_keep] if max_to_keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def _check_parts(state: Mapping) -> None:
    for part in state:
        if not re.fullmatch(r"[A-Za-z0-9_\-]+", str(part)):
            raise ValueError(f"part name {part!r}: letters, digits, _ and "
                             "- only (it names a file)")


def save_checkpoint(ckpt_dir: str, step: int, state: Mapping,
                    max_to_keep: int = 3) -> None:
    """Write `state` as step `step` under `ckpt_dir`, synchronously. A step
    that exists already is kept, with a warning."""
    _check_parts(state)
    if os.path.isdir(os.path.join(ckpt_dir, str(step))):
        logger.warning("checkpoint step %d exists under %s; kept", step,
                       ckpt_dir)
        return
    _write(ckpt_dir, step, to_host(state), max_to_keep)


def _step_dir(ckpt_dir: str, step: Optional[int]) -> str:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return os.path.join(ckpt_dir, str(step))


def _load(path: str, map_location):
    return torch.load(path, map_location=map_location, weights_only=True)


def _cast_like(value, target):
    """`value` in the types and on the devices of `target`'s tensors, where
    target has a tensor at the same position; the structure must match."""
    if isinstance(target, torch.Tensor):
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"restored shape {tuple(value.shape)} vs "
                             f"{tuple(target.shape)}")
        return value.to(device=target.device, dtype=target.dtype)
    if isinstance(target, Mapping):
        if set(value) != set(target):
            raise KeyError(f"restored keys differ: "
                           f"{sorted(set(value) ^ set(target))[:8]}")
        return {k: _cast_like(value[k], target[k]) for k in target}
    return value


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       target: Any = None, map_location="cpu") -> Dict:
    """Every part of a step (the latest when `step` is None). `target`
    (a state of the same structure) gives each tensor its type and
    device; without it tensors land on `map_location`."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, INDEX)) as f:
        parts = json.load(f)["parts"]
    state = {part: _load(os.path.join(d, f"{part}.pt"), map_location)
             for part in parts}
    return state if target is None else _cast_like(state, target)


def _filter(tree, predicate, keys):
    if isinstance(tree, Mapping):
        out = {}
        for key, value in tree.items():
            sub = _filter(value, predicate,
                          keys + tuple(str(key).split(".")))
            if sub is not None:
                out[key] = sub
        return out or None
    return tree if predicate(keystr(*keys)) else None


def filter_subtree(tree: Mapping, predicate: Callable[[str], bool],
                   root: tuple = ()) -> Dict:
    """The leaves of a (nested) dict whose path matches, the others left
    out; `root` prefixes every path (a part's name)."""
    return _filter(tree, predicate, tuple(root)) or {}


def restore_lazy(ckpt_dir: str, predicate: Callable[[str], bool],
                 step: Optional[int] = None, map_location="cpu") -> Dict:
    """Only the leaves whose path matches: the step's index says which
    part files hold one, and no other file is read. Returns {part:
    filtered subtree}."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, INDEX)) as f:
        parts = json.load(f)["parts"]
    out = {}
    for part, paths in parts.items():
        if not any(predicate(p) for p in paths):
            continue
        value = _load(os.path.join(d, f"{part}.pt"), map_location)
        out[part] = (filter_subtree(value, predicate, (part,))
                     if isinstance(value, Mapping) else value)
    return out


def prefix_predicate(*prefixes: str) -> Callable[[str], bool]:
    """Match any path containing one of the given component names."""
    pats = [re.compile(re.escape(p)) for p in prefixes]
    return lambda name: any(p.search(name) for p in pats)


def root_predicate(*roots: str) -> Callable[[str], bool]:
    """Match paths whose first component is one of `roots` (an optimizer's
    moments that mirror the parameter names deeper down cannot match)."""
    keys = {f"['{r}']" for r in roots}
    return lambda name: any(name.startswith(k) for k in keys)


def splice_params(target: Dict[str, torch.Tensor],
                  source: Mapping[str, torch.Tensor],
                  predicate: Callable[[str], bool],
                  root: str = "params") -> Dict[str, torch.Tensor]:
    """A copy of the flat dict `target` with source's leaves in place of
    those whose path (under `root`) matches and that source holds, cast to
    target's type and device; shapes must agree."""
    out = dict(target)
    for name, leaf in target.items():
        if predicate(keystr(root, *name.split("."))) and name in source:
            src = source[name]
            if tuple(src.shape) != tuple(leaf.shape):
                raise ValueError(f"splice shape mismatch at {name}: "
                                 f"{tuple(src.shape)} vs {tuple(leaf.shape)}")
            out[name] = src.to(device=leaf.device, dtype=leaf.dtype)
    return out


def save_subtree(path: str, model: nn.Module,
                 predicate: Callable[[str], bool],
                 root: str = "params") -> None:
    """Adapter-only save: the model's state entries whose flax path (under
    `root`) matches, as an .npz of {keystr: array in the flax layout}."""
    arrays = {}
    for fpath, (_, value) in flax_entries(model).items():
        name = keystr(root, *fpath)
        if predicate(name):
            arrays[name] = to_numpy(value)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


@torch.no_grad()
def load_subtree(path: str, model: nn.Module,
                 root: str = "params") -> nn.Module:
    """Splice an .npz adapter file into the model, in place: every entry
    whose flax path the file holds, cast to the entry's type; the file's
    other arrays are ignored, as the JAX package's load ignores them."""
    data = np.load(path)
    files = set(data.files)
    state = model.state_dict()
    new = {}
    for fpath, (key, _) in flax_entries(model).items():
        name = keystr(root, *fpath)
        if name in files:
            try:
                new[key] = from_flax_leaf(fpath[-1], data[name], state[key])
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
    model.load_state_dict(new, strict=False)
    return model


class CheckpointRunner:
    """A training run's checkpoints: background writes, preemption-safe.

        runner = CheckpointRunner(ckpt_dir)
        for step in ...:
            trainer.train_step(...)
            runner.save_every(step, trainer.state_dict(...), every=500)
            if runner.preempted(step):
                runner.save(step + 1, trainer.state_dict(...), force=True)
                break
        runner.close()

    `last_save` holds the step, the seconds `save` blocked (the copy to the
    host), the write's seconds and the bytes of the latest save once its
    write is done."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3,
                 install_sigterm_hook: bool = True):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None
        self.last_save: Dict[str, float] = {}
        self._prev_handler = None
        self._hooked = False
        if install_sigterm_hook and (threading.current_thread()
                                     is threading.main_thread()):
            self._prev_handler = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, self._on_sigterm)
            self._hooked = True

    def _on_sigterm(self, signum, frame):
        self._stop.set()
        if callable(self._prev_handler):
            self._prev_handler(signum, frame)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Mapping, force: bool = False) -> None:
        """Copy `state` to the host, then write it as step `step` on a
        background thread. A step already saved (or in flight) is kept,
        with a warning. `force` is accepted for the JAX signature: every
        save here is one the caller asked for."""
        del force
        _check_parts(state)
        t0 = time.perf_counter()
        self.wait()
        if step == self._pending or os.path.isdir(
                os.path.join(self.ckpt_dir, str(step))):
            logger.warning("checkpoint step %d exists under %s; kept", step,
                           self.ckpt_dir)
            return
        host = to_host(state)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        blocking = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(host))
        self._pending = step

        def write():
            t = time.perf_counter()
            try:
                _write(self.ckpt_dir, step, host, self.max_to_keep)
            except BaseException as e:        # raised again by wait()
                self._error = e
            self.last_save = {"step": step, "blocking_s": blocking,
                              "write_s": time.perf_counter() - t,
                              "bytes": nbytes}

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def save_every(self, step: int, state: Mapping, every: int) -> bool:
        if every > 0 and (step + 1) % every == 0:
            self.save(step + 1, state)
            return True
        return False

    def preempted(self, step: int) -> bool:
        """True once the process has received SIGTERM: save and exit."""
        del step
        return self._stop.is_set()

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.ckpt_dir)

    def restore(self, target: Any = None, step: Optional[int] = None,
                map_location="cpu") -> Dict:
        self.wait()
        return restore_checkpoint(self.ckpt_dir, step, target,
                                  map_location)

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
        if self._hooked:
            signal.signal(signal.SIGTERM,
                          self._prev_handler if self._prev_handler
                          is not None else signal.SIG_DFL)
            self._hooked = False


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
