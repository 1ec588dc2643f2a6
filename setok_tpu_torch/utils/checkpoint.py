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

The sharded forms (`abstract_like`, `restore_sharded`, `restore_partial`,
`checkpoint_metadata`) build on the same format, where the JAX package
hands orbax an abstract target with shardings. A sharded trainer writes
full tensors (its `full_state_dict()` gathers each slice; one rank
writes), so a step carries no layout and restores onto any other: each
part file is opened memory-mapped (`torch.load(mmap=True)`), and a leaf
with a sharding (`parallel/sharding.Piece`, where this rank's slice lies
in the full tensor) is copied out of the map slice by slice, so a rank
reads its own bytes and never holds the full tensor. The format stays
this module's, rather than `torch.distributed.checkpoint`'s, so that
every reader of a step (`restore_lazy`, the CLIs, one process) reads a
step written by a mesh and the other way round.
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
from typing import Any, Callable, Dict, NamedTuple, Optional

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


def map_leaves(tree, fn, keys=()):
    """A copy of a nested dict with each leaf replaced by fn(keystr path,
    leaf); the keys are kept (a dotted key's path holds its components)."""
    if isinstance(tree, Mapping):
        return {k: map_leaves(v, fn, keys + tuple(str(k).split(".")))
                for k, v in tree.items()}
    return fn(keystr(*keys), tree)


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


def _load_mapped(path: str):
    """A part file opened memory-mapped: tensors read on access."""
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


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


class Abstract(NamedTuple):
    """A leaf's shape and type without its bytes (jax.ShapeDtypeStruct's
    counterpart), with this rank's `sharding` (a `Piece`) where given."""
    shape: tuple
    dtype: Any
    sharding: Any = None


def _sharding_of(shardings, path):
    if shardings is None:
        return None
    if callable(shardings):
        return shardings(path)
    return shardings.get(path)


def abstract_like(tree: Any, shardings: Any = None) -> Any:
    """An `Abstract` tree mirroring `tree` (concrete or abstract), with the
    sharding of each leaf's path from `shardings` ({keystr path: Piece} or
    a function of the path) attached where it has one."""
    def leaf(path, x):
        sh = _sharding_of(shardings, path)
        if isinstance(x, Abstract):
            return x._replace(sharding=sh) if sh is not None else x
        if isinstance(x, torch.Tensor):
            return Abstract(tuple(x.shape), x.dtype, sh)
        return x

    return map_leaves(tree, leaf)


def _restore_leaf(path, value, shardings, target):
    """A restored leaf: this rank's slice (a copy out of the map) where the
    path has a sharding, else the whole tensor; in the type and on the
    device of `target`'s leaf where there is one."""
    if not isinstance(value, torch.Tensor):
        return value
    sh = _sharding_of(shardings, path)
    if sh is None and isinstance(target, Abstract):
        sh = target.sharding
    out = sh.take(value) if sh is not None else value.clone()
    if isinstance(target, torch.Tensor):
        if tuple(out.shape) != tuple(target.shape):
            raise ValueError(f"{path}: restored shape {tuple(out.shape)} "
                             f"vs {tuple(target.shape)}")
        out = out.to(device=target.device, dtype=target.dtype)
    elif isinstance(target, Abstract):
        out = out.to(dtype=target.dtype)
    return out


def _target_at(target, path_keys):
    node = target
    for k in path_keys:
        if not isinstance(node, Mapping) or k not in node:
            return None
        node = node[k]
    return node


def _restore_tree(value, shardings, target, keys, predicate=None,
                  fallback=None):
    if isinstance(value, Mapping):
        out = {}
        for k, v in value.items():
            sub_t = None if not isinstance(target, Mapping) \
                else target.get(k)
            sub_f = None if not isinstance(fallback, Mapping) \
                else fallback.get(k)
            out[k] = _restore_tree(v, shardings, sub_t,
                                   keys + tuple(str(k).split(".")),
                                   predicate, sub_f)
        return out
    path = keystr(*keys)
    if predicate is not None and not predicate(path):
        return fallback
    return _restore_leaf(path, value, shardings, target)


def restore_sharded(ckpt_dir: str, target: Any = None, shardings: Any = None,
                    step: Optional[int] = None) -> Dict:
    """Every part of a step, each leaf restored as this rank's slice where
    it has a sharding (from `shardings`, {keystr path: Piece} or a
    function of the path, or from `target`'s `Abstract` leaves): a step
    written under one layout restores under another. `target` (concrete
    or abstract) gives the leaves' types (and a concrete one their
    devices)."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, INDEX)) as f:
        parts = json.load(f)["parts"]
    out = {}
    for part in parts:
        value = _load_mapped(os.path.join(d, f"{part}.pt"))
        sub = None if target is None else target.get(part)
        out[part] = _restore_tree(value, shardings, sub, (part,))
    return out


def restore_partial(ckpt_dir: str, target: Any,
                    predicate: Callable[[str], bool],
                    step: Optional[int] = None,
                    shardings: Any = None) -> Dict:
    """Only the leaves whose path matches `predicate` are read (the part
    files that hold none are not opened; the others are memory-mapped and
    only the matching leaves' bytes are copied out), each as this rank's
    slice where it has a sharding; the other leaves are `target`'s own."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, INDEX)) as f:
        parts = json.load(f)["parts"]
    out = dict(target)
    for part, paths in parts.items():
        if not any(predicate(p) for p in paths):
            continue
        value = _load_mapped(os.path.join(d, f"{part}.pt"))
        sub = target.get(part)
        if isinstance(value, Mapping):
            out[part] = _restore_tree(value, shardings, sub, (part,),
                                      predicate, sub)
        else:
            out[part] = _restore_leaf(keystr(part), value, shardings, sub)
    return out


def checkpoint_metadata(ckpt_dir: str, step: Optional[int] = None):
    """(the `Abstract` tree of a step, the step), read without any tensor
    bytes (the part files memory-mapped, their tensors never touched)."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, INDEX)) as f:
        index = json.load(f)
    tree = {part: abstract_like(_load_mapped(os.path.join(d, f"{part}.pt")))
            for part in index["parts"]}
    return tree, index["step"]


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
