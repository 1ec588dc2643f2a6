"""Extract the vision tower and generator weights of a stage-1 run for
stage 2.

    python -m setok_tpu_torch.scripts.extract_components STAGE1_DIR OUT_DIR \\
        [train_setok's configuration flags: --tiny --image-size N ...]

The counterpart of the JAX package's `scripts/extract_components.py` (the
reference's `scripts/extract_mm_projector.py` and the `get_w` key surgery of
setokim_arch.py:94-99): the newest checkpoint of the port's stage-1 trainer
under STAGE1_DIR (its `--output-dir`, or that directory's `checkpoints`)
holds SeTok's parameters under torch names, `setok.tokenizer.…` and
`setok.detokenizer.…`. They become `OUT_DIR/vision_tower.npz` and
`OUT_DIR/vision_generator.npz`, flat {'vision_tower/a/b/c': array} files in
the flax layout, the JAX script's keys and arrays, which
`train_setokim --pretrain-vision-tokenizer / --pretrain-vision-detokenizer`
of either package loads.

The flax layout of an entry depends on its module (a Dense weight is
transposed, the patch embed becomes an HWIO kernel, a norm's weight is a
`scale`), so the parameters are placed into a SeTok built on the meta
device (no memory, no draw) of the run's configuration (a name or a shape
it does not have raises) and read back through
`utils/from_flax.flax_entries`. The configuration is
`train_setok`'s, from the same flags the run was given (a mismatch
raises); no flag: its defaults, train_setok.sh's configuration. Only the
'params' part of the step is read. A half the checkpoint does not hold
is left out with the JAX script's warning.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Sequence

import numpy as np

from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.scripts import train_setok
from setok_tpu_torch.utils import checkpoint as ckpt
from setok_tpu_torch.utils.from_flax import flax_entries, to_numpy

# stage-1 param prefix → Setokim param prefix
RENAMES = {
    "tokenizer": "vision_tower",
    "detokenizer": "vision_generator",
}


def setok_params(stage1_dir: str) -> Dict:
    """The SeTok state of the newest stage-1 step under `stage1_dir`."""
    ckpt_dir = (stage1_dir if ckpt.latest_step(stage1_dir) is not None
                else os.path.join(stage1_dir, "checkpoints"))
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        raise SystemExit(f"no checkpoint under {stage1_dir}")
    params = ckpt.restore_lazy(
        ckpt_dir, lambda p: p.startswith("['params']['setok']"),
        step).get("params", {})
    return {k[len("setok."):]: v for k, v in params.items()}


def extract(stage1_dir: str, out_dir: str,
            config_flags: Sequence[str] = ()) -> Dict[str, int]:
    """Write the two component files; returns {root: arrays written}."""
    tok, det = train_setok.configs(train_setok.parse_args(
        ["--synthetic", "1", *config_flags]))
    model = SeTok(tok, det, device="meta")
    params = setok_params(stage1_dir)
    unexpected = model.load_state_dict(params, strict=False,
                                       assign=True).unexpected_keys
    if unexpected:
        raise KeyError(f"the checkpoint's SeTok differs from the "
                       f"configuration: {unexpected[:8]}")

    buckets = {v: {} for v in RENAMES.values()}
    every = flax_entries(model)
    for half, root in RENAMES.items():
        entries = {path: e for path, e in every.items() if path[0] == half}
        held = [path for path, (key, _) in entries.items() if key in params]
        if held and len(held) < len(entries):
            raise KeyError(f"the checkpoint holds {len(held)} of the "
                           f"{len(entries)} {half} entries")
        for path in held:
            buckets[root]["/".join((root,) + path[1:])] = to_numpy(
                entries[path][1])

    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for root, arrays in buckets.items():
        if not arrays:
            print(f"warning: no {root} weights found")
            continue
        path = os.path.join(out_dir, f"{root}.npz")
        np.savez(path, **arrays)
        written[root] = len(arrays)
        print(f"wrote {len(arrays)} arrays → {path}")
    return written


def main(argv=None) -> Dict[str, int]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("stage1_dir")
    p.add_argument("out_dir")
    args, config_flags = p.parse_known_args(argv)
    return extract(args.stage1_dir, args.out_dir, config_flags)


if __name__ == "__main__":
    main()
