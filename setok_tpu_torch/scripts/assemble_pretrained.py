"""Assemble a Setokim's component files from pretrained torch checkpoints.

    python -m setok_tpu_torch.scripts.assemble_pretrained OUT_DIR \\
        [--siglip model.safetensors] [--llama pytorch_model.bin] \\
        [--bert bert.bin] [--tiny] [--cpu]

The counterpart of the JAX package's `scripts/assemble_pretrained.py`. The
reference builds its model from pretrained pieces at run time (the SigLIP
tower, the BERT mapper, the Vicuna/LLaMA trunk; setokim_arch.py:73-183,
builder.py:97-138); offline, assembly is a step of its own: each state dict
is ported (`scripts/port_weights.py`), spliced by path suffix
(`utils/porting.load_flat_into`) under its root into the Setokim of
`models/builder.load_pretrained_model("", tiny=)`, and the six component
subtrees are written as flax-keyed `.npz` files (`utils/checkpoint
.save_subtree`): `vision_tower`, `vision_generator`, `llama`,
`mm_in_projector`, `mm_out_projector`, `diffloss`, which
`train_setokim --pretrain-*` and `load_pretrained_model(projector_path=)`
of either package read.

Any subset may be given; the pieces not given keep the builder's seed-0
draw (not flax's initialisers: those leaves differ from the JAX script's
by design). `assemble` takes a `model_cfg` in place of `--tiny` (a
configuration cut to size) and a device; the CLI runs on the card unless
`--cpu`.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

from setok_tpu_torch.models.builder import load_pretrained_model
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.scripts import port_weights as pw
from setok_tpu_torch.utils.checkpoint import prefix_predicate, save_subtree
from setok_tpu_torch.utils.porting import load_flat_into

COMPONENTS = ("vision_tower", "vision_generator", "llama",
              "mm_in_projector", "mm_out_projector", "diffloss")
SIGLIP_ROOT = "vision_tower/image_feature_encoder"
LLAMA_ROOT = "llama"
BERT_ROOT = "vision_generator/mapper"


def splice(model: Setokim, flat: Dict, root: str) -> Tuple[int, int]:
    """Load a porter's flat arrays under `root` (each key prefixed with it
    unless it starts with it). Returns (arrays, unmatched)."""
    flat = {f"{root}/{k}" if not k.startswith(root) else k: v
            for k, v in flat.items()}
    unmatched = load_flat_into(model, flat)
    return len(flat), len(unmatched)


def siglip_state(path: str) -> Dict:
    """A SigLIP vision state dict, its keys under `vision_model.` (a
    SiglipVisionTransformer's own dict lacks the prefix)."""
    sd = pw.load_state_dict(path)
    if not any(k.startswith("vision_model.") for k in sd):
        sd = {"vision_model." + k: v for k, v in sd.items()}
    return sd


def assemble(siglip: Optional[str] = None, llama: Optional[str] = None,
             bert: Optional[str] = None, tiny: bool = False,
             model_cfg=None, device=None
             ) -> Tuple[Setokim, Dict[str, Tuple[int, int]]]:
    """The Setokim with the given checkpoints spliced in, and {root:
    (arrays, unmatched)} for each."""
    model = load_pretrained_model("", model_cfg, tiny=tiny, device=device)
    report = {}
    if siglip:
        report[SIGLIP_ROOT] = splice(
            model, pw.port_siglip_vision(siglip_state(siglip)), SIGLIP_ROOT)
    if llama:
        report[LLAMA_ROOT] = splice(
            model, pw.port_llama(pw.load_state_dict(llama)), LLAMA_ROOT)
    if bert:
        report[BERT_ROOT] = splice(
            model, pw.port_qformer_bert(
                pw.load_state_dict(bert),
                num_layers=model.cfg.detokenizer.mapper_layers), BERT_ROOT)
    return model, report


def write_components(model: Setokim, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for component in COMPONENTS:
        save_subtree(os.path.join(out_dir, f"{component}.npz"), model,
                     prefix_predicate(component))


def main(argv=None) -> Dict[str, Tuple[int, int]]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--siglip", default=None,
                   help="SiglipVisionModel state dict (.bin/.safetensors)")
    p.add_argument("--llama", default=None,
                   help="LlamaForCausalLM state dict")
    p.add_argument("--bert", default=None,
                   help="BertModel state dict (Q-Former mapper init)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="assemble on the CPU (default: the card)")
    args = p.parse_args(argv)
    model, report = assemble(args.siglip, args.llama, args.bert, args.tiny,
                             device="cpu" if args.cpu else None)
    write_components(model, args.out_dir)
    for root, (n, unmatched) in report.items():
        print(f"{root}: spliced {n - unmatched}/{n} arrays")
    print(f"wrote component subtrees → {args.out_dir}")
    return report


if __name__ == "__main__":
    main()
