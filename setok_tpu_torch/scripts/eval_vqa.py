"""VQA evaluation: batched greedy decode and the official soft accuracy,
on the card.

    python -m setok_tpu_torch.scripts.eval_vqa --synthetic 8 --tiny --cpu
    python -m setok_tpu_torch.scripts.eval_vqa --checkpoint RUN_DIR \
        --synthetic 64

The port's counterpart of the JAX package's `scripts/eval_vqa.py`, with
its flags. The model comes from `models/builder.load_pretrained_model`
(`--checkpoint`: a stage-2 run directory of the port; `--tiny`: the test
configuration). `--synthetic N` builds the JAX script's records from
`RandomState(0)` (6 question ids, a uniform image, ten "yes" answers
each), runs them through `generate_text` in batches of `--batch-size`
(BOS, k_max image slots, the question; greedy, EOS 2) and scores each
prediction (its ids above 2, joined by spaces) with `vqa_accuracy`. It
writes {summary, results} to `--out` and prints the summary. The dataset
mode needs a real tokenizer and raises the JAX script's SystemExit (before
the model is built).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from setok_tpu_torch.constants import IMAGE_TOKEN_INDEX
from setok_tpu_torch.data.vqa_eval import vqa_accuracy
from setok_tpu_torch.models.builder import load_pretrained_model
from setok_tpu_torch.models.generate import generate_text


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--questions", default=None)
    p.add_argument("--annotations", default=None)
    p.add_argument("--image-folder", default="")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "vqa_eval.json"))
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def synthetic_records(n: int, size: int) -> list:
    rs = np.random.RandomState(0)
    return [{"question_id": i,
             "question_ids": rs.randint(10, 400, 6).tolist(),
             "image": (rs.rand(size, size, 3) * 2 - 1).astype(np.float32),
             "answers": ["yes"] * 10}
            for i in range(n)]


def decode(ids) -> str:
    return " ".join(map(str, ids))


@torch.no_grad()
def run(model, records: list, batch_size: int, max_new_tokens: int) -> list:
    """Each record's prediction and accuracy, in batches."""
    cfg = model.cfg
    size, k_max = cfg.tokenizer.vit.image_size, cfg.tokenizer.k_max
    dev = model.device
    results = []
    for i in range(0, len(records), batch_size):
        chunk = records[i:i + batch_size]
        length = k_max + 2 + max(len(r["question_ids"]) for r in chunk)
        ids = np.zeros((len(chunk), length), np.int64)
        imgs = np.zeros((len(chunk), size, size, 3), np.float32)
        for j, r in enumerate(chunk):
            ids[j, 0] = 1
            ids[j, 1:1 + k_max] = IMAGE_TOKEN_INDEX
            q = r["question_ids"]
            ids[j, 1 + k_max:1 + k_max + len(q)] = q
            imgs[j] = r["image"]
        out = generate_text(model, torch.from_numpy(ids).to(dev),
                            torch.from_numpy(imgs).to(dev),
                            max_new_tokens=max_new_tokens, eos_id=2)
        toks = out.tokens.cpu().numpy()
        for j, r in enumerate(chunk):
            pred = decode([t for t in toks[j].tolist() if t > 2])
            results.append({"question_id": r["question_id"],
                            "prediction": pred,
                            "accuracy": vqa_accuracy(pred, r["answers"])})
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit(
            "dataset mode needs a real tokenizer; wire --questions/"
            "--annotations with an HF tokenizer checkpoint "
            "(see data/vqa_eval.py + data/datasets.py loaders)")
    model = load_pretrained_model(args.checkpoint, tiny=args.tiny,
                                  device="cpu" if args.cpu else None)
    records = synthetic_records(args.synthetic,
                                model.cfg.tokenizer.vit.image_size)
    if args.limit:
        records = records[:args.limit]
    results = run(model, records, args.batch_size, args.max_new_tokens)
    accs = [r["accuracy"] for r in results]
    summary = {"n": len(results),
               "accuracy": float(np.mean(accs)) if accs else 0.0}
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "results": results}, f)
    print(json.dumps(summary))
    return {"summary": summary, "results": results}


if __name__ == "__main__":
    main()
