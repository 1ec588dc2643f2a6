"""Serving CLI: the continuous-batching engine over Setokim, on the card.

    python -m setok_tpu_torch.scripts.serve [--tiny] [--bits 8|4] [--kv-bits 8]
                                            [--decode-block K]
    python -m setok_tpu_torch.scripts.serve --cpu --tiny

Reads prompts (one per line from --prompts-file, or a built-in demo set),
feeds them through `setok_tpu_torch.serve.ServeEngine` and prints each
request's completion as it retires, then tokens/s and the mean TTFT. The
weights are random, from a seed: `--tiny` runs the test configuration,
otherwise the full-width `base_setokim()` (Vicuna-7B trunk, ViT-B/16
SeTok). `--bits 8|4` quantises the trunk as the JAX CLI does (int4: group
`--quant-group` where the widths allow, clip search 8), layer by layer on
the device. `--decode-block K` runs K decode steps per host round trip.

The flags are the JAX CLI's (`scripts/serve.py`) that this port runs; its
others are refused with a message naming their ROADMAP.md entry. There,
`--tiny` defaults to on, so that the JAX CLI always runs the test
configuration; here it is a switch, and the default is the full width.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.data.tokenizer import load_text_tokenizer
from setok_tpu_torch.models.llama import valid_quant_group
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.utils.init import init_setokim_random_

# the JAX CLI's flags that this port does not run
REFUSED = {
    "checkpoint": "loading a checkpoint: ROADMAP.md, Queue A (checkpoints)",
    "spec_len": "speculative decoding: ROADMAP.md, Queue A (serving "
                "features)",
    "spec_ngram": "speculative decoding: ROADMAP.md, Queue A (serving "
                  "features)",
    "tensor_parallel": "multi-card serving: ROADMAP.md, Queue A (serving "
                       "features; after the parallel item)",
    "prefill_chunk": "chunked prefill and the prefix cache: ROADMAP.md, "
                     "Queue A (serving features)",
    "system_prompt": "chunked prefill and the prefix cache: ROADMAP.md, "
                     "Queue A (serving features)",
}

DEMO_PROMPTS = ["Describe the image.", "What color is the sky?",
                "Write a haiku about clustering.",
                "Summarize SeTok in one line."]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer path (word-hash fallback)")
    p.add_argument("--prompts-file", default=None)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling at temperature>0 (1.0 = off)")
    p.add_argument("--presence-penalty", type=float, default=0.0)
    p.add_argument("--frequency-penalty", type=float, default=0.0)
    p.add_argument("--decode-block", type=int, default=1,
                   help="decode steps per host round trip")
    p.add_argument("--bits", type=int, default=16, choices=[16, 8, 4],
                   help="8/4 = int8/packed-int4-at-rest trunk")
    p.add_argument("--quant-group", type=int, default=128,
                   help="int4 scale group along the input dim (0 = per "
                        "output channel)")
    p.add_argument("--kv-bits", type=int, default=16, choices=[16, 8],
                   help="8 = int8 KV cache with per-token scales")
    p.add_argument("--tiny", action="store_true",
                   help="the test configuration (default: base_setokim)")
    p.add_argument("--cpu", action="store_true")
    for name in REFUSED:
        p.add_argument("--" + name.replace("_", "-"), default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for name, why in REFUSED.items():
        if getattr(args, name) is not None:
            p.error(f"--{name.replace('_', '-')} is not ported: {why}")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    cfg = cfgs.tiny_setokim() if args.tiny else cfgs.base_setokim()
    group = (valid_quant_group(cfg.llama, args.quant_group)
             if args.bits == 4 else 0)
    model = Setokim(cfg, target_token_id=3, weight_bits=args.bits,
                    quant_group=group, device=device)
    init_setokim_random_(model, seed=0,
                         clip_search=8 if args.bits == 4 else 0)
    tok = load_text_tokenizer(args.tokenizer,
                              vocab_size=cfg.llama.vocab_size)
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    else:
        prompts = DEMO_PROMPTS
    enc = [np.asarray(tok.encode(t), np.int64)[:args.prompt_len]
           for t in prompts]

    eng = ServeEngine(model, max_batch=args.max_batch,
                      prompt_len=args.prompt_len, max_len=args.max_len,
                      temperature=args.temperature, top_p=args.top_p,
                      presence_penalty=args.presence_penalty,
                      frequency_penalty=args.frequency_penalty,
                      decode_block=args.decode_block,
                      cache_dtype=(torch.int8 if args.kv_bits == 8
                                   else torch.bfloat16),
                      eos_id=getattr(tok, "eos_token_id", 2),
                      pad_id=getattr(tok, "pad_token_id", 0))
    t0 = time.perf_counter()
    reqs = [eng.submit(e, max_new_tokens=args.max_new_tokens) for e in enc]
    pending = set(range(len(reqs)))
    while pending:
        eng.step()
        for i in sorted(pending):
            if reqs[i].done:
                pending.discard(i)
                print(f"[{i}] {prompts[i]!r} -> "
                      f"{tok.decode(reqs[i].tokens)!r}")
    ntok = sum(len(r.tokens) for r in reqs)
    dt = time.perf_counter() - t0
    print(f"{len(reqs)} requests, {ntok} tokens in {dt:.1f}s "
          f"({ntok / max(dt, 1e-9):.1f} tok/s on {model.device})")
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    lats = [r.latency for r in reqs if r.latency is not None]
    if ttfts:
        print(f"TTFT mean {1e3 * sum(ttfts) / len(ttfts):.0f} ms, "
              f"latency mean {1e3 * sum(lats) / len(lats):.0f} ms; "
              f"engine stats: {eng.stats()}")


if __name__ == "__main__":
    main()
