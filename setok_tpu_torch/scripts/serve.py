"""Serving CLI: the continuous-batching engine over Setokim, on the card.

    python -m setok_tpu_torch.scripts.serve [--tiny] [--bits 8|4] [--kv-bits 8]
                                            [--decode-block K | --spec-len D]
                                            [--prefill-chunk C
                                             [--system-prompt TEXT]]
    python -m setok_tpu_torch.scripts.serve --cpu --tiny

Reads prompts (one per line from --prompts-file, or a built-in demo set),
feeds them through `setok_tpu_torch.serve.ServeEngine` and prints each
request's completion as it retires, then tokens/s and the mean TTFT. The
weights are random, from a seed: `--tiny` runs the test configuration,
otherwise the full-width `base_setokim()` (Vicuna-7B trunk, ViT-B/16
SeTok). `--bits 8|4` quantises the trunk as the JAX CLI does (int4: group
`--quant-group` where the widths allow, clip search 8), layer by layer on
the device. `--decode-block K` runs K decode steps per host round trip;
`--spec-len D` drafts D tokens a row by prompt lookup (n-grams up to
`--spec-ngram`) and verifies them in one forward; `--prefill-chunk C`
admits text prompts in chunks of C tokens, up to the cache's width; and
`--system-prompt` prepends a text to every prompt (without a second BOS)
and registers it as a cached prefix, which needs `--prefill-chunk`.

`--checkpoint` loads the weights through `models/builder
.load_pretrained_model` (a stage-2 run directory of the port, its adapters
merged; `--bits 8|4` quantised after the load), in place of the seed.

`--tensor-parallel T` under `torchrun --nproc-per-node N` (one process
per card; with `--cpu`, gloo processes): a (N/T, T) (data, model) mesh as
the JAX CLI builds it, the trunk TP-sharded over `model` and the KV cache
over kv heads (serve/engine.py); every rank runs the engine on the same
prompts and the first prints. At one process the mesh has size 1.

The flags are the JAX CLI's (`scripts/serve.py`). There, `--tiny`
defaults to on, so that the JAX CLI always runs the test configuration;
here it is a switch, and the default is the full width.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.data.tokenizer import load_text_tokenizer
from setok_tpu_torch.models.builder import load_pretrained_model
from setok_tpu_torch.models.llama import valid_quant_group
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.scripts.train_setok import main_rank, parallel_setup
from setok_tpu_torch.serve import ServeEngine
from setok_tpu_torch.utils.compile_cache import (add_cli_flag,
                                                 enable_compilation_cache)
from setok_tpu_torch.utils.init import init_setokim_random_

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
    p.add_argument("--spec-len", type=int, default=0,
                   help="speculative decoding: drafts a row by prompt "
                        "lookup, verified in one forward (exclusive with "
                        "--decode-block > 1)")
    p.add_argument("--spec-ngram", type=int, default=3)
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="admit text prompts in chunks of C tokens, up to "
                        "the cache width")
    p.add_argument("--system-prompt", default=None,
                   help="text prepended to every prompt and registered as "
                        "a cached prefix (needs --prefill-chunk)")
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
    p.add_argument("--checkpoint", default=None,
                   help="a stage-2 run directory (models/builder.py)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="TP-shard the trunk over T ranks (torchrun)")
    add_cli_flag(p)
    args = p.parse_args(argv)
    if args.system_prompt and args.prefill_chunk <= 0:
        p.error("--system-prompt requires --prefill-chunk")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    enable_compilation_cache(args.compile_cache)
    device, mesh, _ = parallel_setup(args.cpu, args.tensor_parallel)
    show = main_rank()
    cfg = cfgs.tiny_setokim() if args.tiny else cfgs.base_setokim()
    group = (valid_quant_group(cfg.llama, args.quant_group)
             if args.bits == 4 else 0)
    if args.checkpoint:
        model = load_pretrained_model(args.checkpoint, cfg,
                                      target_token_id=3, bits=args.bits,
                                      quant_group=args.quant_group,
                                      device=device)
    else:
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
    sys_ids = np.asarray([], np.int64)
    if args.system_prompt:
        sys_ids = np.asarray(tok.encode(args.system_prompt), np.int64)

    def encode(text):
        ids = np.asarray(tok.encode(text), np.int64)
        if len(sys_ids):
            bos = getattr(tok, "bos_token_id", None)
            if bos is not None and len(ids) and ids[0] == bos:
                ids = ids[1:]             # BOS only at the prefix's head
            ids = np.concatenate([sys_ids, ids])
        return ids[:max(args.prompt_len, len(sys_ids) + 8)]

    enc = [encode(t) for t in prompts]

    eng = ServeEngine(model, max_batch=args.max_batch,
                      prompt_len=args.prompt_len, max_len=args.max_len,
                      temperature=args.temperature, top_p=args.top_p,
                      presence_penalty=args.presence_penalty,
                      frequency_penalty=args.frequency_penalty,
                      decode_block=args.decode_block,
                      spec_len=args.spec_len, spec_ngram=args.spec_ngram,
                      prefill_chunk=args.prefill_chunk,
                      cache_dtype=(torch.int8 if args.kv_bits == 8
                                   else torch.bfloat16),
                      eos_id=getattr(tok, "eos_token_id", 2),
                      pad_id=getattr(tok, "pad_token_id", 0), mesh=mesh)
    if len(sys_ids):
        eng.register_prefix(sys_ids)
        if show:
            print(f"registered {len(sys_ids)}-token system-prompt prefix")
    t0 = time.perf_counter()
    reqs = [eng.submit(e, max_new_tokens=args.max_new_tokens) for e in enc]
    pending = set(range(len(reqs)))
    while pending:
        eng.step()
        for i in sorted(pending):
            if reqs[i].done:
                pending.discard(i)
                if show:
                    print(f"[{i}] {prompts[i]!r} -> "
                          f"{tok.decode(reqs[i].tokens)!r}")
    ntok = sum(len(r.tokens) for r in reqs)
    dt = time.perf_counter() - t0
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    if not show:
        return
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
