"""One page of the port's public API: tokenize an image, reconstruct it,
chat about it, and generate an image back.

    python -m setok_tpu_torch.scripts.demo [--tiny] [--cpu]

The port's counterpart of the JAX package's `scripts/demo.py`, on random
weights from seed 0: `--tiny` runs the test configuration, otherwise the
full-width `base_setokim()` (Vicuna-7B trunk, ViT-B/16 SeTok @256) on the
card, on a random image from the seed. The steps:

  1. `Setokim.tokenize` → the image's concept tokens;
  2. `Setokim.detokenize` → the reconstruction and its PSNR;
  3. a greedy `generate_text` over a prompt with the image's slots;
  4. `generate_image` from the hidden states of the last generated tokens
     (4 MaskGIT/MAR iterations through the diffusion head, then the
     render).

`--checkpoint` and `--image` are refused: loading weights and reading
image files are ROADMAP.md, Queue A item 4 (checkpoint and data); a real
Setokim checkpoint waits until such files are in the repository.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from setok_tpu_torch import config as cfgs
from setok_tpu_torch.constants import IMAGE_TOKEN_INDEX
from setok_tpu_torch.models.generate import generate_image, generate_text
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.utils.init import init_setokim_random_
from setok_tpu_torch.utils.metrics import psnr

SEED = 0
REFUSED = {
    "checkpoint": "loading a checkpoint: ROADMAP.md, Queue A item 4 "
                  "(checkpoint and data)",
    "image": "reading an image file: ROADMAP.md, Queue A item 4 "
             "(checkpoint and data)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiny", action="store_true",
                   help="the test configuration (default: base_setokim)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--max-new-tokens", type=int, default=8)
    for name in REFUSED:
        p.add_argument("--" + name, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for name, why in REFUSED.items():
        if getattr(args, name) is not None:
            p.error(f"--{name} is not ported: {why}")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = cfgs.tiny_setokim() if args.tiny else cfgs.base_setokim()
    model = init_setokim_random_(
        Setokim(cfg, target_token_id=3, device="cpu" if args.cpu else None),
        SEED)
    dev = model.device
    size = cfg.tokenizer.vit.image_size
    rs = np.random.RandomState(SEED)
    img = (rs.rand(size, size, 3) * 2 - 1).astype(np.float32)
    images = torch.from_numpy(img)[None].to(dev)

    tok = model.tokenize(images)
    print(f"[tokenize] {int(tok.num_clusters[0])} concept tokens "
          f"(k_max={cfg.tokenizer.k_max})")

    det = model.detokenize(tok.tokens, tok.token_valid)
    print(f"[reconstruct] psnr={float(psnr(det.image, images)):.2f} dB")

    k_max = cfg.tokenizer.k_max
    ids = np.zeros((1, k_max + 8), np.int64)
    ids[0, 0] = 1
    ids[0, 1:1 + k_max] = IMAGE_TOKEN_INDEX
    ids[0, 1 + k_max:1 + k_max + 4] = [11, 12, 13, 14]   # toy prompt ids
    out = generate_text(model, torch.from_numpy(ids).to(dev), images,
                        max_new_tokens=args.max_new_tokens, eos_id=-1)
    print(f"[generate] token ids: {out.tokens[0].tolist()}")

    span = out.hidden[:, -min(args.max_new_tokens, 4):]
    gen = generate_image(model, span,
                         torch.Generator(device=dev).manual_seed(SEED),
                         num_iter=4)
    print(f"[image-gen] rendered {tuple(gen.shape)} image, "
          f"finite={bool(torch.isfinite(gen).all())}")


if __name__ == "__main__":
    main()
