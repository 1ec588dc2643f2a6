"""One page of the port's public API: tokenize an image, reconstruct it,
chat about it, and generate an image back.

    python -m setok_tpu_torch.scripts.demo [--tiny] [--cpu]
                                           [--checkpoint DIR] [--image PNG]

The port's counterpart of the JAX package's `scripts/demo.py`: the model
of `models/builder.load_pretrained_model(--checkpoint)` (a stage-2 run
directory of the port; without one, random weights from seed 0), `--tiny`
the test configuration, otherwise the full-width `base_setokim()`
(Vicuna-7B trunk, ViT-B/16 SeTok @256) on the card; the image of
`--image` through `GeneratorImageProcessor`, or a random one from the
seed. The steps:

  1. `Setokim.tokenize` → the image's concept tokens;
  2. `Setokim.detokenize` → the reconstruction and its PSNR;
  3. a greedy `generate_text` over a prompt with the image's slots;
  4. `generate_image` from the hidden states of the last generated tokens
     (4 MaskGIT/MAR iterations through the diffusion head, then the
     render).

"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from setok_tpu_torch.constants import IMAGE_TOKEN_INDEX
from setok_tpu_torch.models.builder import load_pretrained_model
from setok_tpu_torch.models.generate import generate_image, generate_text
from setok_tpu_torch.utils.metrics import psnr

SEED = 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tiny", action="store_true",
                   help="the test configuration (default: base_setokim)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--max-new-tokens", type=int, default=8)
    p.add_argument("--checkpoint", default="",
                   help="a stage-2 run directory (models/builder.py)")
    p.add_argument("--image", default=None, help="an image file")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    model = load_pretrained_model(args.checkpoint, tiny=args.tiny,
                                  device="cpu" if args.cpu else None)
    cfg = model.cfg
    dev = model.device
    size = cfg.tokenizer.vit.image_size
    if args.image:
        from PIL import Image

        from setok_tpu_torch.data.image_processing import \
            GeneratorImageProcessor
        img = GeneratorImageProcessor(size=size)(Image.open(args.image))
    else:
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
