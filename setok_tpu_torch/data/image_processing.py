"""Host-side image preprocessing (numpy / PIL) for the port's entry points.

The counterpart of `setok_tpu/data/image_processing.py`: `expand2square`,
`ImageProcessor` (resize + normalize to float32 (H, W, 3), SigLIP's mean
and std by default) and `GeneratorImageProcessor` (the [-1, 1] scaling of
the generation targets). PIL is imported where an image is first handled.
`use_native=True` runs the C++ resize + normalize of `data/native.py`
(bilinear; PIL's path is bicubic) and raises where it cannot be built: the
JAX package falls back to PIL there, the port does not hide it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def expand2square(img, background_color: Tuple[int, ...]):
    """Pad a PIL image to a square with `background_color`, centred."""
    from PIL import Image
    width, height = img.size
    if width == height:
        return img
    side = max(width, height)
    result = Image.new(img.mode, (side, side), background_color)
    if width > height:
        result.paste(img, (0, (side - height) // 2))
    else:
        result.paste(img, ((side - width) // 2, 0))
    return result


def _resize(img, size: int) -> np.ndarray:
    from PIL import Image
    img = img.convert("RGB").resize((size, size), Image.BICUBIC)
    return np.asarray(img, dtype=np.float32)


@dataclasses.dataclass
class ImageProcessor:
    """Resize + normalize → float32 (size, size, 3)."""

    size: int = 256
    mean: Sequence[float] = SIGLIP_MEAN
    std: Sequence[float] = SIGLIP_STD
    pad_to_square: bool = False
    use_native: bool = False

    @property
    def image_mean(self):
        return tuple(self.mean)

    def preprocess(self, img) -> np.ndarray:
        if self.pad_to_square:
            img = expand2square(img, tuple(int(x * 255) for x in self.mean))
        if self.use_native:
            from setok_tpu_torch.data.native import resize_normalize
            return resize_normalize(np.asarray(img.convert("RGB"), np.uint8),
                                    self.size, self.mean, self.std)
        arr = _resize(img, self.size) / 255.0
        return ((arr - np.asarray(self.mean, np.float32))
                / np.asarray(self.std, np.float32))

    def __call__(self, img) -> np.ndarray:
        return self.preprocess(img)

    def preprocess_batch(self, imgs) -> np.ndarray:
        """N PIL images or uint8 arrays → (N, size, size, 3); with
        `use_native` (and no padding) one native call over a thread team,
        otherwise a loop."""
        if self.use_native and not self.pad_to_square:
            from setok_tpu_torch.data.native import assemble_batch
            arrs = [im if isinstance(im, np.ndarray)
                    else np.asarray(im.convert("RGB"), np.uint8)
                    for im in imgs]
            return assemble_batch(arrs, self.size, self.mean, self.std)
        return np.stack([self.preprocess(im) for im in imgs])


@dataclasses.dataclass
class GeneratorImageProcessor:
    """[-1, 1] scaling for generation targets."""

    size: int = 256
    use_native: bool = False

    def __call__(self, img) -> np.ndarray:
        if self.use_native:
            from setok_tpu_torch.data.native import resize_normalize
            return resize_normalize(np.asarray(img.convert("RGB"), np.uint8),
                                    self.size, scale=2.0, offset=-1.0)
        return _resize(img, self.size) / 127.5 - 1.0
