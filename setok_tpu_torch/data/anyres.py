"""AnyRes image tiling helpers and the batch image-processing dispatch.

A copy of `setok_tpu/data/anyres.py`: `select_best_resolution`,
`resize_and_pad_image`, `divide_to_patches`, `process_anyres_image`,
`get_anyres_image_grid_shape` and the square / pad / anyres dispatcher
`process_images`. PIL is imported where an image is first handled.
"""

from __future__ import annotations

import ast
from typing import List, Sequence, Tuple

import numpy as np

from setok_tpu_torch.data.image_processing import (ImageProcessor,
                                                   expand2square)


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions: Sequence[Tuple[int, int]]
                           ) -> Tuple[int, int]:
    """Pick the grid resolution maximizing effective resolution then
    minimizing waste (mm_utils.py:38-65)."""
    ow, oh = original_size
    best, max_eff, min_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (w, h)
    return best


def resize_and_pad_image(image: "PIL.Image.Image",
                         target: Tuple[int, int]) -> "PIL.Image.Image":
    """Aspect-preserving resize centered on a target canvas
    (mm_utils.py:68-85)."""
    from PIL import Image
    ow, oh = image.size
    tw, th = target
    scale = min(tw / ow, th / oh)
    nw, nh = min(int(ow * scale), tw), min(int(oh * scale), th)
    resized = image.resize((nw, nh))
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas


def divide_to_patches(image: "PIL.Image.Image",
                      patch_size: int) -> List["PIL.Image.Image"]:
    """Non-overlapping patch_size crops (mm_utils.py:88-107)."""
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size,
                                       i + patch_size)))
    return patches


def process_anyres_image(image: "PIL.Image.Image", processor: ImageProcessor,
                         grid_pinpoints) -> np.ndarray:
    """Tile + downscaled-base stacking (mm_utils.py:110-135).
    Returns (1 + num_tiles, size, size, 3)."""
    if isinstance(grid_pinpoints, str):
        grid_pinpoints = ast.literal_eval(grid_pinpoints)
    best = select_best_resolution(image.size, grid_pinpoints)
    padded = resize_and_pad_image(image, best)
    patches = divide_to_patches(padded, processor.size)
    base = image.resize((processor.size, processor.size))
    return np.stack([processor(base)] + [processor(p) for p in patches])


def get_anyres_image_grid_shape(image_size: Tuple[int, int], grid_pinpoints,
                                patch_size: int) -> Tuple[int, int]:
    """mm_utils.py:138-145."""
    if isinstance(grid_pinpoints, str):
        grid_pinpoints = ast.literal_eval(grid_pinpoints)
    w, h = select_best_resolution(image_size, grid_pinpoints)
    return w // patch_size, h // patch_size


def process_images(images: Sequence["PIL.Image.Image"],
                   processor: ImageProcessor,
                   image_aspect_ratio: str = "square",
                   image_grid_pinpoints=None) -> np.ndarray:
    """Batch dispatch: square / pad / anyres (mm_utils.py:166-182)."""
    out = []
    for image in images:
        if image_aspect_ratio == "pad":
            image = expand2square(
                image, tuple(int(x * 255) for x in processor.image_mean))
            out.append(processor(image))
        elif image_aspect_ratio == "anyres":
            out.append(process_anyres_image(image, processor,
                                            image_grid_pinpoints))
        else:
            out.append(processor(image))
    if all(o.shape == out[0].shape for o in out):
        return np.stack(out)
    return out
