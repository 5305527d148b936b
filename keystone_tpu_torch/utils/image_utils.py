"""Image utilities (reference ``utils/images/ImageUtils.scala``).

Counterpart of ``keystone_tpu/utils/image_utils.py``: images are
``(H, W, C)`` tensors in [0, 255] (float32 unless decoded otherwise).
The per-pixel helpers are plain tensor expressions on the image's
device; ``load_image`` and ``write_image`` go through PIL on the host.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..loaders.image_loader_utils import decode_image
from ..ops.device import DEFAULT_DEVICE, resolve_device
from ..ops.image_ops import to_grayscale as _to_grayscale


def load_image(path: str, device=DEFAULT_DEVICE) -> Optional[torch.Tensor]:
    """File -> float32 (H, W, 3) tensor in [0, 255] on ``device``; None
    if undecodable (reference ``ImageUtils.loadImage``, :16)."""
    with open(path, "rb") as f:
        arr = decode_image(f.read())
    return None if arr is None else torch.as_tensor(
        arr, device=resolve_device(device))


def write_image(path: str, img) -> None:
    """(H, W, C) image in [0, 255] -> image file through PIL, clipped and
    rounded down to uint8 (reference ``ImageUtils.writeImage``, :59)."""
    from PIL import Image as PILImage

    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) \
        else np.asarray(img)
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    PILImage.fromarray(arr).save(path)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """NTSC luminance (reference ``ImageUtils.toGrayScale``, :73)."""
    return _to_grayscale(img)


def map_pixels(img: torch.Tensor, fn: Callable) -> torch.Tensor:
    """Elementwise pixel transform (reference ``mapPixels``, :115)."""
    return fn(img)


def crop(img: torch.Tensor, x_start: int, y_start: int, x_end: int,
         y_end: int) -> torch.Tensor:
    """Rectangular crop (reference ``crop``, :147)."""
    return img[x_start:x_end, y_start:y_end]


def pixel_combine(a: torch.Tensor, b: torch.Tensor,
                  fn: Callable = torch.add) -> torch.Tensor:
    """Combine two same-shape images pixelwise (reference
    ``pixelCombine``, :191)."""
    return fn(a, b)


def split_channels(img: torch.Tensor) -> List[torch.Tensor]:
    """(H, W, C) -> C single-channel (H, W) images (reference
    ``splitChannels``, :346)."""
    return [img[:, :, c] for c in range(img.shape[2])]


def flip_horizontal(img: torch.Tensor) -> torch.Tensor:
    """Mirror along the width axis (reference ``flipHorizontal``, :399)."""
    return img.flip(1)


def flip_vertical(img: torch.Tensor) -> torch.Tensor:
    """Mirror along the height axis (reference ``flipImage``, :376)."""
    return img.flip(0)
