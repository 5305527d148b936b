"""Image pipeline nodes.

Counterpart of ``keystone_tpu/nodes/images/core.py`` (the reference's
``nodes/images`` package). Images are (H, W, C) float tensors; batch
forms work over a written-out leading batch dimension.

The augmentation nodes (``RandomPatcher``, ``RandomFlipper``,
``RandomImageTransformer``) draw through their own ``torch.Generator``
seeded with ``seed``, on the host, so a seed gives the same draws on
every device; row i's draws depend only on the seed and i. They cannot
reproduce ``jax.random``: their deterministic part (``crop_patches``,
``flip_where``) is what matches the JAX package given the same offsets
or mask.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops import image_ops
from ...ops.kernels import featurize_plan, fused_cifar_featurize
from ...parallel.dataset import ArrayDataset, Dataset
from ...workflow.transformer import Transformer


def _on(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class ImageVectorizer(Transformer):
    """Flatten an image to a vector (reference ``images/ImageVectorizer``)."""

    def apply(self, img):
        return img.reshape(-1)

    def apply_batch(self, imgs):
        return imgs.reshape(imgs.shape[0], -1)


class PixelScaler(Transformer):
    """Divide pixels by 255 (reference ``images/PixelScaler``)."""

    def apply(self, img):
        return img / 255.0

    def apply_batch(self, imgs):
        return imgs / 255.0


class GrayScaler(Transformer):
    """MATLAB-weight grayscale (reference ``images/GrayScaler``)."""

    def apply(self, img):
        return image_ops.to_grayscale(img)

    def apply_batch(self, imgs):
        return image_ops.to_grayscale(imgs)


class Cropper(Transformer):
    """Static crop [x0:x1, y0:y1] (reference ``images/Cropper``)."""

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1

    def apply(self, img):
        return img[self.x0:self.x1, self.y0:self.y1, :]

    def apply_batch(self, imgs):
        return imgs[:, self.x0:self.x1, self.y0:self.y1, :]


class SymmetricRectifier(Transformer):
    """Channel-doubling rectifier [max(v, x-a), max(v, -x-a)]
    (reference ``images/SymmetricRectifier.scala:12-30``)."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = float(max_val)
        self.alpha = float(alpha)

    def apply(self, img):
        pos = torch.clamp_min(img - self.alpha, self.max_val)
        neg = torch.clamp_min(-img - self.alpha, self.max_val)
        return torch.cat([pos, neg], dim=-1)

    def apply_batch(self, imgs):
        return self.apply(imgs)


class Pooler(Transformer):
    """Strided spatial pooling (reference ``images/Pooler.scala:20-68``).
    pixel_fn/pool_fn are named ('identity'|'abs'|'square',
    'sum'|'max'|'mean') so node equality stays structural."""

    def __init__(self, stride: int, pool_size: int,
                 pixel_fn: str = "identity", pool_fn: str = "sum"):
        self.stride = stride
        self.pool_size = pool_size
        self.pixel_fn = pixel_fn
        self.pool_fn = pool_fn

    def apply(self, img):
        return image_ops.pool_image(
            img, self.stride, self.pool_size, self.pixel_fn, self.pool_fn)

    def apply_batch(self, imgs):
        return self.apply(imgs)


class Convolver(Transformer):
    """Filter-bank convolution with optional per-patch normalization and
    whitening fold-in (reference ``images/Convolver.scala:20-45``).

    ``filters`` is (num_filters, conv_size^2 * channels) in (dy, dx, c)
    feature order, pre-whitened by the caller exactly as in the reference
    (filters_normalized @ whitener.T); the whitener's means are subtracted
    from each normalized patch (``ops/image_ops.filter_bank_convolve``).
    """

    def __init__(self, filters: np.ndarray, img_height: int, img_width: int,
                 img_channels: int, whitener=None,
                 normalize_patches: bool = True, var_constant: float = 10.0):
        self.filters = np.ascontiguousarray(filters, dtype=np.float32)
        self.img_height = img_height
        self.img_width = img_width
        self.img_channels = img_channels
        self.whitener_means = (None if whitener is None else
                               np.asarray(whitener.means, np.float32))
        self.normalize_patches = normalize_patches
        self.var_constant = var_constant
        self.conv_size = int(round(
            (self.filters.shape[1] / img_channels) ** 0.5))

    def apply_params(self, device):
        return self._params_on(device, lambda d: (
            _on(self.filters, d),
            None if self.whitener_means is None
            else _on(self.whitener_means, d)))

    def apply_with_params(self, params, img):
        filters, means = params
        return image_ops.filter_bank_convolve(
            img, filters, self.conv_size, self.img_channels,
            self.normalize_patches, means, self.var_constant)

    def apply(self, img):
        return self.apply_with_params(self.apply_params(img.device), img)

    def apply_batch(self, imgs):
        return self.apply(imgs)


class Windower(Transformer):
    """Dense sliding-window patch extraction (reference
    ``images/Windower.scala:14-55``). A 1->many node: each image yields
    all its windows, so the output dataset has n * num_windows items,
    image-major. Padding rows of the input map to trailing zero windows,
    so the true count stays exact."""

    fusable = False

    def __init__(self, stride: int, window_size: int):
        self.stride = stride
        self.window_size = window_size

    def apply(self, img):
        w = image_ops.extract_windows(img, self.window_size, self.stride)
        nH, nW, S, _, C = w.shape
        return w.reshape(nH * nW, S, S, C)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        assert isinstance(ds, ArrayDataset)
        w = image_ops.extract_windows(ds.data, self.window_size, self.stride)
        B, nH, nW = w.shape[:3]
        flat = w.reshape((B * nH * nW,) + tuple(w.shape[3:]))
        return ArrayDataset(flat, ds.n * nH * nW, ds.mesh, shards=ds.shards)


class FusedConvRectifyPool(Transformer):
    """Fused Convolver >> SymmetricRectifier >> Pooler(sum) >> vectorize
    as one CUDA kernel (``ops/kernels.fused_cifar_featurize``): the
    convolution and rectifier outputs never leave the chip. The batch
    path and the datum path (a batch of one) both run the kernel on a
    CUDA tensor and its plain version on a CPU tensor. Same contract as
    Convolver: ``filters`` arrive pre-whitened by the caller; the
    whitener contributes only its means, subtracted after
    normalization. Never fused: the JAX package's counterpart has its
    own batch path."""

    fusable = False

    def __init__(self, filters, img_size: int, patch_size: int,
                 channels: int = 3, pool_stride: int = 13,
                 pool_size: int = 14, alpha: float = 0.25,
                 whitener=None, var_constant: float = 10.0):
        self.filters = np.ascontiguousarray(filters, np.float32)
        self.whitener_means = None
        if whitener is not None:
            self.whitener_means = np.asarray(whitener.means, np.float32)
        self.img_size = img_size
        self.patch_size = patch_size
        self.channels = channels
        self.pool_stride = pool_stride
        self.pool_size = pool_size
        self.alpha = alpha
        self.var_constant = var_constant

    def apply_params(self, device):
        """(filters, whitener means) on ``device``; on a CUDA device the
        kernel's ``FeaturizePlan`` (the filters laid out (F, K) with the
        means' bias), made once per device, takes the filters' place and
        the means are None, so the bank lives on the card once."""
        def build(d):
            filters = _on(self.filters, d)
            means = (None if self.whitener_means is None
                     else _on(self.whitener_means, d))
            plan = featurize_plan(filters, means)
            return (filters, means) if plan is None else (plan, None)

        return self._params_on(device, build)

    def apply_with_params(self, params, img):
        """``img`` is the (B, H, W, C) batch the kernel featurizes."""
        filters, means = params
        # the kernel reads (B, H, W, C) rows in place; a view of another
        # layout (a transposed decode) is copied once here
        return fused_cifar_featurize(
            img.contiguous(), filters, self.img_size, self.patch_size,
            self.channels, self.pool_stride, self.pool_size,
            self.var_constant, self.alpha, whitener_means=means)

    def apply_batch(self, imgs):
        return self.apply_with_params(self.apply_params(imgs.device), imgs)

    def apply(self, img):
        return self.apply_batch(img[None].contiguous())[0]


def _flatten_leading(x: torch.Tensor) -> torch.Tensor:
    """(P, M, ...) -> (P * M, ...), item-major."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def crop_patches(imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 px: int, py: int) -> torch.Tensor:
    """The crops ``imgs[i, xs[i, j]:+px, ys[i, j]:+py, :]`` of a (P, H, W,
    C) batch for integer offsets xs, ys (P, M), as one gather:
    (P, M, px, py, C)."""
    dev = imgs.device
    xs, ys = xs.to(dev), ys.to(dev)
    rows = torch.arange(imgs.shape[0], device=dev)[:, None, None, None]
    ix = (xs[:, :, None] + torch.arange(px, device=dev))[:, :, :, None]
    iy = (ys[:, :, None] + torch.arange(py, device=dev))[:, :, None, :]
    return imgs[rows, ix, iy]


def _row_uniforms(seed: int, rows: int, per_row: int) -> torch.Tensor:
    """(rows, per_row) uniforms in [0, 1) from a host generator seeded
    with ``seed``; row i's values depend only on the seed and i."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.rand((rows, per_row), generator=g, dtype=torch.float64)


class RandomPatcher(Transformer):
    """Uniformly random crops, ``num_patches`` an image (reference
    ``images/RandomPatcher.scala:17-46``): a 1->many node whose output
    is item-major. The offsets are :meth:`offsets`, the crops
    :func:`crop_patches`."""

    fusable = False

    def __init__(self, num_patches: int, patch_size_x: int, patch_size_y: int,
                 seed: int = 0):
        self.num_patches = num_patches
        self.patch_size_x = patch_size_x
        self.patch_size_y = patch_size_y
        self.seed = seed

    def offsets(self, rows: int, H: int, W: int):
        """(xs, ys), each (rows, num_patches) int64 on the host: uniform
        over the H - px + 1 and W - py + 1 valid starts."""
        u = _row_uniforms(self.seed, rows, 2 * self.num_patches)
        u = u.reshape(rows, self.num_patches, 2)
        xs = (u[..., 0] * (H - self.patch_size_x + 1)).long()
        ys = (u[..., 1] * (W - self.patch_size_y + 1)).long()
        return xs, ys

    def apply(self, img):
        return self.apply_batch(img[None])[0]

    def apply_batch(self, imgs):
        P, H, W, _ = imgs.shape
        xs, ys = self.offsets(P, H, W)
        return crop_patches(imgs, xs, ys, self.patch_size_x,
                            self.patch_size_y)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        assert isinstance(ds, ArrayDataset)
        return ArrayDataset(_flatten_leading(self.apply_batch(ds.data)),
                            ds.n * self.num_patches, mesh=ds.mesh)

    def abstract_eval(self, dep_specs):
        return _patcher_abstract_eval(
            self, dep_specs, self.patch_size_x, self.patch_size_y,
            self.num_patches)


class CenterCornerPatcher(Transformer):
    """The four corner crops and the center crop, each also flipped when
    ``horizontal_flips`` (reference ``images/CenterCornerPatcher.scala``):
    test-time augmentation, 5 or 10 patches an image, item-major."""

    fusable = False

    def __init__(self, patch_size_x: int, patch_size_y: int,
                 horizontal_flips: bool = False):
        self.patch_size_x = patch_size_x
        self.patch_size_y = patch_size_y
        self.horizontal_flips = horizontal_flips

    @property
    def patches_per_image(self) -> int:
        return 10 if self.horizontal_flips else 5

    def apply_batch(self, imgs):
        H, W = imgs.shape[1], imgs.shape[2]
        px, py = self.patch_size_x, self.patch_size_y
        starts = [(0, 0), (0, W - py), (H - px, 0), (H - px, W - py),
                  ((H - px) // 2, (W - py) // 2)]
        crops = [imgs[:, x:x + px, y:y + py, :] for x, y in starts]
        if self.horizontal_flips:
            crops += [c.flip(-2) for c in crops]
        return torch.stack(crops, dim=1)

    def apply(self, img):
        return self.apply_batch(img[None])[0]

    def apply_dataset(self, ds: Dataset) -> Dataset:
        assert isinstance(ds, ArrayDataset)
        return ArrayDataset(_flatten_leading(self.apply_batch(ds.data)),
                            ds.n * self.patches_per_image, mesh=ds.mesh)

    def abstract_eval(self, dep_specs):
        return _patcher_abstract_eval(
            self, dep_specs, self.patch_size_x, self.patch_size_y,
            self.patches_per_image)


def _patcher_abstract_eval(op, dep_specs, px, py, patches_per_image):
    """Static semantics of the cropping augmenters: each (H, W, C) image
    becomes ``patches_per_image`` items of (px, py, C), multiplying the
    dataset's item count."""
    from ...analysis.spec import DatasetSpec, ShapeDtype, Unknown

    (d,) = dep_specs
    if not isinstance(d, DatasetSpec):
        return Unknown(f"{type(op).__name__} is dataset-only")
    e = d.element
    if not (isinstance(e, ShapeDtype) and len(e.shape) == 3):
        return Unknown("patcher input not an (H, W, C) image element")
    H, W, C = e.shape
    if H < px or W < py:
        raise ValueError(
            f"{type(op).__name__}: patch ({px}, {py}) larger than "
            f"input image ({H}, {W})")
    n = None if d.n is None else d.n * patches_per_image
    return DatasetSpec(ShapeDtype((px, py, C), e.dtype), n=n, host=d.host,
                       sparsity=1.0)


def flip_horizontal(imgs: torch.Tensor) -> torch.Tensor:
    """Mirror (..., H, W, C) images along the width."""
    return imgs.flip(-2)


def flip_where(imgs: torch.Tensor, hit: torch.Tensor, transform=None):
    """``transform(imgs)`` on the rows where ``hit`` (P,) is True, the
    rows as they are elsewhere; ``transform`` defaults to the horizontal
    flip."""
    changed = (transform or flip_horizontal)(imgs)
    hit = hit.to(imgs.device).reshape((-1,) + (1,) * (imgs.dim() - 1))
    return torch.where(hit, changed, imgs)


class RandomImageTransformer(Transformer):
    """Apply an image transform with probability ``prob`` an image
    (reference ``images/RandomImageTransformer.scala:16-30``). The
    transform maps (H, W, C) images to images of the same shape and is
    written on the trailing dimensions, so one call transforms a whole
    (P, H, W, C) batch; :meth:`mask` draws the rows it applies to. The
    datum path leaves an image as it is, as the JAX node does."""

    fusable = False

    def __init__(self, prob: float, transform, seed: int = 0):
        self.prob = prob
        self.transform = transform
        self.seed = seed

    def eq_key(self):
        # a function has no stable content key: its identity (one process)
        return (RandomImageTransformer, self.prob, self.seed,
                id(self.transform))

    def mask(self, rows: int) -> torch.Tensor:
        """(rows,) bool on the host: True where the transform applies."""
        return _row_uniforms(self.seed, rows, 1)[:, 0] < self.prob

    def apply(self, img):
        return img

    def apply_dataset(self, ds: Dataset) -> Dataset:
        assert isinstance(ds, ArrayDataset)
        return ds.map_batch(lambda imgs: flip_where(
            imgs, self.mask(imgs.shape[0]), self.transform))


class RandomFlipper(RandomImageTransformer):
    """Horizontal flip with probability ``prob``: the common
    specialization of RandomImageTransformer, with a content key (the
    reference uses ``ImageUtils.flipHorizontal`` there)."""

    def __init__(self, prob: float = 0.5, seed: int = 0):
        super().__init__(prob, flip_horizontal, seed)

    def eq_key(self):
        return (RandomFlipper, self.prob, self.seed)


class LabelExtractor(Transformer):
    """(image, label) -> label (reference ``images/LabeledImageExtractors``)."""

    def apply(self, item):
        return item[1]

    def apply_batch(self, X):
        return X[1]


class ImageExtractor(Transformer):
    """(image, label) -> image."""

    def apply(self, item):
        return item[0]

    def apply_batch(self, X):
        return X[0]
