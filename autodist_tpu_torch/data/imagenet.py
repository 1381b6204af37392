"""ImageNet-style host-side augmentation for the DataLoader transform hook.

The port's copy of the JAX package's ``data/imagenet.py`` (numpy, so the
two give bitwise equal batches). The expensive decode happens once, when
the dataset is written (``files.DatasetWriter`` stores fixed-shape uint8
tensors), and only the cheap per-epoch random part (crop, flip, normalize)
runs per batch, as a numpy ``transform`` on the loader's output.
Randomness derives from ``(seed, step)``, so every rank applies the same
augmentation to its slice (the determinism contract of
``DataLoader.transform``).

The default normalization subtracts the channel means only (the ImageNet
recipe of the JAX package's reference, ``CHANNEL_MEANS``; it never divides
by a std). ``stds=CHANNEL_STDS`` opts into the torchvision-style mean/std
recipe. Outputs are float32 NHWC, ready for the model's own bf16 cast on
the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

# CHANNEL_MEANS (R=123.68, G=116.78, B=103.94), in 0-255 scale.
# CHANNEL_STDS are the common ImageNet stds (opt-in).
CHANNEL_MEANS = (123.68, 116.78, 103.94)
CHANNEL_STDS = (58.393, 57.12, 57.375)


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((seed, step)))


def augment(
    image_key: str = "image",
    crop: Optional[int] = None,
    pad: int = 4,
    flip: bool = True,
    normalize: bool = True,
    means: Sequence[float] = CHANNEL_MEANS,
    stds: Optional[Sequence[float]] = None,
    seed: int = 0,
):
    """Build a training transform: pad-random-crop + horizontal flip +
    mean/std normalize on uint8/float NHWC images.

    ``crop=None`` keeps the stored size (crop after ``pad``-pixel reflection
    padding, the ResNet-on-small-images recipe); an explicit ``crop``
    takes random ``crop x crop`` windows of the stored image (the ImageNet
    train recipe with decode-once storage).
    """

    def transform(batch: Dict[str, np.ndarray], step: int) -> Dict[str, np.ndarray]:
        img = batch[image_key]
        if img.ndim != 4:
            raise ValueError(f"{image_key!r} must be NHWC, got {img.shape}")
        rng = _rng(seed, step)
        n, h, w, _ = img.shape
        out_h = out_w = crop if crop is not None else h
        if crop is None and pad > 0:
            img = np.pad(
                img, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect")
        max_y = img.shape[1] - out_h
        max_x = img.shape[2] - out_w
        ys = rng.integers(0, max_y + 1, size=n)
        xs = rng.integers(0, max_x + 1, size=n)
        cropped = np.empty((n, out_h, out_w, img.shape[3]), img.dtype)
        for i in range(n):
            cropped[i] = img[i, ys[i]:ys[i] + out_h, xs[i]:xs[i] + out_w]
        if flip:
            flips = rng.random(n) < 0.5
            cropped[flips] = cropped[flips, :, ::-1]
        out = cropped.astype(np.float32)
        if normalize:
            out -= np.asarray(means, np.float32)
            if stds is not None:
                out /= np.asarray(stds, np.float32)
        new = dict(batch)
        new[image_key] = out
        return new

    return transform


def eval_transform(
    image_key: str = "image",
    crop: Optional[int] = None,
    normalize: bool = True,
    means: Sequence[float] = CHANNEL_MEANS,
    stds: Optional[Sequence[float]] = None,
):
    """Deterministic eval transform: center crop + normalize (resize,
    central crop and mean subtraction; the resize happened when the dataset
    was written)."""

    def transform(batch: Dict[str, np.ndarray], step: int) -> Dict[str, np.ndarray]:
        del step
        img = batch[image_key]
        if crop is not None:
            y = (img.shape[1] - crop) // 2
            x = (img.shape[2] - crop) // 2
            img = img[:, y:y + crop, x:x + crop]
        out = img.astype(np.float32)
        if normalize:
            out -= np.asarray(means, np.float32)
            if stds is not None:
                out /= np.asarray(stds, np.float32)
        new = dict(batch)
        new[image_key] = out
        return new

    return transform
