"""Train-time augmentation (counterpart of ``blades_tpu/data/augment.py``).

CIFAR-10's loader transforms, RandomCrop(32, padding=4) followed by
RandomHorizontalFlip, as one batched gather: every sample gets its own
crop offsets and flip bit.  The draws come from an explicit
``torch.Generator``, or are passed in (``offsets``, ``flips``) so that a
test can feed both packages the same draw.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def draw_crop_flip(generator: torch.Generator, batch_shape, padding: int = 4,
                   device=None):
    """``(offsets (*batch, 2) int64 in [0, 2 * padding], flips (*batch,)
    bool)`` for :func:`random_crop_flip`."""
    batch_shape = tuple(batch_shape)
    offs = torch.randint(0, 2 * padding + 1, batch_shape + (2,),
                         generator=generator, device=device)
    flips = torch.rand(batch_shape, generator=generator, device=device) < 0.5
    return offs, flips


def random_crop_flip(x: torch.Tensor, generator: Optional[torch.Generator]
                     = None, padding: int = 4, offsets=None,
                     flips=None) -> torch.Tensor:
    """Per-sample shift-crop with zero padding, then a horizontal flip, of
    NHWC images ``x (*batch, H, W, C)``.  ``offsets (*batch, 2)`` are the
    crop's top-left corner in the padded image, ``flips (*batch,)`` the
    flip bits; without them both are drawn from ``generator``."""
    *batch, h, w, c = x.shape
    if offsets is None or flips is None:
        offsets, flips = draw_crop_flip(generator, batch, padding, x.device)
    xb = x.reshape(-1, h, w, c)
    offs = offsets.reshape(-1, 2).to(device=x.device, dtype=torch.int64)
    flip = flips.reshape(-1).to(device=x.device, dtype=torch.bool)
    padded = F.pad(xb, (0, 0, padding, padding, padding, padding))
    ar_h = torch.arange(h, device=x.device)
    ar_w = torch.arange(w, device=x.device)
    rows = offs[:, :1] + ar_h                            # (B, H)
    cols = offs[:, 1:] + torch.where(flip[:, None], w - 1 - ar_w, ar_w)
    b = torch.arange(xb.shape[0], device=x.device)[:, None, None]
    out = padded[b, rows[:, :, None], cols[:, None, :]]  # (B, H, W, C)
    return out.reshape(x.shape)


AUGMENTATIONS = {None: None, "none": None, "cifar": random_crop_flip}


def get_augmentation(name):
    if callable(name):
        return name
    if name not in AUGMENTATIONS:
        raise KeyError(f"unknown augmentation {name!r}; known: "
                       f"{list(AUGMENTATIONS)}")
    return AUGMENTATIONS[name]
