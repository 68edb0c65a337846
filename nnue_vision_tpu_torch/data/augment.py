"""Input normalization (port of `nnue_vision_tpu/data/augment.py:40-50`).

The augmentation tiers come with the training port; serving and evaluation
need only the ImageNet normalization the engine's inputs carry.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std with ImageNet statistics; NHWC float in [0,1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std
