"""Input normalization on the device (port of
lctvqa/data/pipeline.py::normalize_images).

Images cross to the device as uint8 NHWC, a quarter of the bytes of
fp32, and are normalized there.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(u8: torch.Tensor, mean=IMAGENET_MEAN,
                     std=IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized fp32 NHWC, on u8's device."""
    x = u8.to(torch.float32) / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=u8.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=u8.device)
    return (x - mean_t) / std_t
