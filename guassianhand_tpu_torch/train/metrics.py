"""Evaluation metrics (counterpart of ``train/metrics.py``): MSE and PSNR
on the whole image (natural-log formula), SSIM as skimage computes it (a
7 x 7 uniform window with symmetric padding, K1 = 0.01, K2 = 0.03, sample
covariance, the window's border cropped before the mean), and the crop to
the bounding box of ``mask_at_box`` that SSIM is scored on. Plain tensor
functions on (H, W, C) images in [0, 1]."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-10 log10(mse)."""
    return -10.0 * torch.log(mse(pred, target)) / math.log(10.0)


def _pad_symmetric(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """numpy's ``mode="symmetric"``: the edge sample repeated, mirrored."""
    n = x.shape[dim]
    head = x.narrow(dim, 0, pad).flip(dim)
    tail = x.narrow(dim, n - pad, pad).flip(dim)
    return torch.cat([head, x, tail], dim=dim)


def _uniform_filter(img: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Separable mean over a size x size window, symmetric padding:
    (H, W, C) -> (H, W, C), first along H, then along W."""
    pad = size // 2
    x = img.permute(2, 0, 1)[:, None]                       # (C, 1, H, W)
    kernel = torch.full((1, 1, size, 1), 1.0 / size, dtype=img.dtype,
                        device=img.device)
    x = F.conv2d(_pad_symmetric(x, pad, 2), kernel)
    x = F.conv2d(_pad_symmetric(x, pad, 3), kernel.transpose(2, 3))
    return x[:, 0].permute(1, 2, 0)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7) -> torch.Tensor:
    """Mean SSIM of an (H, W, C) pair."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cov_norm = win_size ** 2 / (win_size ** 2 - 1.0)
    ux = _uniform_filter(pred, win_size)
    uy = _uniform_filter(target, win_size)
    uxx = _uniform_filter(pred * pred, win_size)
    uyy = _uniform_filter(target * target, win_size)
    uxy = _uniform_filter(pred * target, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return s[pad:-pad, pad:-pad].mean()


def bbox_crop(img, mask_at_box):
    """``img`` cropped to the bounding rectangle of the boolean mask (the
    whole image where the mask is empty)."""
    ys, xs = np.where(np.asarray(mask_at_box).astype(bool))
    if ys.size == 0:
        return img
    return img[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
