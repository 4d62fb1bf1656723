"""Multi-scale SSIM on the device.

Counterpart of ``twingan_tpu/ops/msssim.py``, with its semantics:
- an 11x11 gaussian window (sigma 1.5), VALID convolution per channel
  (``F.conv2d`` with one group a channel);
- the window shrinks to min(filter_size, H, W) with sigma rescaled;
- biased (moment-difference) covariance estimates;
- 5 levels, weights [0.0448, 0.2856, 0.3001, 0.2363, 0.1333];
- a 2x2 box downsample between levels, dropping an odd last row/column;
- each level clipped to >= 0, the product of cs^w over levels[:-1] times
  ssim^w[-1].
Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    """MATLAB's fspecial('gaussian', ...), as the JAX package builds it."""
    radius = size // 2
    offset = 0.0
    start, stop = -radius, radius + 1
    if size % 2 == 0:
        offset = 0.5
        stop -= 1
    x, y = np.mgrid[offset + start: stop, offset + start: stop]
    g = np.exp(-((x**2 + y**2) / (2.0 * sigma**2)))
    return (g / g.sum()).astype(np.float32)


def _depthwise_valid_conv(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """VALID depthwise 2-D convolution of NHWC ``img`` with a [kh, kw] window."""
    c = img.shape[-1]
    kernel = window.to(img.dtype).expand(c, 1, *window.shape)
    return F.conv2d(img.permute(0, 3, 1, 2), kernel, groups=c).permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 255.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image mean SSIM and contrast sensitivity of NHWC batches."""
    img1, img2 = img1.float(), img2.float()
    _, height, width, _ = img1.shape
    size = min(filter_size, height, width)
    sigma = size * filter_sigma / filter_size if filter_size else 0.0
    if filter_size:
        window = torch.as_tensor(_fspecial_gauss(size, sigma), device=img1.device)
        mu1 = _depthwise_valid_conv(img1, window)
        mu2 = _depthwise_valid_conv(img2, window)
        sigma11 = _depthwise_valid_conv(img1 * img1, window)
        sigma22 = _depthwise_valid_conv(img2 * img2, window)
        sigma12 = _depthwise_valid_conv(img1 * img2, window)
    else:
        mu1, mu2 = img1, img2
        sigma11, sigma22, sigma12 = img1 * img1, img2 * img2, img1 * img2
    mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma11 = sigma11 - mu11
    sigma22 = sigma22 - mu22
    sigma12 = sigma12 - mu12
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma11 + sigma22 + c2
    ssim_map = ((2.0 * mu12 + c1) * v1) / ((mu11 + mu22 + c1) * v2)
    return torch.mean(ssim_map, dim=(1, 2, 3)), torch.mean(v1 / v2, dim=(1, 2, 3))


def box_downsample(img: torch.Tensor) -> torch.Tensor:
    """(a+b+c+d)/4 over 2x2 blocks; drops a trailing odd row/column."""
    h2, w2 = img.shape[1] // 2, img.shape[2] // 2
    img = img[:, : h2 * 2, : w2 * 2, :]
    return (img[:, 0::2, 0::2, :] + img[:, 1::2, 0::2, :]
            + img[:, 0::2, 1::2, :] + img[:, 1::2, 1::2, :]) * 0.25


def msssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 255.0,
           filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
           k2: float = 0.03, levels: int = 5) -> torch.Tensor:
    """Mean MS-SSIM over the batch (a 0-dim tensor on img1's device)."""
    im1, im2 = img1.float(), img2.float().to(img1.device)
    weights = torch.tensor(MSSSIM_WEIGHTS[:levels], dtype=torch.float32, device=im1.device)
    mssim, mcs = [], []
    for _ in range(levels):
        s, cs = ssim(im1, im2, max_val=max_val, filter_size=filter_size,
                     filter_sigma=filter_sigma, k1=k1, k2=k2)
        mssim.append(s)
        mcs.append(cs)
        im1, im2 = box_downsample(im1), box_downsample(im2)
    mssim = torch.clamp(torch.stack(mssim), min=0.0)  # [levels, B]
    mcs = torch.clamp(torch.stack(mcs), min=0.0)
    per_image = (torch.prod(mcs[:-1] ** weights[:-1, None], dim=0)
                 * mssim[-1] ** weights[-1])
    return torch.mean(per_image)
