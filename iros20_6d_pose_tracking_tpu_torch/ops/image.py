"""cv2-compatible image ops in PyTorch: Gaussian blur, HSV conversion, and
the grayscale morphology, median and bilateral filters of depth hole
filling.

Counterpart of ``iros20_6d_pose_tracking_tpu/ops/image.py``:

  - ``resize_nearest``: cv2 INTER_NEAREST, source index
    ``(dst * src_size) // dst_size`` (``ops/roi.crop_resize_nearest`` over
    the whole image);
  - ``gaussian_blur``: the cv2.getGaussianKernel taps, BORDER_REFLECT_101
    padding, a horizontal then a vertical pass of shifted adds in the JAX
    module's order;
  - ``rgb_to_hsv`` / ``hsv_to_rgb``: cv2's uint8 scaling, H in [0, 180),
    S and V in [0, 255] (the training augmentation, reference
    data_augmentation.py);
  - ``dilate`` / ``erode`` / ``morph_close`` / ``median_blur`` /
    ``bilateral_filter``: single-channel (H, W) filters over shifted
    slices, in the JAX module's tap order (``ops/depthproc.fill_depth``).
    Max, min and sort are exact, so the first four give JAX's values; the
    bilateral filter's ``exp`` may round differently.

Images are ``(..., H, W)``, or ``(..., H, W, C)`` with ``channels_last``;
leading axes are a batch (the blur and HSV ops).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from .roi import crop_resize_nearest


def resize_nearest(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_NEAREST resize of an (H, W) or (H, W, C) image to
    ``out_hw``: the crop-resize of the whole image."""
    zero = torch.zeros((), dtype=torch.int32, device=img.device)
    return crop_resize_nearest(img, zero, zero, zero + img.shape[0],
                               zero + img.shape[1], out_hw)


def gaussian_kernel_1d(ksize: int, sigma: float,
                       device=None) -> torch.Tensor:
    """cv2.getGaussianKernel: normalized taps (float32). For sigma <= 0 cv2
    uses sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) * 0.5
    xs = torch.arange(ksize, dtype=torch.float32, device=device) - half
    k = torch.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def _reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a reflect-101 padded axis of length n (no edge
    repeat: ``dcb|abcd|cba``)."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _reflect101_pad(img: torch.Tensor, pad: int, axes) -> torch.Tensor:
    """Reflect-101 pad of ``pad`` on each of ``axes``."""
    for a in axes:
        img = img.index_select(a, _reflect101_index(img.shape[a], pad,
                                                    img.device))
    return img


def _spatial_axes(img: torch.Tensor, channels_last: bool):
    nd = img.dim()
    return (nd - 3, nd - 2) if channels_last else (nd - 2, nd - 1)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float,
                  channels_last: bool = False) -> torch.Tensor:
    """Separable Gaussian blur, cv2.GaussianBlur-compatible (reflect-101
    borders). ``img`` is ``(..., H, W)`` float, or ``(..., H, W, C)`` with
    ``channels_last``; any leading axes are a batch."""
    ay, ax = _spatial_axes(img, channels_last)
    k = gaussian_kernel_1d(ksize, sigma, img.device)
    pad = ksize // 2
    x = _reflect101_pad(img.to(torch.float32), pad, (ay, ax))
    H, W = img.shape[ay], img.shape[ax]
    acc = None
    for i in range(ksize):
        sl = x.narrow(ax, i, W) * k[i]
        acc = sl if acc is None else acc + sl
    x = acc
    acc = None
    for i in range(ksize):
        sl = x.narrow(ay, i, H) * k[i]
        acc = sl if acc is None else acc + sl
    return acc


def gaussian_blur_select(img: torch.Tensor, ksizes: tuple[int, ...],
                         idx: torch.Tensor, sigma: float,
                         channels_last: bool = False) -> torch.Tensor:
    """Per-sample blur with a kernel size picked from a static bank:
    ``img`` (N, ...) and ``idx`` (N,) int. Every size of the bank is applied
    to the whole batch and each sample keeps its own (the JAX module's
    ``lax.switch`` under ``vmap`` evaluates every branch the same way)."""
    out = img.to(torch.float32)
    shape = (-1,) + (1,) * (img.dim() - 1)
    for j, k in enumerate(ksizes):
        out = torch.where((idx == j).reshape(shape),
                          gaussian_blur(img, k, sigma, channels_last), out)
    return out


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """cv2 COLOR_RGB2HSV on uint8-scaled floats (..., 3): H in [0, 180),
    S and V in [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    safe_diff = torch.where(diff > 0, diff, 1.0)
    s = torch.where(v > 0, diff / torch.clamp(v, min=1e-12) * 255.0, 0.0)
    h = torch.where(
        v == r, 60.0 * (g - b) / safe_diff,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe_diff,
                    240.0 + 60.0 * (r - g) / safe_diff))
    h = torch.where(diff > 0, h, 0.0)
    h = torch.where(h < 0, h + 360.0, h) * 0.5
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv`."""
    h = torch.remainder(hsv[..., 0] * 2.0, 360.0)
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2]
    hp = h / 60.0
    i = torch.remainder(torch.floor(hp).to(torch.int32), 6)
    f = hp - torch.floor(hp)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    choices = ((v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))
    out = []
    for ch in choices:
        c = ch[5]
        for j in range(4, -1, -1):
            c = torch.where(i == j, ch[j], c)
        out.append(c)
    return torch.stack(out, dim=-1)


# --- grayscale morphology (building blocks of depth hole filling) ----------

def _edge_pad(img: torch.Tensor, p: int) -> torch.Tensor:
    """(H, W) padded by ``p`` on every side with its edge values
    (BORDER_REPLICATE), any dtype."""
    H, W = img.shape
    rows = torch.arange(-p, H + p, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-p, W + p, device=img.device).clamp(0, W - 1)
    return img.index_select(0, rows).index_select(1, cols)


def dilate(img: torch.Tensor, kernel) -> torch.Tensor:
    """Grayscale dilation of an (H, W) image with a binary structuring
    element (cv2.dilate), float32, BORDER_CONSTANT with the float32 minimum
    as the border. ``kernel``: 2-D array of {0, 1}."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    neg = torch.finfo(torch.float32).min
    x = F.pad(img.to(torch.float32), (pw, pw, ph, ph), value=neg)
    H, W = img.shape
    out = torch.full(img.shape, neg, dtype=torch.float32, device=img.device)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j]:
                out = torch.maximum(out, x[i:i + H, j:j + W])
    return out


def erode(img: torch.Tensor, kernel) -> torch.Tensor:
    """Grayscale erosion: ``-dilate(-img)``."""
    return -dilate(-img, kernel)


def morph_close(img: torch.Tensor, kernel) -> torch.Tensor:
    """Closing: dilation, then erosion, with the same element."""
    return erode(dilate(img, kernel), kernel)


def median_blur(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """cv2.medianBlur of an (H, W) image (BORDER_REPLICATE): the middle of
    the sorted ``ksize``^2 taps."""
    p = ksize // 2
    x = _edge_pad(img, p)
    H, W = img.shape
    taps = torch.stack([x[i:i + H, j:j + W] for i in range(ksize)
                        for j in range(ksize)], dim=-1)
    return torch.sort(taps, dim=-1).values[..., (ksize * ksize) // 2]


def bilateral_filter(img: torch.Tensor, d: int, sigma_color: float,
                     sigma_space: float) -> torch.Tensor:
    """cv2.bilateralFilter of a single-channel (H, W) float image
    (BORDER_REPLICATE) over the circular neighbourhood of radius d // 2:
    the taps in the JAX module's order, each spatial weight a host
    ``math.exp``."""
    radius = d // 2
    x = _edge_pad(img, radius)
    H, W = img.shape
    num = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    den = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    inv2sc = -0.5 / (sigma_color * sigma_color)
    inv2ss = -0.5 / (sigma_space * sigma_space)
    for i in range(d):
        for j in range(d):
            dy, dx = i - radius, j - radius
            if dy * dy + dx * dx > radius * radius + 1e-9 and d > 1:
                continue
            tap = x[i:i + H, j:j + W]
            ws = math.exp((dy * dy + dx * dx) * inv2ss)
            diff = tap - img
            w = ws * torch.exp(diff * diff * inv2sc)
            num = num + w * tap
            den = den + w
    return num / torch.clamp(den, min=1e-12)
