"""Image sharpening with approximate multipliers (paper §IV.B, Eq. 12-18).

    S = I + 1.5 (I - B),   B = (G * I) / 273

Every pixel-by-kernel product inside the Gaussian blur goes through the
selected 8x8 approximate multiplier (the paper's methodology), as a
gather from its product table (``kernels.ops.approx_mul``, bit-exact
against the gate-level sim).  PSNR/SSIM compare against the
accurately-sharpened image.

Images go in as uint8 (H, W) tensors or arrays and come back as uint8
tensors on ``device``.  Every sum is exact (integers, or float64 values
whose sums need fewer than 53 bits), so the results do not depend on the
device or the order of summation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve, true_div
from ..kernels import ops

# Paper Eq. 13: 5x5 Gaussian kernel, sum 273
G = np.array([
    [1, 4, 7, 4, 1],
    [4, 16, 26, 16, 4],
    [7, 26, 41, 26, 7],
    [4, 16, 26, 16, 4],
    [1, 4, 7, 4, 1],
], dtype=np.int64)


def as_image(img, dev: torch.device) -> torch.Tensor:
    """A uint8 (H, W) tensor or array as a tensor on ``dev``."""
    t = torch.as_tensor(img)
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError(f"expected a uint8 (H, W) image, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.to(dev)


def pad_edge(x: torch.Tensor, p: int) -> torch.Tensor:
    """np.pad(x, p, mode="edge") for a 2-D tensor of any dtype: rows and
    columns gathered through clamped index vectors."""
    H, W = x.shape
    rows = torch.arange(-p, H + p, device=x.device).clamp_(0, H - 1)
    cols = torch.arange(-p, W + p, device=x.device).clamp_(0, W - 1)
    return x[rows][:, cols]


def blur(img, multiplier: str = "exact", device="cuda") -> torch.Tensor:
    """Gaussian blur via Eq. 14 with the chosen 8x8 multiplier."""
    dev = resolve(device)
    x = as_image(img, dev)
    H, W = x.shape
    pad = pad_edge(x.to(torch.int32), 2)
    # the coefficients stay on the host: a 0-dim tensor reaches a CUDA op
    # as a scalar, where copying G to the card on every call would hold
    # the host until the stream drains (a pageable host-to-device copy)
    g = torch.from_numpy(G.astype(np.int32))
    acc = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for i in range(5):
        for j in range(5):
            acc += ops.approx_mul(pad[i:i + H, j:j + W], g[i, j], multiplier)
    return torch.div(acc, 273, rounding_mode="floor").clamp_(0, 255).to(
        torch.uint8)


def sharpen(img, multiplier: str = "exact", device="cuda") -> torch.Tensor:
    """Eq. 12: S = I + 1.5 (I - B), with B from the approximate blur
    (float64 and half-to-even rounding, as the reference)."""
    dev = resolve(device)
    x = as_image(img, dev)
    b = blur(x, multiplier, dev).double()
    xf = x.double()
    s = xf + 1.5 * (xf - b)
    return torch.round(s).clamp_(0, 255).to(torch.uint8)


def sharpen_float_reference(img, device="cuda") -> torch.Tensor:
    """Pure-float oracle for the exact pipeline."""
    dev = resolve(device)
    x = as_image(img, dev)
    H, W = x.shape
    pad = pad_edge(x, 2).double()
    acc = torch.zeros((H, W), dtype=torch.float64, device=dev)
    for i in range(5):
        for j in range(5):
            acc += pad[i:i + H, j:j + W] * float(G[i, j])
    b = torch.floor(true_div(acc, 273.0)).clamp_(0, 255)
    xf = x.double()
    s = xf + 1.5 * (xf - b)
    return torch.round(s).clamp_(0, 255).to(torch.uint8)


def sq_err_sum(ref, test) -> tuple:
    """(sum of squared differences, count) of two integer images, the sum
    exact in int64 (numpy's float64 mean of the same squares is exact
    too, so the two means agree to the bit)."""
    r = torch.as_tensor(ref)
    d = r.long() - torch.as_tensor(test).to(r.device).long()
    return int((d * d).sum()), d.numel()


def psnr(ref, test) -> float:
    """Eq. 15-16."""
    sse, n = sq_err_sum(ref, test)
    mse = sse / n
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(255.0 / np.sqrt(mse)))


def _windows(x: torch.Tensor, win: int) -> torch.Tensor:
    """The non-overlapping win x win tiles of x that the reference's
    range(0, H - win + 1, win) loops visit, row-major, as rows."""
    nh, nw = x.shape[0] // win, x.shape[1] // win
    t = x[:nh * win, :nw * win].reshape(nh, win, nw, win)
    return t.permute(0, 2, 1, 3).reshape(nh * nw, win * win)


def ssim(ref, test, win: int = 8) -> float:
    """Eq. 17-18, windowed mean implementation (C1/C2 standard).  The
    variances are numpy's two-pass population form written out: with
    integer pixels every step of it is exact, so card, CPU and numpy
    agree to the bit.  The per-window values come to the host for the
    final mean, in numpy's order."""
    r = torch.as_tensor(ref)
    x = _windows(r.double(), win)
    y = _windows(torch.as_tensor(test).to(r.device).double(), win)
    C1, C2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mx = x.mean(1, keepdim=True)
    my = y.mean(1, keepdim=True)
    dx, dy = x - mx, y - my
    vx = (dx * dx).mean(1, keepdim=True)
    vy = (dy * dy).mean(1, keepdim=True)
    cxy = (dx * dy).mean(1, keepdim=True)
    vals = (((2 * mx * my + C1) * (2 * cxy + C2))
            / ((mx ** 2 + my ** 2 + C1) * (vx + vy + C2)))
    return float(np.mean(vals.reshape(-1).cpu().numpy()))


def make_test_images(n: int = 6, size=(128, 96), seed: int = 0):
    """Six synthetic scenes standing in for the Local Image Sharpness
    Database (unavailable offline): gradients, edges, texture, blobs.
    numpy arrays (torch cannot replay np.random.default_rng)."""
    rng = np.random.default_rng(seed)
    H, W = size
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    imgs = []
    for s in range(n):
        base = (
            60 + 60 * np.sin(xx / (4 + 3 * s)) * np.cos(yy / (6 + 2 * s))
            + 50 * ((xx + yy * (s + 1)) % 64 > 32)
            + 30 * np.exp(-((xx - W // 2) ** 2 + (yy - H // 2) ** 2)
                          / (200.0 + 100 * s)))
        base += rng.normal(0, 3, base.shape)
        imgs.append(np.clip(base, 0, 255).astype(np.uint8))
    return imgs
