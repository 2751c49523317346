"""Sobel edge detection through the signed approximate multipliers.

The headline application of the sign-focused-compressor line of work
(Krishna et al., arXiv:2510.22674): Sobel kernels have signed
coefficients, so a signed multiplier applies directly instead of the
sign-juggling an unsigned core needs.

    Gx = [[-1,0,1],[-2,0,2],[-1,0,1]],   Gy = Gx^T
    mag = |I * Gx| + |I * Gy|,   edges = mag > threshold

Every pixel-by-coefficient product goes through the selected signed
multiplier (signed.SIGNED_MULTIPLIERS) as a gather from its signed
product table (``kernels.ops.approx_mul(..., signed=True)``, which
applies the +128 index offset), bit-exact against the gate-level sim.
Pixels are recentred to [-128, 127] before the convolution; since the
Sobel kernels sum to zero this leaves the gradients unchanged while
fitting the int8 operand range.

Quality vs. the exact pipeline is reported as edge-map F1 (pixel
agreement on the thresholded maps) and gradient-magnitude PSNR.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve
from ..kernels import ops
from .sharpening import as_image, make_test_images, pad_edge, sq_err_sum

SOBEL_X = np.array([[-1, 0, 1],
                    [-2, 0, 2],
                    [-1, 0, 1]], dtype=np.int64)
SOBEL_Y = SOBEL_X.T


def gradients(img, multiplier: str = "exact", device="cuda"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) int32 Sobel gradients with every product through the
    signed multiplier.  img: uint8 (H, W)."""
    dev = resolve(device)
    x = as_image(img, dev)
    H, W = x.shape
    # zero-sum kernels: recentring pixels to int8 leaves gradients intact
    p = pad_edge(x.to(torch.int32) - 128, 1)
    # host 0-dim coefficients, as in sharpening.blur
    kx = torch.from_numpy(SOBEL_X.astype(np.int32))
    ky = torch.from_numpy(SOBEL_Y.astype(np.int32))
    gx = torch.zeros((H, W), dtype=torch.int32, device=dev)
    gy = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for i in range(3):
        for j in range(3):
            patch = p[i:i + H, j:j + W]
            if SOBEL_X[i, j]:
                gx += ops.approx_mul(patch, kx[i, j], multiplier, signed=True)
            if SOBEL_Y[i, j]:
                gy += ops.approx_mul(patch, ky[i, j], multiplier, signed=True)
    return gx, gy


def magnitude(img, multiplier: str = "exact", device="cuda") -> torch.Tensor:
    """|gx| + |gy| (the standard L1 Sobel magnitude)."""
    gx, gy = gradients(img, multiplier, device)
    return gx.abs() + gy.abs()


def edge_map(img, multiplier: str = "exact", threshold: int = 128,
             device="cuda") -> torch.Tensor:
    """Boolean edge map: Sobel magnitude over the threshold."""
    return magnitude(img, multiplier, device) > threshold


def edge_f1(ref, test) -> float:
    """F1 agreement of two boolean edge maps (1.0 = identical edges)."""
    ref = torch.as_tensor(ref)
    test = torch.as_tensor(test).to(ref.device)
    tp = float(torch.logical_and(ref, test).sum())
    fp = float(torch.logical_and(~ref, test).sum())
    fn = float(torch.logical_and(ref, ~test).sum())
    if tp == 0:
        return 0.0 if (fp or fn) else 1.0
    return 2 * tp / (2 * tp + fp + fn)


def gradient_psnr(ref_mag, test_mag) -> float:
    """PSNR between gradient magnitudes (peak = max exact magnitude)."""
    sse, n = sq_err_sum(ref_mag, test_mag)
    mse = sse / n
    if mse == 0:
        return float("inf")
    peak = float(max(int(torch.as_tensor(ref_mag).max()), 1))
    return float(20 * np.log10(peak / np.sqrt(mse)))


def evaluate(multiplier: str, imgs=None, threshold: int = 128,
             device="cuda") -> Dict[str, float]:
    """Edge-detection quality of a signed design vs the exact pipeline."""
    dev = resolve(device)
    if imgs is None:
        imgs = make_test_images()
    f1s, psnrs = [], []
    for img in imgs:
        ref_mag = magnitude(img, "exact", dev)
        test_mag = magnitude(img, multiplier, dev)
        f1s.append(edge_f1(ref_mag > threshold, test_mag > threshold))
        psnrs.append(gradient_psnr(ref_mag, test_mag))
    return {"edge_F1": float(np.mean(f1s)),
            "grad_PSNR": float(np.mean(psnrs))}
