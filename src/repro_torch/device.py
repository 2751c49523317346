"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no
    card is found (the entry points never carry on on the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "the plain PyTorch versions of the kernels")
    return dev


def true_div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v as a correctly rounded division on every device.  PyTorch's
    CUDA kernels turn division by a Python scalar into multiplication by
    its reciprocal, which can be an ulp away from the reference's
    division (and flips a quantized weight where it lands on a .5
    edge); a same-device 0-dim divisor keeps the true division."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)
