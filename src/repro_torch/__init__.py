"""PyTorch/CUDA port of the approximate-multiplier serving stack.

A second package beside the JAX reference (``src/repro``), with the same
layout and names: ``core`` and ``signed`` (the gate-level multipliers,
their tables and error metrics, plain numpy), ``kernels`` (five
hand-written CUDA kernels for Hopper with a plain PyTorch version beside
each), ``quant``, ``models``, ``configs``, ``calib``, ``train``,
``launch`` and ``app`` (the paper's image sharpening, Sobel edge
detection and the rows of its tables).

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
raises when no card is found; the tests pass ``device="cpu"``, where each
kernel wrapper takes its plain version.  The port imports torch and numpy
only.
"""
