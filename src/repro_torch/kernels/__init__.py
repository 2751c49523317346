"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the wrappers that choose between them by device (``ops``)."""
