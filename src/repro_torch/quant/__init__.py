"""Quantization for the approximate multiplier: configs, quantizers and
the quantized linear op ``qdot``."""
from .linear import (QuantizedWeight, fuse_projections, map_quantized,  # noqa: F401
                     prequantize_weights, qdot, qeinsum_heads, walk_dense)
from .quantize import (QuantConfig, dequantize, dequantize_int8,  # noqa: F401
                       fake_quant, quantize_int8, quantize_uint8)
