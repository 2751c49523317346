"""proj_ms (proj_ms.serve, proj_ms.train): the device time of the
program's outermost ``quant.qdot`` spans, each a whole projection
(activation quantization, the approximate product, dequantization, and
in training the straight-through product), per traced round or step;
in training the forward's and the remat recompute's."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, "quant.qdot", spans.outermost)
