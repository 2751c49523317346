"""recompute_ms: the device time of the program's ``model.layer`` spans
whose host interval lies inside a ``train.backward`` span (remat's
recompute of a layer's forward; autograd may run it on another thread)
per traced step."""
from bench import spans


def _in_backward(span, all_spans):
    return any(b.name == "train.backward" and b.start <= span.start
               and span.end <= b.end for b in all_spans)


def read(rec):
    return spans.device_ms(rec, "model.layer", _in_backward)
