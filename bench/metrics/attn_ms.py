"""attn_ms: the device time of the program's ``model.attn_core`` spans
(everything of attention between the q/k/v projections and wo: rope, the
cache write, the decode kernel or the prefill's attention) per traced
round."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, "model.attn_core")
