"""head_ms: the device time of the program's ``model.head`` spans (the
tied output head: the prefill's logits at every position, a decode
step's at one) per traced round."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, "model.head")
