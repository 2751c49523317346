"""optimizer_ms: the device time of the program's ``train.optimizer``
span (the gradients' global norm and AdamW's update) per traced step."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, "train.optimizer")
