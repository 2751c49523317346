"""idle_program_ms (idle_program_ms.serve, idle_program_ms.train): the
device's idle time in the harness's traced steps (``decode_step``,
``train_step``) while the program had the step in hand, the host inside
a program span or the device short of a span's end: the device waiting
on the program's launch chain, or between the kernels it queued, in ms
per step (``bench/spans.py``, ``idle_split``)."""
from bench import spans


def read(rec):
    split = spans.idle_split(rec)
    return None if split is None else split["program"]
