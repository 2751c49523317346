"""idle_caller_ms (idle_caller_ms.serve, idle_caller_ms.train): the
device's idle time in the harness's traced steps (``decode_step``,
``train_step``) that ``idle_program_ms`` leaves: no program span open on
the host nor unfinished on the device, so the round trip of the step's
tokens or loss to the caller and the caller's loop, in ms per step
(``bench/spans.py``, ``idle_split``)."""
from bench import spans


def read(rec):
    split = spans.idle_split(rec)
    return None if split is None else split["caller"]
