"""mfu.train: the traced steps' model operations at the card's peaks over
the traced window, in percent: the forward's approximate products and
their remat recompute at the int8 rate, the straight-through backward's
float32 products, attention and the head at the float32 rate
(bench/arith.py)."""
from bench import arith


def read(rec):
    tr = getattr(rec, "trace", None)
    if tr is None or not getattr(rec, "trace_steps", 0) or tr.window_s <= 0:
        return None
    t = rec.traffic
    w = arith.train_step_least_s(rec.model, t["batch"], t["seq"])
    return 100.0 * (w["proj_s"] + w["f32_s"]) * rec.trace_steps / tr.window_s
