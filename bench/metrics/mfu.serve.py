"""mfu.serve: the traced rounds' model operations at the card's peaks over
the traced window, in percent: the approximate 8x8 products at the int8
rate, attention and the head (at the positions that choose a token) at
the float32 rate (bench/arith.py)."""
from bench import arith


def read(rec):
    tr = getattr(rec, "trace", None)
    if tr is None or tr.window_s <= 0:
        return None
    t = rec.traffic
    w = arith.serve_round_least_s(rec.model, t["batch"], t["prompt_len"],
                                  t["gen_len"])
    return 100.0 * (w["proj_s"] + w["f32_s"]) * rec.trace_rounds / tr.window_s
