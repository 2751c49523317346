"""decode_step_ms: the window's decode time over its decode steps, each
step from the last tokens on the host to the next."""


def read(rec):
    rounds = getattr(rec, "rounds", None)
    steps = sum(len(r.times) - 1 for r in rounds or [])
    if not steps:
        return None
    return 1e3 * sum(r.times[-1] - r.t_first for r in rounds) / steps
