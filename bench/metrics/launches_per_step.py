"""launches_per_step: device kernels (copies and sets left out) that start
while the host is inside a traced decode step, per decode step.  A step
ends with its tokens on the host, so its kernels have all run by then."""


def read(rec):
    tr = getattr(rec, "trace", None)
    if tr is None:
        return None
    steps = sum(1 for n, _, _ in tr.host_ranges if n == "decode_step")
    if not steps:
        return None
    return len(tr.kernels_in("decode_step")) / steps
