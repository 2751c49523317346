"""decode_issue_ms: the mean host duration of the program's ``serve.step``
spans in the traced rounds: the host's time to issue one decode step
(its launch chain), whatever the device is doing meanwhile."""
from bench import spans


def read(rec):
    steps = [s for s in spans.mapped(rec) or [] if s.name == "serve.step"]
    if not steps:
        return None
    return sum(s.end - s.start for s in steps) / len(steps) / 1e3
