"""prefill_ms: the mean, over the window's rounds, of the host time from a
round's start (a fresh decode state, the prompts sent) through its
prefill to the first tokens on the host."""


def read(rec):
    rounds = getattr(rec, "rounds", None)
    if not rounds:
        return None
    return 1e3 * sum(r.t_first - r.t_start for r in rounds) / len(rounds)
