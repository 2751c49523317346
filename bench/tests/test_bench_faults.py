"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's serving step at smoke size on
the CPU; the rest of the run (window, sampled round, reference, limits)
is the harness's own.  The limits here are smoke-size ones: a sound run
at this size reads 0 and about 1e-7 (one thread), the faults read far
above them.  ``head_bf16`` is a precision fault: the step's logits from
a head whose operands are rounded to bfloat16."""
import numpy as np
import pytest
import torch

from _smoke import run_cell

SMOKE_LIMITS = {"cache_err": 0.01, "gap": 0.02, "head_err": 1e-5}


def _patch_step(monkeypatch, kind, wrap):
    orig = kind.Program.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.step = wrap(self.step)

    monkeypatch.setattr(kind.Program, "__init__", init)


def _state_unchanged(step):
    def bad(params, state, tok):
        nt, lg, _ = step(params, state, tok)
        return nt, lg, state                  # the cache position stays
    return bad


def _token_altered(step):
    calls = {"n": 0}

    def bad(params, state, tok):
        nt, lg, st = step(params, state, tok)
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            nt = nt.clone()
            nt[0] = (nt[0] + 1) % lg.shape[-1]
        return nt, lg, st
    return bad


def _half_batch(step):
    def bad(params, state, tok):
        nt, lg, st = step(params, state, tok)
        h = (nt.shape[0] + 1) // 2            # the rest copies the first
        nt, lg = nt.clone(), lg.clone()
        nt[h:] = nt[:1]
        lg[h:] = lg[:1]
        return nt, lg, st
    return bad


def _head_bf16(step):
    def bad(params, state, tok):
        nt, lg, st = step(params, state, tok)
        # the head's input again, from the float32 logits (least squares)
        E = params["embed"]
        x = torch.linalg.lstsq(E.double(), lg[:, -1].double().T).solution.T
        lg = lg.clone()
        lg[:, -1] = (x.to(torch.bfloat16) @ E.to(torch.bfloat16).T).float()
        return nt, lg, st
    return bad


FAULTS = {"state_unchanged": _state_unchanged,
          "token_altered": _token_altered, "half_batch": _half_batch,
          "head_bf16": _head_bf16}


def test_sound_run_is_correct():
    _, out = run_cell("minitron-8b.eval-prompt", limits=SMOKE_LIMITS)
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, fault):
    from bench import harness
    kind = harness.Workload("minitron-8b.eval-prompt").kind()
    _patch_step(monkeypatch, kind, FAULTS[fault])
    _, out = run_cell("minitron-8b.eval-prompt", limits=SMOKE_LIMITS,
                      kind=kind)
    print(fault, out["checks"])
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
