"""The encoder-decoder family (whisper-small) against the JAX package, at
smoke size, on the reference's own weights (``T.init_params(PRNGKey(0),
SMOKE)`` carried across with interop.params_from_numpy): the smoke
batches of the two new configs (their CONFIG and SMOKE are held in
tests/test_torch_moe.py with the others'), the encoder tree,
``_run_encoder``, a decoder layer's cross block, forward_train and
serve's encoder frames.  The calibrated serve is held in
tests/test_torch_encdec_serve.py, the VLM in tests/test_torch_vlm.py and
tests/test_torch_vlm_serve.py.

Tolerances, and why (gaps measured on these sizes and inputs):
  * _run_encoder and the cross block, both modes, prequantized weights
    with dynamic activation quantization ('xla': the products exact to
    the multiplier), against the reference run op by op
    (jax.disable_jit): every quantized operand equal (0 steps flipped),
    outputs within OUT_RTOL of their largest magnitude (4 float32 ulps;
    measured 1.7 for the encoder's output, 0.6 for a cross block's:
    torch's softmax and einsum sum in another order than XLA's).
  * forward_train (xla asym_u8, the frontend's 8 frames) against the
    reference run op by op: every product equal on the same operands, 0
    steps flipped, loss within rtol 2e-6 (the op-by-op bounds of
    tests/test_torch_train.py).  With remat on, the loss and every
    gradient equal the run without it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.kernels import ops as rops
from repro.models import layers as rlayers
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import linear as rlin
from repro.quant import prequantize_weights as r_preq
from repro.quant import qdot as r_qdot
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import linear as tlin
from repro_torch.quant import prequantize_weights as t_preq
from repro_torch.train.step import _value_and_grad, make_loss_fn
from test_torch_moe import (MODES, _count_flips, _np,  # noqa: F401
                            _observing, _RecordProducts, _Recorder)

ARCH = "whisper-small"
NEW_CONFIGS = ["whisper-small", "internvl2-76b"]
OUT_RTOL = 4 * 2.0 ** -23      # of an output's largest magnitude


@pytest.fixture(scope="module")
def base():
    cfg_r = rconfigs.get_smoke(ARCH)
    pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    cfg_t = tconfigs.get_smoke(ARCH)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                   device="cpu")
    return cfg_r, cfg_t, pj, pt


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_smoke_batch_draws_the_frontend_as_the_reference(name):
    """Tokens, labels, then the frontend from the same rng: (B, 8, dim)
    encoder frames for encdec, (B, n_prefix, dim) patches for vlm."""
    t = tconfigs.make_smoke_batch(tconfigs.get_smoke(name), 2, 5, seed=3)
    r = rconfigs.make_smoke_batch(rconfigs.get_smoke(name), 2, 5, seed=3)
    assert sorted(t) == sorted(r) == ["frontend", "labels", "tokens"]
    for k in r:
        assert t[k].dtype == r[k].dtype
        np.testing.assert_array_equal(t[k], r[k])


def test_params_carry_across_with_the_encoder_tree(base):
    """The port's own init draws the reference's tree and shapes (the
    encoder's layers, norm and the cross blocks over every decoder layer;
    internvl2's frontend_proj, whisper has none), and params_from_numpy
    refuses a wrong or missing leaf outside the units by its path."""
    for name in NEW_CONFIGS:
        cfg_r, cfg_t = rconfigs.get_smoke(name), tconfigs.get_smoke(name)
        pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
        own = TT.init_params(torch.Generator().manual_seed(0), cfg_t,
                             device="cpu")
        shapes = jax.tree.map(lambda a: tuple(a.shape), pj)
        assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes, name
    cfg_r, cfg_t, pj, pt = base
    assert "frontend_proj" not in pt
    assert tuple(pt["enc"]["cross"]["attn"]["wk"].shape)[0] == cfg_t.n_layers
    assert tuple(pt["enc"]["layers"]["mlp"]["w_up"].shape)[0] == \
        cfg_t.enc_layers
    bad = jax.tree.map(np.asarray, pj)
    bad["enc"]["cross"]["attn"]["wk"] = bad["enc"]["cross"]["attn"]["wk"][
        :, :, :8]
    with pytest.raises(ValueError, match="enc.cross.attn.wk"):
        interop.params_from_numpy(bad, cfg_t, device="cpu")
    cfg_v = tconfigs.get_smoke("internvl2-76b")
    pv = jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(0), rconfigs.get_smoke("internvl2-76b")))
    assert pv["frontend_proj"].shape == (cfg_v.frontend_dim, cfg_v.d_model)
    del pv["frontend_proj"]
    with pytest.raises(ValueError, match="frontend_proj is missing"):
        interop.params_from_numpy(pv, cfg_v, device="cpu")


def _pair(base, mode):
    cfg_r, cfg_t, pj, pt = base
    rq = RQ(design="design2", backend="xla", mode=mode, inference=True)
    tq = TQ(design="design2", backend="xla", mode=mode, inference=True)
    return rq, tq, r_preq(pj, rq), t_preq(pt, tq)


def _close(tag, got, want):
    got, want = _np(got), _np(want)
    gap = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"\n[{tag}] max |gap| {gap:.3e} of max |out| {scale:.3e} "
          f"({int((got != want).sum())} of {want.size} apart)")
    assert gap <= OUT_RTOL * scale, (tag, gap, scale)


@pytest.mark.parametrize("mode", MODES)
def test_encoder_matches_reference(base, mode):
    """_run_encoder over 5 frames: each layer's sites named
    ``enc.layers.<w>@i``, every quantized operand equal, output close."""
    cfg_r, cfg_t = base[0], base[1]
    rq, tq, sj, st = _pair(base, mode)
    fr = np.random.default_rng(7).normal(
        size=(2, 5, cfg_r.d_model)).astype(np.float32)
    with jax.disable_jit(), _observing(rlin, _Recorder()) as rec_r:
        want = RT._run_encoder(sj, jnp.asarray(fr), cfg_r, rq)
    with _observing(tlin, _Recorder()) as rec_t, torch.no_grad():
        got = TT._run_encoder(st, torch.from_numpy(fr), cfg_t, tq)
    assert sorted(rec_t.calls) == sorted(
        f"enc.layers.{w}@{i}" for i in range(cfg_t.enc_layers)
        for w in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_up",
                  "mlp.w_down"))
    flips, total, _ = _count_flips(rec_r.calls, rec_t.calls, static=False)
    print(f"\n[encoder {mode}] {flips} of {total} dynamic steps flipped")
    assert flips == 0
    assert tuple(got.shape) == (2, 5, cfg_t.d_model)
    _close(f"encoder {mode}", got, want)


def _ref_cross_block(xp, x, ctx, cfg, q):
    """The reference's cross block, as its _decoder_stack body runs it
    (src/repro/models/transformer.py)."""
    hc = rlayers.rmsnorm(x, xp["norm"])
    ap = xp["attn"]
    ck = rlayers._split_heads(r_qdot(ctx, ap["wk"], q), cfg.n_kv, cfg.hd)
    cv = rlayers._split_heads(r_qdot(ctx, ap["wv"], q), cfg.n_kv, cfg.hd)
    att, _ = rlayers.attention(ap, hc, None, q, n_heads=cfg.n_heads,
                               n_kv=cfg.n_kv, head_dim=cfg.hd, causal=False,
                               cross_kv=(ck, cv), rope_theta=0.0)
    return x + att


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_cross_block_matches_reference(base, monkeypatch, mode, S):
    """Layer 1's cross block at a decode step (S = 1) and a prefill
    (S = 3) over 6 encoder frames: q from wq, k and v from the encoder
    output, no rope, the all-ones mask, never the decode kernel."""
    cfg_r, cfg_t = base[0], base[1]
    rq, tq, sj, st = _pair(base, mode)
    rng = np.random.default_rng(8 + S)
    x = rng.normal(size=(2, S, cfg_r.d_model)).astype(np.float32)
    ctx = rng.normal(size=(2, 6, cfg_r.d_model)).astype(np.float32)
    xp_r = jax.tree.map(lambda a: a[1], sj["enc"]["cross"])
    xp_t = TT.take_layer(st["enc"]["cross"], 1)

    def refuse(*a, **k):
        raise AssertionError("the cross block reached decode_attention")
    monkeypatch.setattr(tops, "decode_attention", refuse)
    with jax.disable_jit(), _observing(rlin, _Recorder()) as rec_r:
        rec_r.push(1)
        want = _ref_cross_block(xp_r, jnp.asarray(x), jnp.asarray(ctx),
                                cfg_r, rq)
    with _observing(tlin, _Recorder()) as rec_t, torch.no_grad():
        rec_t.push(1)
        got = TT._cross_block(xp_t, torch.from_numpy(x),
                              torch.from_numpy(ctx), cfg_t, tq)
    assert sorted(rec_t.calls) == [f"enc.cross.attn.{w}@1"
                                   for w in ("wk", "wo", "wq", "wv")]
    flips, total, _ = _count_flips(rec_r.calls, rec_t.calls, static=False)
    assert flips == 0, (flips, total)
    _close(f"cross block {mode} S={S}", got, want)


def test_forward_train_matches_reference(base):
    cfg_r, cfg_t, pj, pt = base
    batch = tconfigs.make_smoke_batch(cfg_t, 2, 8, seed=5)
    assert batch["frontend"].shape == (2, 8, cfg_t.d_model)
    rcfg = RQ(design="design2", backend="xla", mode="asym_u8")
    tcfg = TQ(design="design2", backend="xla", mode="asym_u8")
    with jax.disable_jit(), _RecordProducts(rops, np.asarray) as rrec:
        r_loss, _ = RT.forward_train(
            pj, {k: jnp.asarray(v) for k, v in batch.items()}, cfg_r, rcfg)
    with _RecordProducts(tops, lambda t: t.numpy()) as trec:
        t_loss, _ = TT.forward_train(
            pt, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t,
            tcfg)
    # the encoder's 6 projections a layer, the decoder's 6 and 4 cross
    n = 6 * cfg_t.enc_layers + 10 * cfg_t.n_layers
    assert len(trec.calls) == len(rrec.calls) == n
    flips = total = 0
    for (ra, rb), (ta, tb) in zip(rrec.calls, trec.calls):
        np.testing.assert_array_equal(tb, rb)
        flips += int((ta != ra).sum())
        total += ra.size
    print(f"\nwhisper forward_train: {flips} of {total} steps flipped; loss "
          f"{float(t_loss)!r} vs {float(r_loss)!r}")
    assert flips == 0
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=2e-6)


def test_remat_gives_the_same_loss_and_gradients(base):
    """Each decoder layer with its cross block under checkpoint: the
    loss and every gradient (the encoder's through the cross blocks'
    k/v) equal the run without remat."""
    cfg_t, pt = base[1], base[3]
    batch = {k: torch.from_numpy(v) for k, v in tconfigs.make_smoke_batch(
        cfg_t, 2, 8, seed=6).items()}
    tcfg = TQ(design="design2", backend="xla", mode="asym_u8")
    out = {}
    for remat in (False, True):
        loss, _, grads = _value_and_grad(make_loss_fn(cfg_t, tcfg, remat),
                                         pt, batch)
        out[remat] = (loss, grads)
    assert torch.equal(out[True][0], out[False][0])
    g0, g1 = out[False][1], out[True][1]
    assert float(g0["enc"]["layers"]["attn"]["wq"].abs().max()) > 0
    assert float(g0["enc"]["cross"]["attn"]["wk"].abs().max()) > 0
    leaves0 = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), g0))
    leaves1 = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), g1))
    assert len(leaves0) == len(leaves1)
    for a, b in zip(leaves0, leaves1):
        np.testing.assert_array_equal(a, b)


def test_serve_run_encodes_the_frames_it_is_given(monkeypatch):
    """serve.run encodes the requests' frames once, before the warm-up:
    16 a request by default, ``enc_frames`` when given (chip_smoke.py
    serves the config's 1,500 this way)."""
    from repro_torch.launch import serve
    seen = []
    real = TT._run_encoder

    def record(params, frontend, cfg, qcfg):
        seen.append(tuple(frontend.shape))
        return real(params, frontend, cfg, qcfg)
    monkeypatch.setattr(TT, "_run_encoder", record)
    args = serve.build_parser().parse_args(
        ["--arch", ARCH, "--smoke", "--requests", "2", "--prompt-len", "3",
         "--gen-len", "2", "--prequantize", "--device", "cpu"])
    prep = serve.prepare(args)
    d = prep.cfg.d_model
    for frames in (serve.ENC_FRAMES, 40):
        seen.clear()
        r = serve.run(args, prep, enc_frames=frames)
        assert seen == [(2, frames, d)]
        assert r.out.shape == (2, 2) and r.t_encode > 0
