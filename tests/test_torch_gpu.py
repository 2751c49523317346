"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``gpu``; each test skips without one).  Run there with

    python -m pytest -m gpu tests/test_torch_gpu.py

Shapes are small and ragged here; chip_smoke.py repeats the checks at the
serving and training paths' full-width shapes.  Tolerances are those of
repro_torch.kernels.check.
"""
import pytest
import torch

from repro_torch.kernels import check, ops

pytestmark = pytest.mark.gpu

MODES = [False, True]          # signed: asym_u8, sym_i8


@pytest.fixture
def cuda():
    """The card, decided when a test runs (never at import, so every
    worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("shape", [(4, 2048, 1024), (1, 1, 1), (5, 77, 131),
                                   (37, 300, 520), (256, 64, 48)])
def test_delta_kernel_matches_plain(cuda, signed, shape):
    check.check_delta(check.delta_case(*shape, signed, sum(shape), cuda))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 17])
@pytest.mark.parametrize("K", [1, 31, 33, 6144])
@pytest.mark.parametrize("N", [1, 131, 1024])
def test_delta_kernel_split_k_is_bit_exact_and_repeatable(cuda, signed, M,
                                                          K, N):
    """M <= 4 takes the split-K schedule (64-deep k chunks spread over the
    SMs, partial sums added atomically), M > 4 the tile schedule; K ragged
    against the chunk and the 32-deep stage.  Bit-equal to the plain
    version, and two launches bit-equal to each other.  Each launch gets
    its output from torch.empty right after a block of the same size held
    garbage, which the launcher must clear before the atomic adds."""
    case = check.delta_case(M, K, N, signed, M * K + N, cuda)

    def garbage():    # freed at once: the caching allocator reuses it
        torch.full((M, N), -7, dtype=torch.int32, device=cuda)

    garbage()
    check.check_delta(case)
    garbage()
    first = ops.delta_matmul(**case)
    garbage()
    assert torch.equal(first, ops.delta_matmul(**case))


@pytest.mark.parametrize("signed", MODES)
def test_delta_kernel_exhaustive_pairs(cuda, signed):
    vals = torch.arange(-128, 128) if signed else torch.arange(256)
    a = vals.to(torch.int32)[:, None].contiguous().to(cuda)
    b = vals[None, :].to(torch.int8 if signed else torch.uint8).to(cuda)
    case = check.delta_case(1, 1, 1, signed, 0, cuda)
    check.check_delta(dict(case, a=a, b=b.contiguous()))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("compensate", [False, True])
@pytest.mark.parametrize("shape", [(4, 256, 384), (3, 77, 131),
                                   (70, 200, 24)])
def test_fused_kernel_matches_plain(cuda, signed, compensate, shape):
    check.check_fused(check.fused_case(*shape, signed, sum(shape), cuda,
                                       compensate=compensate))


DECODE_SHAPES = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048)]
TRAIN_SHAPES = [(2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048)]


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("compensate", [False, True])
@pytest.mark.parametrize("M", [1, 2, 3, 4])
@pytest.mark.parametrize("K,N", DECODE_SHAPES + [(77, 131)])
def test_fused_split_k_is_exact_and_repeatable(cuda, signed, compensate, M,
                                               K, N):
    """M <= 4 takes the split-K schedule: the quantize pre-pass, then
    64-deep k chunks spread over the SMs whose partials meet by atomicAdd,
    and the CTA that brings a tile's last chunk runs the epilogue.  At the
    four merged decode projections of qwen3-1.7b and a ragged shape: qx
    and acc bit-exact, out bit-equal to the plain version without
    compensation (within check.FUSED_RTOL with it), and two launches
    bit-equal in every output.  Each launch's scratch comes from the
    caching allocator right after a block of the same size held garbage,
    which the pre-pass must clear before the atomic adds."""
    case = check.fused_case(M, K, N, signed, M * K + N, cuda,
                            compensate=compensate)
    nbytes = ops.fused_scratch_layout(M, K, N)["bytes"]

    def garbage():    # freed at once: the caching allocator reuses it
        torch.full((nbytes,), 0x7F, dtype=torch.uint8, device=cuda)

    garbage()
    check.check_fused(case)
    garbage()
    first = ops.fused_qdot_packed(**case, return_int=True)
    garbage()
    second = ops.fused_qdot_packed(**case, return_int=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("K,N", DECODE_SHAPES)
def test_fused_tile_prefill_shapes(cuda, signed, K, N):
    """M > 4 takes the tile schedule (32 x 128 tiles over a persistent
    grid) on the pre-pass's bytes: the prefill's M = 256 at the merged
    projections, with compensation, repeatable."""
    case = check.fused_case(256, K, N, signed, K + N, cuda)
    check.check_fused(case)
    first = ops.fused_qdot_packed(**case, return_int=True)
    for a, b in zip(first, ops.fused_qdot_packed(**case, return_int=True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("hd,qk_norm", [(128, True), (16, True),
                                        (64, False)])
def test_attention_kernel_matches_plain(cuda, per_slot, window, hd,
                                        qk_norm):
    check.check_attention(check.attention_case(
        3, 21, 8, 4, hd, hd + per_slot, cuda, per_slot=per_slot,
        window=window, qk_norm=qk_norm))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    case = check.delta_case(4, 64, 32, False, 0, cuda)
    with pytest.raises(ValueError, match="int16"):
        ops.delta_matmul(case["a"], case["b"], case["dlut"].to(torch.int32))
    with pytest.raises(ValueError, match="uint8 with offset 0"):
        ops.delta_matmul(case["a"], case["b"], case["dlut"], offset=128)
    with pytest.raises(ValueError, match="contiguous"):
        ops.delta_matmul(case["a"].t().contiguous().t(), case["b"],
                         case["dlut"])
    f = check.fused_case(4, 64, 32, True, 0, cuda)
    with pytest.raises(ValueError, match="int8"):
        ops.fused_qdot_packed(f["x"], f["qw"].to(torch.uint8), f["dlut"],
                              f["scal"], f["ntab"], f["comp_r"], signed=True)


@pytest.mark.parametrize("mode", ["asym_u8", "sym_i8"])
def test_prequantize_card_matches_cpu(cuda, mode):
    """Weight quantization on the card equals the CPU's (and so the
    reference's): scales divide as the reference does, never as a
    multiply by a reciprocal."""
    from repro_torch.quant import QuantConfig, quantize
    from repro_torch.quant.linear import _quantize_weight
    w = torch.randn((3, 2048, 6144), generator=torch.Generator().manual_seed(0))
    w = w / 2048 ** 0.5
    cfg = QuantConfig(mode=mode)
    on_cpu = _quantize_weight(w, cfg)
    on_card = _quantize_weight(w.to(cuda), cfg)
    for f in ("q", "scale", "zp", "colsum"):
        a, b = getattr(on_cpu, f), getattr(on_card, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b.cpu()), f
    x = torch.randn((4, 1, 2048), generator=torch.Generator().manual_seed(1))
    quant = (quantize.quantize_int8 if mode == "sym_i8"
             else quantize.quantize_uint8)
    for a, b in zip(quant(x), quant(x.to(cuda))):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("mode", ["asym_u8", "sym_i8"])
def test_smoke_serve_matches_cpu_launch_by_launch(cuda, mode):
    """The whole calibrated serving path at smoke size on the card: every
    kernel launch equals its plain version run on the CPU from the same
    inputs (check.CpuShadow).  Free-running card and CPU runs are not
    compared: float-ulp differences of PyTorch's CPU and CUDA glue ops
    may flip a static quantization step, which the model amplifies."""
    from repro_torch.launch import serve
    argv = ["--smoke", "--requests", "2", "--prompt-len", "5", "--gen-len",
            "4", "--calibrate", "1", "--quant-mode", mode]
    with check.CpuShadow() as sh:
        serve.run(serve.build_parser().parse_args(argv))
    assert all(st["calls"] > 0 for st in sh.stats.values()), sh.stats


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("design", ["design2", "exact"])
@pytest.mark.parametrize("shape", [(4, 2048, 1024), (1, 1, 1), (5, 77, 131),
                                   (77, 131, 45), (130, 300, 520)])
def test_lut_kernel_matches_plain(cuda, signed, design, shape):
    check.check_lut(check.lut_case(*shape, signed, sum(shape), cuda,
                                   design=design))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("design", ["design2", "exact"])
def test_lut_kernel_exhaustive_pairs(cuda, signed, design):
    """K=1 over every operand pair: the kernel's output is the gate-level
    product table."""
    vals = torch.arange(256, dtype=torch.int32)
    case = check.lut_case(1, 1, 1, signed, 0, cuda, design=design)
    case = dict(case, a=vals[:, None].contiguous().to(cuda),
                b=vals[None, :].to(torch.uint8).contiguous().to(cuda))
    check.check_lut(case)
    got = ops.lut_matmul(**case).cpu().numpy()
    table = (ops.get_signed_lut if signed else ops.get_lut)(design)
    assert (got == table).all()


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("pattern", check.LUT_PATTERNS)
@pytest.mark.parametrize("K,N", TRAIN_SHAPES)
def test_lut_kernel_operand_patterns(cuda, signed, pattern, K, N):
    """The four training projections at M = 512 on each operand pattern
    chip_smoke.py times (uniform, bank-conflict-free, quantized normal),
    through the offset as the 'xla' backend passes them: bit-exact."""
    check.check_lut(check.lut_case(512, K, N, signed, K + N, cuda,
                                   pattern=pattern, shifted=False))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("shape", [(1, 1, 1), (4, 2048, 1024), (5, 77, 131),
                                   (33, 130, 17), (130, 300, 520),
                                   (512, 64, 1000)])
def test_lut_kernel_offset_operands(cuda, signed, shape):
    """Unshifted operands (a int32, b int8 with offset 128 when signed)
    at ragged shapes: bit-exact and repeatable."""
    case = check.lut_case(*shape, signed, sum(shape), cuda, shifted=False)
    check.check_lut(case)
    assert torch.equal(ops.lut_matmul(**case), ops.lut_matmul(**case))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("design", ["design2", "exact"])
def test_lut_kernel_exhaustive_pairs_with_offset(cuda, signed, design):
    """K=1 over every operand pair as the operands come (int8 b and
    offset 128 when signed): the output is the gate-level table."""
    vals = torch.arange(-128, 128) if signed else torch.arange(256)
    case = check.lut_case(1, 1, 1, signed, 0, cuda, design=design,
                          shifted=False)
    case = dict(case, a=vals.to(torch.int32)[:, None].contiguous().to(cuda),
                b=vals[None, :].to(case["b"].dtype).contiguous().to(cuda))
    check.check_lut(case)
    table = (ops.get_signed_lut if signed else ops.get_lut)(design)
    assert (ops.lut_matmul(**case).cpu().numpy() == table).all()


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("rank", [4, 16, 32, 256])
@pytest.mark.parametrize("shape", [(64, 256, 128), (5, 77, 131),
                                   (77, 131, 45)])
def test_residual_kernel_matches_plain(cuda, signed, rank, shape):
    check.check_residual(check.residual_case(*shape, signed, rank,
                                             sum(shape), cuda))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("rank", [1, 4, 32, 256])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 300, 131), (3, 1, 45),
                                   (4, 2048, 1024), (17, 33, 131),
                                   (130, 301, 520)])
def test_residual_kernel_ragged_shapes_and_ranks(cuda, signed, rank, shape):
    """The table-then-gather kernel at every rank it is used with, ragged
    M/K/N (M = 1 and K = 1 included; M <= 4 takes the 4 x 512 tile)."""
    check.check_residual(check.residual_case(*shape, signed, rank,
                                             sum(shape) + rank, cuda))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("M", [3, 40])
def test_residual_kernel_operands_in_one_half_of_the_table(cuda, signed,
                                                           half, M):
    """a's table rows all in one half of C: one of the two sweeps gathers
    nothing, and a CTA's resident half carries over between its tiles."""
    case = check.residual_case(M, 300, 520, signed, 32, half + M, cuda)
    off = case["offset"]
    a = ((case["a"] + off) & 127) + 128 * half - off
    assert bool(((((a + off) & 255) >> 7) == half).all())
    check.check_residual(dict(case, a=a.to(torch.int32).contiguous()))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    case = check.lut_case(4, 64, 32, False, 0, cuda)
    bad = torch.zeros((256, 256), dtype=torch.int32)
    bad[0, 0], bad[1, 1] = -1, 40000
    with pytest.raises(ValueError, match="neither uint16 nor int16"):
        ops.narrow_lut(bad.to(cuda))
    with pytest.raises(ValueError, match="must be int16"):
        ops.lut_matmul(case["a"], case["b"], bad.to(cuda), True)
    with pytest.raises(ValueError, match="uint8"):
        ops.lut_matmul(case["a"], case["b"].to(torch.int32), case["lut"],
                       case["unsigned"])
    with pytest.raises(ValueError, match="int8 with offset 128"):
        ops.lut_matmul(case["a"], case["b"].to(torch.int8), case["lut"],
                       case["unsigned"])
    r = check.residual_case(4, 64, 32, True, 8, 0, cuda)
    with pytest.raises(ValueError, match="int8 with offset 128"):
        ops.residual_matmul(r["a"], r["b"].to(torch.uint8), r["F"], r["G"],
                            offset=128)
    with pytest.raises(ValueError, match="factors"):
        ops.residual_matmul(r["a"], r["b"], r["F"][:, :4], r["G"],
                            offset=128)


@pytest.mark.parametrize("backend,mode", [("xla", "asym_u8"),
                                          ("residual", "sym_i8")])
def test_smoke_train_step_matches_cpu_launch_by_launch(cuda, backend, mode):
    """One smoke train step on the card, remat on, two microbatches:
    every lut_matmul / residual_matmul launch equals its plain version
    run on the CPU from the same inputs (check.CpuShadow), and the launch
    count is the path's: 7 projections x layers x (forward + recompute)
    per microbatch."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_mod
    cfg = configs.get_smoke("qwen3-1.7b")
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           device=cuda)
    ocfg = OptConfig(compress_grads=True)
    step = make_train_step(cfg, QuantConfig(backend=backend, mode=mode),
                           ocfg, microbatches=2, remat=True)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 17), generator=g)
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
    name = "lut_matmul" if backend == "xla" else "residual_matmul"
    ops.reset_launches()
    with check.CpuShadow(check.CpuShadow.TRAIN) as sh:
        _, _, metrics = step(params, opt_mod.init(params, ocfg), batch)
    assert sh.stats[name]["calls"] == 7 * cfg.n_layers * 2 * 2
    assert ops.LAUNCHES[name] == sh.stats[name]["calls"]
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(
        metrics["grad_norm"])
