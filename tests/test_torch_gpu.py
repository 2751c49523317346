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
# minitron-8b's merged projections at 48 query heads: wqkv, wo, w_up, w_down
MINITRON_SHAPES = [(4096, 8192), (6144, 4096), (4096, 16384), (16384, 4096)]


def _schedule_of(M):
    return "fused_qdot." + ("splitk4" if M <= 4 else "splitk8"
                            if M <= ops.FUSED_SPLIT_MAX_ROWS else "tile")


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("compensate", [False, True])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("K,N", DECODE_SHAPES + [(77, 131)]
                         + MINITRON_SHAPES)
def test_fused_split_k_is_exact_and_repeatable(cuda, signed, compensate, M,
                                               K, N):
    """M <= 8 takes the split-K schedule (4 rows a thread at M <= 4, 8 at
    M 5-8): the quantize pre-pass, then k chunks (64-deep at 4 rows,
    128-deep at 8) spread over the SMs whose partials meet by atomicAdd,
    and the CTA that brings a tile's last chunk runs the epilogue.  At
    the four merged decode projections of qwen3-1.7b and of minitron-8b
    (48 heads) and a ragged shape: qx and acc bit-exact, out bit-equal to
    the plain version without compensation (within check.FUSED_RTOL with
    it), and two launches bit-equal in every output; every call counted
    in ops.SCHEDULES under the schedule its launcher reports.  Each
    launch's scratch comes from the caching allocator right after a
    block of the same size held garbage, which the pre-pass must clear
    before the atomic adds."""
    case = check.fused_case(M, K, N, signed, M * K + N, cuda,
                            compensate=compensate)
    nbytes = ops.fused_scratch_layout(M, K, N)["bytes"]

    def garbage():    # freed at once: the caching allocator reuses it
        torch.full((nbytes,), 0x7F, dtype=torch.uint8, device=cuda)

    before = ops.SCHEDULES.copy()
    garbage()
    check.check_fused(case)
    garbage()
    first = ops.fused_qdot_packed(**case, return_int=True)
    garbage()
    second = ops.fused_qdot_packed(**case, return_int=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert ops.SCHEDULES - before == {_schedule_of(M): 3}


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("M,K,N", [(256, K, N) for K, N in DECODE_SHAPES]
                         + [(9, 16384, 4096)])
def test_fused_tile_prefill_shapes(cuda, signed, M, K, N):
    """M > 8 takes the tile schedule (32 x 128 tiles over a persistent
    grid) on the pre-pass's bytes: the prefill's M = 256 at the merged
    projections, and M = 9 (one row past split-K) at minitron-8b's
    w_down, with compensation, repeatable, counted as tile."""
    case = check.fused_case(M, K, N, signed, K + N, cuda)
    before = ops.SCHEDULES.copy()
    check.check_fused(case)
    first = ops.fused_qdot_packed(**case, return_int=True)
    for a, b in zip(first, ops.fused_qdot_packed(**case, return_int=True)):
        assert torch.equal(a, b)
    assert ops.SCHEDULES - before == {"fused_qdot.tile": 3}


# the MoE family: routers (K, E) and experts (K, N) of mixtral-8x7b and
# llama4-scout-17b-a16e; decode and prefill capacities of an expert
ROUTER_SHAPES = [(4096, 8), (5120, 16)]
EXPERT_SHAPES = [(4096, 14336), (14336, 4096), (5120, 8192), (8192, 5120)]


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("compensate", [False, True])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 20, 80, 256])
@pytest.mark.parametrize("K,N", ROUTER_SHAPES)
def test_fused_router_shapes_on_both_schedules(cuda, signed, compensate, M,
                                               K, N):
    """The MoE routers: N = 8 and 16 columns, far under one 128-column
    tile, so every column past N is masked, on the split-K schedule (M <=
    8: 4 and 8 rows a thread) and the tile schedule (prefill); exact and
    repeatable."""
    case = check.fused_case(M, K, N, signed, M + K + N, cuda,
                            compensate=compensate)
    check.check_fused(case)
    first = ops.fused_qdot_packed(**case, return_int=True)
    for a, b in zip(first, ops.fused_qdot_packed(**case, return_int=True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("M", [4, 20, 80])
@pytest.mark.parametrize("K,N", EXPERT_SHAPES)
def test_fused_expert_shapes(cuda, signed, M, K, N):
    """An expert's projections at its decode capacity (4 rows) and at
    prefill capacities (20: scout, 80: mixtral), with compensation."""
    check.check_fused(check.fused_case(M, K, N, signed, M + K, cuda))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("M", [4, 80])
@pytest.mark.parametrize("K,N", EXPERT_SHAPES[:1] + EXPERT_SHAPES[2:3])
def test_fused_degenerate_activation_scale(cuda, signed, M, K, N):
    """A static scale of 1e-8 (calibration's floor, for an expert that saw
    only padding rows): every nonzero entry lands on an end of the grid,
    zero entries on the zero point, as in the plain version."""
    check.check_fused(check.fused_case(M, K, N, signed, 7 + M, cuda,
                                       sx=1e-8))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("K,N", ROUTER_SHAPES + EXPERT_SHAPES)
def test_delta_kernel_calibration_moe_shapes(cuda, signed, K, N):
    """Calibration's unfused products at the MoE shapes, M = 4 rows."""
    check.check_delta(check.delta_case(4, K, N, signed, K + N, cuda))


@pytest.mark.parametrize("H,Kv,window,S,pos", [
    (32, 8, 4096, 4608, [4095, 4096, 4300, 4607]),   # mixtral, past the window
    (32, 8, 4096, 80, [64, 70, 75, 79]),
    (40, 8, None, 80, [64, 70, 75, 79]),               # scout: group 5
    (40, 8, None, 66, [0, 1, 33, 65])])
def test_attention_kernel_moe_groups(cuda, H, Kv, window, S, pos):
    """Query groups of 4 and 5, head_dim 128, qk-norm off (the MoE
    configs), mixtral's sliding window of 4096 with positions past it;
    the step and the append."""
    case = check.attention_case(4, S, H, Kv, 128, H + S, cuda,
                                qk_norm=False, window=window, pos=pos)
    check.check_attention(case)
    check.check_attention_append(case)


def test_moe_top_k_ties_on_the_card(cuda):
    """The router's top-k on the card: a stable descending sort, so a tie
    goes to the lower expert index as on the CPU (and in jax.lax.top_k)."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(0)
    probs = torch.randint(0, 3, (4096, 16), generator=g).float()
    for k in (1, 2):
        want = moe.select_top_k(probs, k)
        got = moe.select_top_k(probs.to(cuda), k)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("T,k,E", [(256, 2, 8), (256, 1, 16), (4, 2, 8),
                                   (4, 1, 16)])
def test_moe_dispatch_and_combine_on_the_card(cuda, T, k, E):
    """The MoE glue between the kernels at the full-width shapes (D =
    4096): the dispatch table, keep mask and slots, and the combine's
    index_add_ (atomic adds on the card; at most two terms a token onto
    zero), bit-equal to the CPU's, capacity drops included."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(T + k + E)
    C = moe.capacity(T, k, E)
    # a lopsided choice of experts, so the first ones overflow
    idx = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    idx = torch.where(torch.rand((T, 1), generator=g) < 0.5,
                      torch.arange(k)[None, :].expand(T, k), idx)
    w = torch.rand((T, k), generator=g)
    ye = torch.randn((E, C, 4096), generator=g)
    table, keep, slot = moe.dispatch(idx, E, C)
    assert not bool(keep.all()) or T <= 4
    got = moe.dispatch(idx.to(cuda), E, C)
    for a, b in zip(got, (table, keep, slot)):
        assert torch.equal(a.cpu(), b)
    want = moe.combine(ye, table, idx, slot, w * keep, T)
    out = moe.combine(ye.to(cuda), got[0], idx.to(cuda), got[2],
                      (w * keep).to(cuda), T)
    assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_moe_layer_serve_matches_cpu_launch_by_launch(cuda, arch):
    """One MoE layer of each config (smoke widths) served calibrated on
    the card: every kernel launch equals its plain version on the CPU
    from the same inputs (check.CpuShadow), the routers, every expert and
    the shared expert included."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = dataclasses.replace(configs.get_smoke(arch), n_layers=1)
    argv = ["--arch", arch, "--smoke", "--requests", "2", "--prompt-len",
            "5", "--gen-len", "4", "--calibrate", "1"]
    args = serve.build_parser().parse_args(argv)
    with check.CpuShadow() as sh:
        serve.run(args, serve.prepare(args, cfg=cfg))
    assert all(st["calls"] > 0 for st in sh.stats.values()), sh.stats


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("hd,qk_norm", [(128, True), (16, True),
                                        (64, False)])
def test_attention_kernel_matches_plain(cuda, per_slot, window, hd,
                                        qk_norm):
    check.check_attention(check.attention_case(
        3, 21, 8, 4, hd, hd + per_slot, cuda, per_slot=per_slot,
        window=window, qk_norm=qk_norm))


ATTN_EDGE_SHAPES = [   # B, S_max, H, Kv, hd: the path's, ragged, long
    (4, 80, 16, 8, 128), (3, 21, 8, 4, 64), (2, 700, 4, 2, 256),
    (4, 4096, 16, 8, 128)]


@pytest.mark.parametrize("B,S,H,Kv,hd", ATTN_EDGE_SHAPES)
@pytest.mark.parametrize("window", [None, 20])
def test_attention_kernel_at_chunk_edges(cuda, B, S, H, Kv, hd, window):
    """Per-slot positions at 0, S_max-1 and on both sides of every edge of
    the kernel's chunks and of the tiles within them (ops.attention_chunks
    with the card's SM count), B slots a launch; a window of 20 crosses
    chunk edges.  Two launches bit-equal (check_attention)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    edges = check.attention_edge_positions(S, B, Kv, hd, sms)
    case = check.attention_case(B, S, H, Kv, hd, S, cuda, window=window)
    for i in range(0, len(edges), B):
        pos = (edges[i:i + B] + [S - 1] * B)[:B]
        check.check_attention(dict(case, pos=torch.tensor(
            pos, dtype=torch.int32, device=cuda)))


@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("hd", [16, 64, 128, 256, 6, 90])
@pytest.mark.parametrize("S", [1, 33, 300])
def test_attention_kernel_groups_and_head_dims(cuda, group, hd, S):
    """B=1 at every query group the kernel takes and head dims on the
    16-byte path (hd % 8 == 0) and the 4-byte one (6, 90), from a cache
    of one position to several chunks."""
    Kv = 2
    for pos in sorted({0, S // 2, S - 1}):
        check.check_attention(check.attention_case(
            1, S, group * Kv, Kv, hd, group + hd + S, cuda, pos=[pos]))


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("B,S,hd", [(4, 80, 128), (3, 21, 16), (2, 300, 64),
                                    (4, 4096, 128)])
def test_attention_append_path(cuda, per_slot, window, B, S, hd):
    """ops.decode_attention, the kernel with the append: the output
    bit-equal to the step's, row pos of each cache the plain version's
    row (v bit-equal, k within the row tolerance), every other row
    bit-equal to its value before the call."""
    check.check_attention_append(check.attention_case(
        B, S, 16, 8, hd, B + S + hd, cuda, per_slot=per_slot,
        window=window))


@pytest.mark.parametrize("S", [1, 15, 16, 40, 100, 129, 1000, 4096])
def test_attention_kernel_cluster_sizes_and_tiles(cuda, S):
    """One (kv head, slot) pair, so the split takes up to 16 chunks, one
    cluster of that many blocks (1, 2, 5, 12 and 16 here); past 16 chunks
    of 64 rows a chunk is read in several tiles.  Positions at 0, S-1 and
    every chunk and tile edge, and a window that starts past a chunk's
    first tile."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    edges = check.attention_edge_positions(S, 1, 1, 128, sms)
    case = check.attention_case(1, S, 2, 1, 128, S, cuda)
    for window in (None, 20):
        for pos in edges:
            check.check_attention(dict(case, window=window, pos=torch.tensor(
                [pos], dtype=torch.int32, device=cuda)))


@pytest.mark.parametrize("tile", ["past the chunk", "past 48 KiB"])
def test_attention_launcher_refuses_a_tile_it_cannot_take(cuda, monkeypatch,
                                                          tile):
    """The wrapper decides the tile (ops.attention_tile_rows); the
    launcher refuses one longer than a chunk, or one whose shared memory
    exceeds 48 KiB (64 rows at hd 256: 64 KiB of K and V)."""
    bad = (lambda rows, hd: rows + 1) if tile == "past the chunk" else \
        (lambda rows, hd: 64)
    monkeypatch.setattr(ops, "attention_tile_rows", bad)
    case = check.attention_case(1, 4096, 2, 1, 256, 0, cuda)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ops.decode_attention_step(**case)


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
    with pytest.raises(ValueError, match="head_dim 7 must be even"):
        ops.decode_attention_step(**check.attention_case(2, 9, 4, 2, 7, 0,
                                                         cuda))
    a = check.attention_case(2, 9, 4, 2, 16, 0, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.decode_attention_step(**dict(a, k_cache=a["k_cache"].float()))
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention_step(**dict(a, pos=a["pos"].long()))


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


TRAIN_FAMILIES = ["mixtral-8x7b", "llama4-scout-17b-a16e",
                  "recurrentgemma-2b", "xlstm-125m", "whisper-small",
                  "internvl2-76b", "gemma-7b", "minitron-8b"]


@pytest.mark.parametrize("backend,mode", [("xla", "asym_u8"),
                                          ("residual", "sym_i8")])
@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_family_smoke_train_step_matches_cpu_launch_by_launch(cuda, arch,
                                                              backend, mode):
    """One smoke train step of each family on the card, remat on, two
    microbatches (the frontend's frames or patches split with the
    tokens): every lut_matmul / residual_matmul launch equals its plain
    version run on the CPU from the same inputs (check.CpuShadow), and
    the card launches as many as the same step run on the CPU."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_mod
    cfg = configs.get_smoke(arch)
    ocfg = OptConfig(compress_grads=True)
    step = make_train_step(cfg, QuantConfig(backend=backend, mode=mode),
                           ocfg, microbatches=2, remat=True)
    batch = {k: torch.as_tensor(v) for k, v in
             configs.make_smoke_batch(cfg, 4, 16, seed=1).items()}
    name = "lut_matmul" if backend == "xla" else "residual_matmul"
    cpu_calls = []
    orig = getattr(ops, name)

    def count(*a, **k):
        cpu_calls.append(1)
        return orig(*a, **k)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    setattr(ops, name, count)
    try:
        step(params, opt_mod.init(params, ocfg), batch)
    finally:
        setattr(ops, name, orig)
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           device=cuda)
    ops.reset_launches()
    with check.CpuShadow(check.CpuShadow.TRAIN) as sh:
        _, _, metrics = step(params, opt_mod.init(params, ocfg),
                             {k: v.to(cuda) for k, v in batch.items()})
    assert sh.stats[name]["calls"] == len(cpu_calls) > 0
    assert ops.LAUNCHES[name] == sh.stats[name]["calls"]
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(
        metrics["grad_norm"])


# the families' training projections at full width (chip_smoke.py phase
# 18, --batch 4 --seq 128): the MoE experts at their capacity (M = 160
# and 40, a ragged tile of rows), the routers (N = 8, 16) and the mLSTM
# gates (N = 4: a few columns of a tile, b staged byte by byte), whisper's
# encoder and cross k/v (M = 6,000), internvl2's decoder over prefix and
# tokens (M = 1,536; K = 28,672 takes the int32 sums to 1.86e9 of 2^31)
# and its prefix projection (M = 1,024)
FAMILY_TRAIN_SHAPES = [(160, 4096, 14336), (160, 14336, 4096),
                       (40, 5120, 8192), (40, 8192, 5120), (512, 4096, 8),
                       (512, 5120, 16), (512, 768, 4), (6000, 768, 768),
                       (6000, 3072, 768), (1536, 28672, 8192),
                       (1024, 3200, 8192)]


@pytest.mark.parametrize("M,K,N", FAMILY_TRAIN_SHAPES)
def test_training_kernels_at_the_families_shapes(cuda, M, K, N):
    """lut_matmul asym_u8 (uint8 b, offset 0) and residual_matmul sym_i8
    (int8 b, offset 128, rank 32) at the shape, weights drawn on the
    card: each bit-exact / within RESID_TOL_REL of its plain version, two
    launches bit-equal."""
    case = check.lut_case(M, K, N, False, M + K + N, cuda, shifted=False,
                          device_draw=True)
    check.check_lut(case)
    assert torch.equal(ops.lut_matmul(**case), ops.lut_matmul(**case))
    del case
    case = check.residual_case(M, K, N, True, 32, M + K + N, cuda,
                               device_draw=True)
    check.check_residual(case)
    assert torch.equal(ops.residual_matmul(**case),
                       ops.residual_matmul(**case))


# ---------------------------------------------------------------------------
# the biased table ('initial', asym_u8) and plan banks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signed,design", [(False, "initial"),
                                           (False, "design2"),
                                           (True, "design2")])
def test_exhaustive_sweep_through_both_kernels_and_schedules(cuda, signed,
                                                             design):
    """The 65,536 operand pairs through delta_matmul and fused_qdot, on
    the tile schedule (256 rows) and split-K (4 rows a launch): every
    launch bit-exact to its plain version and to the product table.
    'initial' asym_u8 takes the biased uint16 table."""
    assert check.check_sweeps(design, signed, cuda) == 260


@pytest.mark.parametrize("M", [1, 3, 4, 5, 37])
@pytest.mark.parametrize("K", [33, 2048, 6144])
def test_biased_initial_table_matches_plain(cuda, M, K):
    """Random operands through the biased table: the K * bias subtraction
    on the split-K schedule (each group's share per chunk) and the tile
    schedule (at the store / in the epilogue), K ragged against both."""
    case = check.delta_case(M, K, 131, False, M + K, cuda, design="initial")
    assert case["unsigned"] and case["bias"] == 48744
    check.check_delta(case)
    check.check_fused(check.fused_case(M, K, 131, False, M + K, cuda,
                                       design="initial"))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("M", [4, 256])
def test_bank_rows_equal_the_table_alone(cuda, signed, M):
    """A 3-table int16 bank: each row, a view into the bank, gives both
    kernels the same result as that table passed alone."""
    assert check.check_bank_rows(M, 2048, 1024, signed, M, cuda) == 12


def test_wrappers_refuse_a_biased_table_where_it_is_not_taken(cuda):
    case = check.delta_case(4, 64, 32, True, 0, cuda)
    with pytest.raises(ValueError, match="biased table"):
        ops.delta_matmul(**dict(case, unsigned=True, bias=5))
    f = check.fused_case(4, 64, 32, True, 0, cuda)
    with pytest.raises(ValueError, match="biased table"):
        ops.fused_qdot_packed(**dict(f, unsigned=True, bias=5))
    u = check.delta_case(4, 64, 32, False, 0, cuda)
    with pytest.raises(ValueError, match="bias only with unsigned"):
        ops.delta_matmul(**dict(u, bias=5))


@pytest.mark.parametrize("calibrate", ["0", "1"])
def test_smoke_initial_serve_matches_cpu_launch_by_launch(cuda, calibrate):
    """serve --design initial --quant-mode asym_u8 on the card, on the
    'delta' backend (uncalibrated, named: serve's default is 'xla') and
    the 'fused' one: every launch held against its plain version on the
    CPU."""
    from repro_torch.launch import serve
    argv = ["--smoke", "--requests", "2", "--prompt-len", "5", "--gen-len",
            "4", "--calibrate", calibrate, "--design", "initial",
            "--quant-mode", "asym_u8"]
    if calibrate == "0":
        argv += ["--backend", "delta"]
    with check.CpuShadow() as sh:
        serve.run(serve.build_parser().parse_args(argv))
    assert sh.stats["delta_matmul"]["calls"] > 0
    assert sh.stats["decode_attention"]["calls"] > 0
    assert (sh.stats["fused_qdot_packed"]["calls"] > 0) == (calibrate == "1")


@pytest.fixture
def smoke_plan(cuda, tmp_path, request):
    """A plan made by the port's CLI on the card at smoke size, with
    layer 1 moved to design2 so that every bank holds two tables."""
    from repro_torch.calib import DesignPlan, plan
    mode = request.param
    path = str(tmp_path / "plan.json")
    made = plan.main(["--smoke", "--batches", "1", "--quant-mode", mode,
                      "--no-recompose16", "--out", path])
    for key in made.layers:
        if key.endswith("@1"):
            made.layers[key] = "design2"
    if len(set(made.layers.values())) < 2:
        for key in made.layers:
            if key.endswith("@0"):
                made.layers[key] = "design1"
    made.save(path)
    return mode, path, DesignPlan.load(path)


@pytest.mark.parametrize("smoke_plan", ["asym_u8", "sym_i8"],
                         indirect=True)
def test_smoke_planned_serve_matches_cpu_launch_by_launch(smoke_plan):
    """serve --plan --calibrate 1 at smoke size: every launch held against
    its plain version on the CPU, the fused kernel reading two tables."""
    from repro_torch.launch import serve
    mode, path, _ = smoke_plan
    tables = set()
    argv = ["--smoke", "--requests", "2", "--prompt-len", "5", "--gen-len",
            "4", "--calibrate", "1", "--quant-mode", mode, "--plan", path]
    with check.CpuShadow() as sh:
        shadow = ops.fused_qdot_packed

        def spy(x, qw, dlut, *a, **k):
            tables.add(dlut.data_ptr())
            return shadow(x, qw, dlut, *a, **k)
        ops.fused_qdot_packed = spy      # CpuShadow's exit restores it
        serve.run(serve.build_parser().parse_args(argv))
    assert all(st["calls"] > 0 for st in sh.stats.values()), sh.stats
    assert len(tables) >= 2


@pytest.mark.parametrize("smoke_plan", ["sym_i8"], indirect=True)
def test_smoke_planned_train_step_matches_cpu_launch_by_launch(smoke_plan):
    """QAT through a plan at smoke size: every projection forward is a
    delta_matmul launch on its layer's bank row, held against the CPU."""
    from repro_torch import configs
    from repro_torch.calib import make_plan_injector
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_mod
    mode, _, plan = smoke_plan
    cuda = torch.device("cuda")
    cfg = configs.get_smoke("qwen3-1.7b")
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           device=cuda)
    q = QuantConfig(backend="xla", mode=mode)
    ocfg = OptConfig()
    step = make_train_step(cfg, q, ocfg, remat=True,
                           params_transform=make_plan_injector(params, plan,
                                                               q))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=g)
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
    with check.CpuShadow(("delta_matmul",)) as sh:
        _, _, metrics = step(params, opt_mod.init(params, ocfg), batch)
    assert sh.stats["delta_matmul"]["calls"] == 7 * cfg.n_layers * 2
    assert torch.isfinite(metrics["loss"])


VOCAB = 151936                 # qwen3-1.7b's vocabulary: the unembed's N


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("M", [1, 4])
def test_delta_kernel_at_the_vocabulary_width(cuda, signed, M):
    """The quantized unembed's product, K = 2048 and N = 151,936 (split-K
    units of 128 columns x 64 k over 1,187 column groups): bit-exact and
    repeatable."""
    case = check.delta_case(M, 2048, VOCAB, signed, M + signed, cuda)
    check.check_delta(case)
    assert torch.equal(ops.delta_matmul(**case), ops.delta_matmul(**case))


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("M", [1, 2, 3, 4])
@pytest.mark.parametrize("K,N", DECODE_SHAPES)
def test_lut_and_residual_kernels_at_decode_shapes(cuda, signed, M, K, N):
    """serve --backend xla / residual: the merged projections at decode M
    (1-4 rows of a 32-row tile), lut_matmul bit-exact through the offset
    (as the backend passes the operands), residual_matmul within
    check.RESID_TOL_REL."""
    check.check_lut(check.lut_case(M, K, N, signed, M * K + N, cuda,
                                   shifted=False))
    check.check_residual(check.residual_case(M, K, N, signed, 32,
                                             M * K + N, cuda))


def test_rmsnorm_rows_do_not_depend_on_the_batch(cuda):
    """layers.rmsnorm on the card gives every row the value it has alone
    (continuous batching serves a request as it would be served alone)."""
    from repro_torch.models import layers
    g = torch.Generator(device=cuda).manual_seed(0)
    gamma = torch.rand((2048,), generator=g, device=cuda) + 0.5
    for rows in (2, 3, 4, 64):
        for t in range(20):
            x = torch.randn((rows, 1, 2048), generator=g, device=cuda) * (
                1 + t)
            y = layers.rmsnorm(x, gamma)
            for i in range(rows):
                assert torch.equal(y[i:i + 1], layers.rmsnorm(x[i:i + 1],
                                                              gamma))


@pytest.mark.parametrize("extra", [
    ["--continuous", "5", "--calibrate", "1"],
    ["--per-channel", "--calibrate", "1", "--quant-mode", "sym_i8"],
    ["--prequantize", "--backend", "xla"],
    ["--prequantize", "--backend", "residual", "--quant-mode", "sym_i8"]])
def test_smoke_serve_options_match_cpu_launch_by_launch(cuda, extra):
    """serve --continuous / --per-channel / --backend xla / residual at
    smoke size on the card: every launch held against its plain version
    on the CPU (check.CpuShadow.serving), each of the backend's kernels
    launched."""
    from repro_torch.launch import serve
    argv = ["--smoke", "--requests", "2", "--prompt-len", "4", "--gen-len",
            "5"] + extra
    args = serve.build_parser().parse_args(argv)
    with check.CpuShadow(check.CpuShadow.serving(
            serve.quant_config(args).backend)) as sh:
        r = serve.run(args)
    assert all(st["calls"] > 0 for st in sh.stats.values()), sh.stats
    assert r.out.shape == ((5, 5) if args.continuous else (2, 5))


def test_smoke_continuous_requests_equal_their_replays(cuda):
    """--continuous 5 over 2 slots on the card: each request's ids equal
    that request served alone (a B = 1 prefill and decode steps on the
    same prepared tree)."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.train import make_prefill_step, make_serve_step
    argv = ["--smoke", "--requests", "2", "--prompt-len", "4", "--gen-len",
            "5", "--calibrate", "1", "--continuous", "5"]
    args = serve.build_parser().parse_args(argv)
    prep = serve.prepare(args)
    r = serve.run(args, prep)
    cfg = prep.cfg
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (5, 4))
    pf, step = (make_prefill_step(cfg, prep.qcfg),
                make_serve_step(cfg, prep.qcfg))
    with torch.no_grad():
        for i in range(5):
            st = T.init_decode_state(cfg, 1, 4 + 2 * 5 + 2, device=cuda,
                                     per_slot=True)
            tok, _, st = pf(prep.params, st, torch.as_tensor(
                prompts[i:i + 1].astype(np.int32), device=cuda))
            got = [int(tok[0, 0])]
            for _ in range(4):
                tok, _, st = step(prep.params, st, tok)
                got.append(int(tok[0, 0]))
            assert got == r.out[i].tolist(), i


def test_smoke_quant_unembed_matches_cpu_launch_by_launch(cuda):
    """QuantConfig(quant_unembed=True) at smoke size on the card: the
    head's delta_matmul (one a forward) and every other launch held
    against the CPU."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig, prequantize_weights
    from repro_torch.train import make_prefill_step, make_serve_step
    cfg = configs.get_smoke("qwen3-1.7b")
    q = QuantConfig(backend="delta", quant_unembed=True, inference=True)
    params = prequantize_weights(T.init_params(
        torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda), q)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 4)).astype(np.int32), device=cuda)
    with check.CpuShadow(check.CpuShadow.serving("delta")) as sh:
        st = T.init_decode_state(cfg, 2, 8, device=cuda)
        tok, _, st = make_prefill_step(cfg, q)(params, st, prompts)
        for _ in range(2):
            tok, lg, st = make_serve_step(cfg, q)(params, st, tok)
    # 7 projections x layers + the head, per forward, 3 forwards
    assert sh.stats["delta_matmul"]["calls"] == 3 * (7 * cfg.n_layers + 1)
    assert torch.isfinite(lg).all()


# ---------------------------------------------------------------------------
# the remaining decoder families: query groups above 8, head_dim 192 and
# 256, Kv = 1 with a window, and the int32 range of K = 73,728
# ---------------------------------------------------------------------------

# (B, S, H, Kv, hd, window, positions): nemotron-4-340b (96/8, hd 192),
# recurrentgemma-2b (10/1, hd 256, window 2048, positions past it),
# gemma-7b (16/16, hd 256) and a group of 16 at hd 256, whose shared
# memory takes the opt-in attribute
LARGE_GROUPS = [(4, 80, 96, 8, 192, None, [64, 70, 75, 79]),
                (4, 80, 10, 1, 256, 2048, [64, 70, 75, 79]),
                (4, 2600, 10, 1, 256, 2048, [2047, 2048, 2300, 2599]),
                (2, 4096, 96, 8, 192, None, [1, 4095]),
                (4, 80, 16, 16, 256, None, [0, 33, 65, 79]),
                (2, 300, 16, 1, 256, None, [299, 150])]


@pytest.mark.parametrize("B,S,H,Kv,hd,window,pos", LARGE_GROUPS)
def test_attention_kernel_at_large_groups(cuda, B, S, H, Kv, hd, window,
                                          pos):
    """decode_attention at query groups of 10, 12 and 16 (the G = 16
    instantiation) and gemma's 16/16, head_dim 192 and 256, qk-norm off as
    the configs have it: every head within ATTN_TOL of the plain version,
    two launches bit-equal, and the append in place."""
    case = check.attention_case(B, S, H, Kv, hd, H + S, cuda, qk_norm=False,
                                window=window, pos=pos)
    check.check_attention(case)
    check.check_attention_append(case)


def test_attention_kernel_at_chunk_edges_with_one_kv_head(cuda):
    """recurrentgemma-2b's 10/1 at head_dim 256 under its window of 2048,
    at every chunk and tile edge of a 4096-position cache."""
    H, Kv, hd, S, B = 10, 1, 256, 4096, 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges = check.attention_edge_positions(S, B, Kv, hd, sms)
    for i in range(0, len(edges), B):
        pos = (edges[i:i + B] + [S - 1] * B)[:B]
        check.check_attention(check.attention_case(
            B, S, H, Kv, hd, i, cuda, qk_norm=False, window=2048, pos=pos))


def test_smoke_recurrentgemma_decodes_past_its_window(cuda):
    """recurrentgemma-2b at smoke size with the config's own window of
    2048, a 2100-token prompt and 3 decode steps: the local attention's
    decode launches read positions past the window, each launch held
    against its plain version on the CPU (prequantized, the 'delta'
    backend: delta_matmul and decode_attention)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve
    argv = ["--arch", "recurrentgemma-2b", "--smoke", "--requests", "1",
            "--prompt-len", "2100", "--gen-len", "4", "--prequantize",
            "--backend", "delta"]
    args = serve.build_parser().parse_args(argv)
    cfg = dataclasses.replace(configs.get_smoke("recurrentgemma-2b"),
                              window=2048, max_seq=4096)
    with check.CpuShadow(check.CpuShadow.serving("delta")) as sh:
        r = serve.run(args, serve.prepare(args, cfg=cfg))
    assert sh.stats["decode_attention"]["calls"] > 0
    assert r.out.shape == (1, 4)


@pytest.mark.parametrize("M", [2, 4, 5, 17])
@pytest.mark.parametrize("design", ["design2", "initial"])
def test_delta_kernel_wraps_past_int32_at_k_73728(cuda, M, design):
    """delta_matmul at nemotron's w_down depth on operands whose exact
    product passes 2^31: the kernel's int32 words equal the plain
    version's on the card and on the CPU (split-K at M <= 4, tiles
    above), wrapped modulo 2^32 as the reference's."""
    r = check.check_range(check.range_delta_case(M, 24, M, cuda, design),
                          "delta_matmul")
    assert r["past_2_31"] > 0


@pytest.mark.parametrize("M", [2, 5])
@pytest.mark.parametrize("compensate", [False, True])
def test_fused_kernel_wraps_past_int32_at_k_73728(cuda, M, compensate):
    r = check.check_range(check.range_fused_case(M, 24, M, cuda,
                                                 compensate=compensate),
                          "fused_qdot")
    assert r["past_2_31"] > 0


@pytest.mark.parametrize("arch", ["gemma-7b", "minitron-8b",
                                  "nemotron-4-340b", "recurrentgemma-2b",
                                  "xlstm-125m"])
def test_smoke_new_families_serve_matches_cpu_launch_by_launch(cuda, arch):
    """serve --calibrate 1 of each new config at smoke size on the card:
    every launch held against its plain version on the CPU."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--requests", "2", "--prompt-len",
            "4", "--gen-len", "4", "--calibrate", "1"]
    with check.CpuShadow() as sh:
        r = serve.run(serve.build_parser().parse_args(argv))
    assert sh.stats["fused_qdot_packed"]["calls"] > 0
    assert sh.stats["delta_matmul"]["calls"] > 0
    assert (sh.stats["decode_attention"]["calls"] > 0) == (
        arch != "xlstm-125m")
    assert r.out.shape == (2, 4)


@pytest.mark.parametrize("signed", MODES)
@pytest.mark.parametrize("N", [768, 3072])
def test_fused_kernel_at_whisper_encoder_rows(cuda, signed, N):
    """whisper-small's encoder and cross k/v projections over its 1,500
    frames: M = 6,000 rows (a ragged last tile), K = 768."""
    check.check_fused(check.fused_case(6000, 768, N, signed, N + signed,
                                       cuda))


@pytest.mark.parametrize("S,pos", [(80, [64, 70, 75, 79]),
                                   (66, [0, 1, 33, 65]),
                                   (448, [0, 200, 446, 447])])
def test_attention_kernel_at_whisper_heads(cuda, S, pos):
    """12 query heads over 12 kv heads of 64 (group 1), rope, no
    qk-norm: whisper's decoder self-attention at the serve and
    calibration positions and at the ends of its 448 positions; the step
    and the append."""
    case = check.attention_case(4, S, 12, 12, 64, S, cuda, qk_norm=False,
                                pos=pos)
    check.check_attention(case)
    check.check_attention_append(case)


@pytest.mark.parametrize("signed", MODES)
def test_lut_kernel_at_the_vlm_prefix_projection(cuda, signed):
    """internvl2-76b's prefix projection: 2 x 256 patches, K = 3,200,
    N = 8,192, as the 'xla' backend passes the operands."""
    check.check_lut(check.lut_case(512, 3200, 8192, signed, 3 + signed,
                                   cuda, shifted=False))


def test_smoke_whisper_serve_matches_cpu_launch_by_launch(cuda):
    """serve --calibrate 1 of whisper-small at smoke size on the card: the
    encoder, the cross blocks and every other launch held against its
    plain version on the CPU."""
    from repro_torch.launch import serve
    argv = ["--arch", "whisper-small", "--smoke", "--requests", "2",
            "--prompt-len", "4", "--gen-len", "4", "--calibrate", "1"]
    with check.CpuShadow() as sh:
        r = serve.run(serve.build_parser().parse_args(argv))
    assert all(st["calls"] > 0 for st in sh.stats.values()), sh.stats
    assert r.out.shape == (2, 4) and r.t_encode > 0


def test_smoke_vlm_forward_train_matches_cpu_launch_by_launch(cuda):
    """internvl2-76b's forward_train at smoke size on the card ('xla'):
    the prefix projection and every layer's projections held against the
    plain version on the CPU (the free-running loss is printed beside
    the CPU's: the card's fused rmsnorm may flip a dynamic step)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    cfg = configs.get_smoke("internvl2-76b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    batch = configs.make_smoke_batch(cfg, 2, 8, seed=1)
    q = QuantConfig(design="design2", backend="xla", mode="asym_u8")

    def on(dev, tree):
        if isinstance(tree, dict):
            return {k: on(dev, v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [on(dev, v) for v in tree]
        return torch.as_tensor(tree).to(dev)
    with torch.no_grad():
        want, _ = T.forward_train(on("cpu", params), on("cpu", batch), cfg,
                                  q)
        with check.CpuShadow(("lut_matmul",)) as sh:
            got, _ = T.forward_train(on(cuda, params), on(cuda, batch), cfg,
                                     q)
    print(f"\ninternvl2 smoke forward_train: card loss {float(got)!r}, "
          f"CPU loss {float(want)!r}")
    assert sh.stats["lut_matmul"]["calls"] == 1 + 7 * cfg.n_layers
    assert bool(torch.isfinite(got))


@pytest.mark.parametrize("signed,design", [(False, "design2"),
                                           (False, "initial"),
                                           (True, "design2"),
                                           (True, "bw_design1")])
def test_approx_mul_on_the_card_equals_the_cpu(cuda, signed, design):
    """ops.approx_mul (torch ops on the device; no kernel of its own) on
    broadcast operands, every table entry reached."""
    lo = -128 if signed else 0
    v = torch.arange(lo, lo + 256, dtype=torch.int32)
    want = ops.approx_mul(v[:, None], v[None, :], design, signed)
    got = ops.approx_mul(v[:, None].to(cuda), v[None, :].to(cuda), design,
                         signed)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("design", ["exact", "design1", "design2",
                                    "momeni15"])
def test_sharpen_on_the_card_equals_the_cpu(cuda, design):
    from repro_torch.app import sharpening as sh
    for img in sh.make_test_images(3) + sh.make_test_images(
            1, size=(217, 301), seed=4):
        got = sh.sharpen(img, design, cuda)
        assert got.is_cuda
        assert torch.equal(got.cpu(), sh.sharpen(img, design, "cpu"))
        exact = sh.sharpen(img, "exact", cuda)
        assert sh.ssim(exact, got) == sh.ssim(exact.cpu(), got.cpu())
        assert sh.psnr(exact, got) == sh.psnr(exact.cpu(), got.cpu())


@pytest.mark.parametrize("design", ["design1", "design2", "design1_trunc4",
                                    "bw_design1"])
def test_gradients_on_the_card_equal_the_cpu(cuda, design):
    from repro_torch.app import edge_detection as ed
    from repro_torch.app.sharpening import make_test_images
    for img in make_test_images(3):
        for got, want in zip(ed.gradients(img, design, cuda),
                             ed.gradients(img, design, "cpu")):
            assert got.is_cuda and torch.equal(got.cpu(), want)
    assert (ed.evaluate(design, make_test_images(3), device=cuda)
            == ed.evaluate(design, make_test_images(3), device="cpu"))


def test_sharpen_queues_without_holding_the_host(cuda):
    """A 3840 x 2160 sharpen issues its ops without a host synchronize (no
    copy of a coefficient to the card per call), so chip_smoke.py can
    time its device work queued behind a spin (check.cuda_time)."""
    import functools

    from repro_torch.app import sharpening as sh
    x = torch.from_numpy(sh.make_test_images(1, size=(2160, 3840))[0])
    x = x.to(cuda)
    for design in ("exact", "design2"):
        ms = check.cuda_time(functools.partial(sh.sharpen, x, design, cuda),
                             3, queued=True)
        assert ms > 0


@pytest.mark.parametrize("backend,kernel", [("delta", "delta_matmul"),
                                            ("residual_xla",
                                             "residual_matmul")])
def test_prefill_logits_full_width_equals_the_plain_run(cuda, backend,
                                                        kernel):
    """train.make_prefill_logits at qwen3-1.7b's full width, 1 layer, B =
    2 x 64 tokens: one launch a projection (7), and the logits of the
    run through the kernels equal those of the same run with the plain
    versions on the card.  'delta' is bit-exact launch by launch, so the
    plain run is free.  residual_xla's kernel sums its float32
    correction in another order (check.RESID_TOL_REL), which can move a
    dynamic activation step downstream, so its plain run is fed the
    kernel run's products: each launch's operands must equal the kernel
    run's, its plain product is held to the kernel's within
    check.RESID_TOL_REL of max |out|, and the kernel's product goes on;
    the logits are then bit-equal."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import make_prefill_logits
    cfg = dataclasses.replace(configs.get("qwen3-1.7b"), n_layers=1)
    params = T.init_params(torch.Generator(device=cuda).manual_seed(21),
                           cfg, device=cuda)
    tokens = configs.make_smoke_batch(cfg, 2, 64, seed=22)["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device=cuda)}
    fn = make_prefill_logits(cfg, QuantConfig(design="design2",
                                              backend=backend, rank=16))
    ops.reset_launches()
    got = fn(params, batch)
    assert ops.LAUNCHES[kernel] == 7
    assert tuple(got.shape) == (2, 64, cfg.vocab)
    assert bool(torch.isfinite(got).all())
    saved = getattr(ops, kernel)
    if kernel == "delta_matmul":
        setattr(ops, kernel, lambda a, b, dlut, offset=0, *, unsigned=False,
                bias=0: check.delta_plain(dict(a=a, b=b, dlut=dlut,
                                               offset=offset,
                                               unsigned=unsigned,
                                               bias=bias)))
    else:
        calls = []

        def record(a, b, F, G, offset=0):
            out = saved(a, b, F, G, offset)
            calls.append((a.clone(), b.clone(), out.clone()))
            return out
        ops.residual_matmul = record
        try:
            assert torch.equal(fn(params, batch), got)
        finally:
            ops.residual_matmul = saved
        fed = iter(calls)

        def plain_fed(a, b, F, G, offset=0):
            ka, kb, kout = next(fed)
            assert torch.equal(a, ka) and torch.equal(b, kb), \
                "the plain run's operands left the kernel run's"
            check._resid_err(kout, ref.residual_corrected_matmul_ref(
                a, b, F, G, offset))
            return kout
        ops.residual_matmul = plain_fed
    try:
        ops.reset_launches()
        want = fn(params, batch)
        assert ops.LAUNCHES[kernel] == 0
    finally:
        setattr(ops, kernel, saved)
    if kernel == "residual_matmul":
        assert next(fed, None) is None and len(calls) == 7
    assert torch.equal(got, want)
