"""proj_roofline.serve: the least time of the traced rounds' projections
(bench/arith.py: max(bytes / 3.35 TB/s, 2 M K N / 1,979 TOP/s) a call,
the MoE experts counting the rows routed to them) over the device time
of the projection kernels named below (fused_qdot's pre-pass and its
two gather kernels), in percent."""
from bench import arith

KERNELS = ("quantize_rows", "splitk_kernel", "tile_kernel<")


def read(rec):
    tr = getattr(rec, "trace", None)
    if tr is None or not tr.device_ops:
        return None
    dev_s = sum(e - s for n, s, e in tr.device_ops
                if any(k in n for k in KERNELS)) / 1e6
    if dev_s <= 0:
        return None
    t = rec.traffic
    least = arith.serve_round_least_s(rec.model, t["batch"], t["prompt_len"],
                                      t["gen_len"])["proj_least_s"]
    return 100.0 * least * rec.trace_rounds / dev_s
