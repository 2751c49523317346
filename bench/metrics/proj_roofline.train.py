"""proj_roofline.train: the least time of the traced steps' approximate
products (bench/arith.py: each projection of the forward and of its remat
recompute, max(bytes / 3.35 TB/s, 2 M K N / 1,979 TOP/s) a call) over
the device time of the lut_matmul kernel, in percent."""
from bench import arith

KERNELS = ("lut_matmul_kernel",)


def read(rec):
    tr = getattr(rec, "trace", None)
    if tr is None or not getattr(rec, "trace_steps", 0):
        return None
    dev_s = sum(e - s for n, s, e in tr.device_ops
                if any(k in n for k in KERNELS)) / 1e6
    if dev_s <= 0:
        return None
    t = rec.traffic
    least = arith.train_step_least_s(rec.model, t["batch"],
                                     t["seq"])["proj_least_s"]
    return 100.0 * least * rec.trace_steps / dev_s
