"""Quickstart of the PyTorch/CUDA port: the paper's contribution in seven
steps, as examples/quickstart.py walks the JAX package.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On a CUDA card (the default) step 4 launches the delta_matmul kernel and
step 5 the lut_matmul kernel, held against its plain PyTorch version;
``--device cpu`` runs the plain versions.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import compressors as C  # noqa: E402
from repro_torch.core import metrics, multipliers as M  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.quant import QuantConfig, qdot  # noqa: E402
from repro_torch.signed import RECOMPOSED, SIGNED_MULTIPLIERS  # noqa: E402


def _rel_err(y, y_ref) -> float:
    return float((y - y_ref).abs().mean() / y_ref.abs().mean())


def main(argv=None) -> int:
    """Run the seven steps; returns step 5's max |kernel - plain|."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve(ap.parse_args(argv).device)

    # 1. The multicolumn 3,3:2 inexact compressor (paper Fig. 2 / Table 1)
    stats = C.compressor_stats("3,3:2")
    print(f"3,3:2 compressor: NED={stats['NED_C']:.5f} (paper: 0.08125), "
          f"{int(stats['ER'] * 128)}/128 rows erroneous (paper: 48)")

    # 2. The two proposed approximate multipliers (Figs. 8(d), 10(f))
    for name in ("design1", "design2"):
        s = metrics.multiplier_stats(M.MULTIPLIERS[name])
        print(f"{name}: MED={s['MED']:.1f} NED={s['NED'] * 1e3:.2f}e-3 "
              f"ER={s['ER'] * 100:.1f}%")

    # 3. A single approximate product, bit-exact vs the gate-level sim
    print("design2: 200 x 117 =", int(M.mult_design2(200, 117)),
          "(exact:", 200 * 117, ")")

    # 4. An approximate quantized matmul on the device
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64))
                         .astype(np.float32)).to(dev)
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 8))
                         .astype(np.float32)).to(dev)
    y_ref = x @ w
    y_apx = qdot(x, w, QuantConfig(design="design2"))
    print(f"approximate quantized matmul rel err: "
          f"{_rel_err(y_apx, y_ref):.3f}")

    # 5. The hand-written lut_matmul kernel (its plain version on the CPU)
    a = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (128, 128))
                         .astype(np.int32)).to(dev)
    b = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (128, 128))
                         .astype(np.uint8)).to(dev)
    lut, unsigned = ops.lut_table("design2", False, dev)
    s = ops.lut_matmul(a, b, lut, unsigned)
    err = int((s - ref.lut_matmul_ref(a, b, ops.get_lut("design2")))
              .abs().max())
    print(f"LUT-matmul output ({dev.type}):", tuple(s.shape), s.dtype,
          f"max |err| vs its plain version: {err}")

    # 6. Beyond-paper: the signed subsystem, symmetric int8 quantization
    # straight through the signed multiplier (no zero-point cross terms)
    print("design2 signed: -100 x 77 =",
          int(np.asarray(SIGNED_MULTIPLIERS["design2"](-100, 77))),
          "(exact:", -100 * 77, ")")
    y_sym = qdot(x, w, QuantConfig(design="design2", mode="sym_i8"))
    print(f"symmetric-signed quantized matmul rel err: "
          f"{_rel_err(y_sym, y_ref):.3f}")

    # 7. Beyond-paper: 16x16 recomposed from four 8x8 blocks
    spec = RECOMPOSED["s16_hh_exact"]
    print("16x16 (exact HH + design2 low blocks): -12345 x 6789 =",
          int(np.asarray(spec(-12345, 6789))), "(exact:", -12345 * 6789, ")")
    return err


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
