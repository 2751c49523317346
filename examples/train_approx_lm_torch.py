"""End-to-end run of the PyTorch/CUDA port: train the smoke-sized
qwen3 LM THROUGH the approximate multiplier (QAT with design2 forward,
exact STE backward) and compare against the exact baseline, as
examples/train_approx_lm.py does for the JAX package.

    PYTHONPATH=src python examples/train_approx_lm_torch.py \
        [--steps 60] [--device cpu]

On a CUDA card (the default) every projection of the design2 run
launches the lut_matmul kernel (``--backend xla``, the launcher's
default).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import train as train_mod  # noqa: E402


def run(design: str, steps: int, device: str) -> float:
    return train_mod.main(["--arch", "qwen3-1.7b", "--steps", str(steps),
                           "--design", design, "--log-every", "10",
                           "--smoke", "--seq", "128", "--batch", "4",
                           "--device", device])


def main(argv=None):
    """Train both; returns (exact loss, design2 loss)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("=== exact baseline ===")
    l_exact = run("exact", args.steps, args.device)
    print("=== design2 (approximate multiplier QAT) ===")
    l_apx = run("design2", args.steps, args.device)
    print(f"final losses: exact={l_exact:.4f}  design2={l_apx:.4f}  "
          f"gap={l_apx - l_exact:+.4f}")
    return l_exact, l_apx


if __name__ == "__main__":
    main()
