"""Paper §IV.B end-to-end on the PyTorch/CUDA port: image sharpening with
approximate multipliers.

    PYTHONPATH=src python examples/image_sharpening_torch.py [--device cpu]

Reproduces the Table 5 comparison on the synthetic image set (every
product of the blur a gather from the multiplier's table, on the device)
and writes the sharpened image to build/sharpened_design2.npy under the
working directory (run it from the repository root: build/ is
gitignored).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.app import sharpening as sh  # noqa: E402
from repro_torch.device import resolve  # noqa: E402

OUT = os.path.join("build", "sharpened_design2.npy")


def main(argv=None) -> str:
    """Print the table, write the design2 image; returns its path."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve(ap.parse_args(argv).device)

    imgs = sh.make_test_images()
    print(f"{'multiplier':18s} {'PSNR':>7s} {'SSIM':>8s}")
    for mult in ("design1", "design2", "momeni15", "venkatachalam16"):
        ps, ss = [], []
        for img in imgs:
            exact = sh.sharpen(img, "exact", dev)
            test = sh.sharpen(img, mult, dev)
            ps.append(sh.psnr(exact, test))
            ss.append(sh.ssim(exact, test))
        print(f"{mult:18s} {np.mean(ps):7.2f} {np.mean(ss):8.4f}")

    out = sh.sharpen(imgs[0], "design2", dev).cpu().numpy()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.save(OUT, out)
    print("wrote", OUT, out.shape)
    print("paper Table 5: design1 28.29/0.9469, design2 22.47/0.8929, "
          "[15] 6.69/1e-6")
    return OUT


if __name__ == "__main__":
    main()
