"""The port's image applications (repro_torch.app) against the JAX
package's (repro.app), on the CPU: the synthetic test set, the paper's
sharpening (Table 5) and the Sobel edge detection through the signed
multipliers.

Images, blurs, gradients, magnitudes and edge maps are bit-equal.  Every
sum in these pipelines is exact (integers, or float64 values of a few
dozen bits), so PSNR, SSIM, F1 and gradient PSNR are bit-equal too: the
port sums squared errors in int64 where the reference sums them in
float64, and SSIM's per-window values come to the host for numpy's
final mean.  The tests hold them to 1e-12 relative, as asked, and print
the measured gap (0 in every case when written).
"""
import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.app import edge_detection as red
from repro.app import sharpening as rsh
from repro_torch.app import edge_detection as ed
from repro_torch.app import sharpening as sh

CPU = "cpu"
SHARPEN_DESIGNS = ["exact", "design1", "design2", "initial", "momeni15",
                   "sabetzadeh14", "venkatachalam16"]
EDGE_DESIGNS = ["exact", "design1", "design2", "design1_trunc4",
                "bw_design1"]
REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and OpenMP thread (numpy's and torch's) while this file
    runs: the suite runs its files side by side on every core
    (pytest-xdist), where threads for these small ops only contend."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def imgs():
    return rsh.make_test_images()


@pytest.fixture(scope="module")
def image():
    """tests/test_sharpening.py's image: edges and texture."""
    rng = np.random.default_rng(0)
    x, y = np.meshgrid(np.arange(96), np.arange(128))
    img = (128 + 80 * np.sin(x / 7.0) * np.cos(y / 11.0)
           + 40 * (x > 48)).clip(0, 255)
    img += rng.normal(0, 4, img.shape)
    return img.clip(0, 255).astype(np.uint8)


def _close(got: float, want: float, what: str) -> None:
    """Equal within REL (equal, both inf); prints the measured gap."""
    if math.isinf(want) or want == 0:
        gap = 0.0 if got == want else math.inf
    else:
        gap = abs(got - want) / abs(want)
    print(f"{what}: port {got!r} reference {want!r} relative gap {gap:.3g}")
    assert gap <= REL, (what, got, want)


@pytest.mark.parametrize("n,size,seed", [(6, (128, 96), 0), (2, (37, 53), 5)])
def test_make_test_images_bit_equal(n, size, seed):
    got = sh.make_test_images(n, size, seed)
    want = rsh.make_test_images(n, size, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float64])
@pytest.mark.parametrize("p", [1, 2])
def test_pad_edge_is_numpy_edge_pad(dtype, p):
    x = np.random.default_rng(p).integers(0, 256, (7, 5)).astype(dtype)
    got = sh.pad_edge(torch.from_numpy(x), p).numpy()
    assert np.array_equal(got, np.pad(x, p, mode="edge"))


@pytest.mark.parametrize("design", SHARPEN_DESIGNS)
def test_blur_and_sharpen_bit_equal(imgs, design):
    for img in imgs:
        b = sh.blur(img, design, CPU)
        s = sh.sharpen(torch.from_numpy(img), design, CPU)
        assert b.dtype == s.dtype == torch.uint8
        assert np.array_equal(b.numpy(), rsh.blur(img, design))
        assert np.array_equal(s.numpy(), rsh.sharpen(img, design))


@pytest.mark.parametrize("design", SHARPEN_DESIGNS[1:])
def test_psnr_and_ssim_match(imgs, design):
    for k, img in enumerate(imgs):
        exact, test = rsh.sharpen(img, "exact"), rsh.sharpen(img, design)
        te, tt = torch.from_numpy(exact), torch.from_numpy(test)
        _close(sh.psnr(te, tt), rsh.psnr(exact, test), f"psnr {design} {k}")
        _close(sh.ssim(te, tt), rsh.ssim(exact, test), f"ssim {design} {k}")


def test_psnr_of_equal_images_is_inf(imgs):
    t = torch.from_numpy(imgs[0])
    assert sh.psnr(t, t) == rsh.psnr(imgs[0], imgs[0]) == float("inf")


@pytest.mark.parametrize("win", [5, 8, 16])
def test_ssim_windows_crop_as_the_reference(imgs, win):
    """Windows that do not tile the image (128 x 96 by 5 and by 16)."""
    a, b = imgs[0], rsh.sharpen(imgs[0], "momeni15")
    _close(sh.ssim(a, b, win), rsh.ssim(a, b, win), f"ssim win {win}")


def test_sharpen_float_reference_bit_equal(imgs, image):
    for img in imgs + [image]:
        assert np.array_equal(sh.sharpen_float_reference(img, CPU).numpy(),
                              rsh.sharpen_float_reference(img))


@pytest.mark.parametrize("design", EDGE_DESIGNS)
def test_gradients_magnitude_and_edges_bit_equal(imgs, design):
    for img in imgs:
        gx, gy = ed.gradients(img, design, CPU)
        rx, ry = red.gradients(img, design)
        assert np.array_equal(gx.numpy(), rx)
        assert np.array_equal(gy.numpy(), ry)
        assert np.array_equal(ed.magnitude(img, design, CPU).numpy(),
                              red.magnitude(img, design))
        for th in (64, 128):
            assert np.array_equal(ed.edge_map(img, design, th, CPU).numpy(),
                                  red.edge_map(img, design, th))


@pytest.mark.parametrize("design", EDGE_DESIGNS[1:])
def test_edge_scores_match(imgs, design):
    for k, img in enumerate(imgs):
        rm, tm = red.magnitude(img, "exact"), red.magnitude(img, design)
        pm, qm = torch.from_numpy(rm), torch.from_numpy(tm)
        _close(ed.edge_f1(pm > 128, qm > 128), red.edge_f1(rm > 128, tm > 128),
               f"F1 {design} {k}")
        _close(ed.gradient_psnr(pm, qm), red.gradient_psnr(rm, tm),
               f"grad psnr {design} {k}")
    got = ed.evaluate(design, imgs, device=CPU)
    want = red.evaluate(design, imgs)
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], f"evaluate {design} {key}")


def test_edge_f1_without_edges():
    none = torch.zeros(4, 4, dtype=torch.bool)
    some = none.clone()
    some[1, 2] = True
    assert ed.edge_f1(none, none) == red.edge_f1(none.numpy(),
                                                  none.numpy()) == 1.0
    assert ed.edge_f1(none, some) == red.edge_f1(none.numpy(),
                                                  some.numpy()) == 0.0


def test_evaluate_defaults_to_the_test_set():
    assert ed.evaluate("design1_trunc4", device=CPU) == \
        red.evaluate("design1_trunc4")


def test_images_must_be_uint8_2d(imgs):
    with pytest.raises(ValueError, match="uint8"):
        sh.blur(imgs[0].astype(np.int32), "exact", CPU)
    with pytest.raises(ValueError, match="uint8"):
        ed.gradients(np.stack([imgs[0]] * 2), "exact", CPU)


def test_entry_points_raise_without_a_card(imgs):
    """The default device is the card; without one nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    for call in (lambda: sh.sharpen(imgs[0]), lambda: sh.blur(imgs[0]),
                 lambda: ed.gradients(imgs[0]),
                 lambda: ed.evaluate("design2", imgs)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# the reference's quality assertions (tests/test_sharpening.py), on the
# port

def test_gaussian_kernel_matches_paper():
    assert sh.G.sum() == 273
    assert sh.G[2, 2] == 41
    assert (sh.G == sh.G.T).all()
    assert np.array_equal(sh.G, rsh.G)
    assert np.array_equal(ed.SOBEL_X, red.SOBEL_X)
    assert np.array_equal(ed.SOBEL_Y, red.SOBEL_Y)


def test_exact_sharpening_identity(image):
    ours = sh.sharpen(image, "exact", CPU).numpy()
    refv = sh.sharpen_float_reference(image, CPU).numpy()
    assert np.abs(ours.astype(int) - refv.astype(int)).max() <= 2


@pytest.mark.parametrize("design,min_psnr,min_ssim", [
    ("design1", 24.0, 0.85),   # paper: 28.29 / 0.9469 on its photo set
    ("design2", 18.0, 0.75),   # paper: 22.47 / 0.8929
])
def test_approx_sharpening_quality(image, design, min_psnr, min_ssim):
    exact = sh.sharpen(image, "exact", CPU)
    approx = sh.sharpen(image, design, CPU)
    psnr = sh.psnr(exact, approx)
    ssim = sh.ssim(exact, approx)
    assert psnr > min_psnr, (design, psnr)
    assert ssim > min_ssim, (design, ssim)


def test_design1_better_than_design2(image):
    exact = sh.sharpen(image, "exact", CPU)
    p1 = sh.psnr(exact, sh.sharpen(image, "design1", CPU))
    p2 = sh.psnr(exact, sh.sharpen(image, "design2", CPU))
    assert p1 > p2


def test_failing_competitor_is_worse(image):
    exact = sh.sharpen(image, "exact", CPU)
    s_bad = sh.ssim(exact, sh.sharpen(image, "momeni15", CPU))
    s_d1 = sh.ssim(exact, sh.sharpen(image, "design1", CPU))
    assert s_bad < s_d1
