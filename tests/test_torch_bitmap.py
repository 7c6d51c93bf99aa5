"""The port's image files (`mitsuba_tpu_torch.io.bitmap`) against the JAX
package's: each writer gives the reference writer's bytes for the same
image, each reader reads what either package wrote back to the same
array (exactly; half-float EXR and 8-bit formats to what they store).
`.jpg` was refused until JPEG was ported: its case now holds the JPEG
hooks of `write_image` and `read_image` to the reference's (the same
bytes written, the same pixels read; tests/test_torch_jpeg.py holds the
codec), and unknown formats still raise.
"""
import numpy as np
import pytest

from mitsuba_tpu.io import bitmap as jb
from mitsuba_tpu_torch.io import bitmap as tb

RNG = np.random.default_rng(7)
HDR = (RNG.gamma(1.0, 0.6, (9, 13, 3)) * (RNG.uniform(size=(9, 13, 1))
                                          > 0.2)).astype(np.float32)
LDR = RNG.integers(0, 256, (9, 13, 3), dtype=np.uint8)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# (writer, extension, image, keyword arguments)
WRITERS = {
    "exr_zip": ("write_exr", "exr", HDR, {}),
    "exr_raw": ("write_exr", "exr", HDR, dict(compress=False)),
    "exr_half": ("write_exr", "exr", HDR, dict(half=True)),
    "exr_flat": ("write_exr", "exr", np.zeros((4, 5, 3), np.float32), {}),
    "pfm_rgb": ("write_pfm", "pfm", HDR, {}),
    "pfm_gray": ("write_pfm", "pfm", HDR[..., 0], {}),
    "ppm_u8": ("write_ppm", "ppm", LDR, {}),
    "ppm_float": ("write_ppm", "ppm", np.clip(HDR, 0, 1), {}),
    "png_rgb": ("write_png", "png", LDR, {}),
    "png_rgba": ("write_png", "png", np.concatenate(
        [LDR, LDR[..., :1]], -1), {}),
    "png_gray16": ("write_png", "png",
                   RNG.integers(0, 65536, (9, 13), dtype=np.uint16), {}),
    "png_float": ("write_png", "png", np.clip(HDR, 0, 1), {}),
    "tga_rgb": ("write_tga", "tga", LDR, {}),
    "tga_rgba": ("write_tga", "tga", np.concatenate([LDR, LDR[..., :1]], -1),
                 {}),
    "tga_gray": ("write_tga", "tga", LDR[..., 0], {}),
    "bmp_rgb": ("write_bmp", "bmp", LDR, {}),
    "bmp_gray": ("write_bmp", "bmp", LDR[..., 1], {}),
    "bmp_float": ("write_bmp", "bmp", np.clip(HDR, 0, 1), {}),
    "image_exr": ("write_image", "exr", HDR, {}),
    "image_png": ("write_image", "png", LDR, {}),
    "image_tga": ("write_image", "tga", LDR, {}),
}


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_writer_bytes_equal_reference(tmp_path, case):
    fn, ext, img, kw = WRITERS[case]
    a, b = str(tmp_path / f"port.{ext}"), str(tmp_path / f"ref.{ext}")
    getattr(tb, fn)(a, img, **kw)
    getattr(jb, fn)(b, img, **kw)
    assert _bytes(a) == _bytes(b)


def _stored(case):
    """What a file of `case` holds, as its reader returns it."""
    fn, ext, img, kw = WRITERS[case]
    if ext in ("exr", "pfm"):
        out = img.astype(np.float16 if kw.get("half") else np.float32)
        return out.astype(np.float32)
    if img.dtype != np.uint8 and img.dtype != np.uint16:
        img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    if ext == "bmp" and img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if ext in ("png", "ppm") and img.ndim == 2:
        img = img[..., None]
    return img


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_readers_round_trip(tmp_path, case):
    fn, ext, img, kw = WRITERS[case]
    p = str(tmp_path / f"x.{ext}")
    getattr(jb, fn)(p, img, **kw)
    got = tb.read_image(p)
    ref = jb.read_image(p)
    want = _stored(case)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(got.reshape(want.shape), want)


def test_mfilm_equals_reference(tmp_path):
    a, b = str(tmp_path / "a.m"), str(tmp_path / "b.m")
    var = HDR ** 2
    n = np.full(HDR.shape[:2], 16)
    tb.write_mfilm(a, HDR, var, n)
    jb.write_mfilm(b, HDR, var, n)
    assert _bytes(a) == _bytes(b)
    got = tb.read_mfilm(a)
    ref = jb.read_mfilm(a)
    assert got.keys() == ref.keys() == {"pixels", "variance", "nSamples"}
    for k in got:
        assert np.array_equal(got[k], ref[k])
    np.testing.assert_allclose(got["pixels"], HDR, rtol=1e-7)


def test_jpeg_and_unknown_formats_raise(tmp_path):
    a, b = str(tmp_path / "x.jpg"), str(tmp_path / "y.jpg")
    tb.write_image(a, LDR)
    jb.write_image(b, LDR)
    assert _bytes(a) == _bytes(b)
    got = tb.read_image(a)
    assert got.shape == LDR.shape and np.array_equal(got, jb.read_image(a))
    for fn in (tb.write_image, lambda p, _img: tb.read_image(p)):
        with pytest.raises(ValueError, match="unsupported"):
            fn(str(tmp_path / "x.gif"), LDR)
    p = str(tmp_path / "x.png")
    with open(p, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tb.read_png(p)
