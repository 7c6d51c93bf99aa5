"""The port's JPEG codec (`mitsuba_tpu_torch/io/jpeg.py`, a copy of the
JAX package's numpy codec with a bit reader that keeps only the bits not
read yet) and its hooks in `io/bitmap.py`, against the JAX package's, on
the cases of tests/test_jpeg.py:22-58.

- Decode: bit for bit the reference's decode of the same bytes, from
  PIL (4:2:0, 4:2:2 and 4:4:4, restart markers, grayscale) and from the
  reference's own encoder; also within 2 levels of PIL's libjpeg, as the
  reference's test holds its decoder.
- Encode: the same bytes as the reference's writer at each quality.
- A progressive file: PIL decodes it where PIL is importable, as in the
  reference; without PIL it raises the decoder's ValueError (the
  reference's hook raises PIL's ImportError there).
- `.jpg` and (grayscale) `.jpeg` bitmap textures through `load_scene`:
  the scene's tables equal `from_jax_scene` of the reference's load, bit
  for bit.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from mitsuba_tpu.io import bitmap as jbitmap
from mitsuba_tpu.io import jpeg as jjpeg
from mitsuba_tpu.io import xml as jxml
from mitsuba_tpu_torch.interop import from_jax_scene
from mitsuba_tpu_torch.io import bitmap as tbitmap
from mitsuba_tpu_torch.io import jpeg as tjpeg
from mitsuba_tpu_torch.io import xml as txml
from tests.test_torch_xml import _same

PIL = pytest.importorskip("PIL.Image")
torch.set_num_threads(1)


def _test_image(h=29, w=37, seed=0):
    """tests/test_jpeg.py's image: gradients with noise, sizes that are
    no multiple of 8."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    img = (np.stack([xx * 0.8 + 0.1, yy * 0.7 + 0.1, xx * yy * 0.9], -1)
           * 255).astype(np.uint8)
    return np.clip(img.astype(int) + rng.integers(-8, 8, img.shape),
                   0, 255).astype(np.uint8)


def _both_decode(path):
    got, want = tjpeg.read_jpeg(path), jjpeg.read_jpeg(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ref = np.asarray(PIL.open(path))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2
    return got


@pytest.mark.parametrize("subsampling", [2, 1, 0])  # 4:2:0, 4:2:2, 4:4:4
def test_decode_equals_reference(tmp_path, subsampling):
    p = str(tmp_path / "t.jpg")
    PIL.fromarray(_test_image()).save(p, quality=90, subsampling=subsampling)
    assert _both_decode(p).shape == (29, 37, 3)


def test_decode_restart_markers_and_grayscale_equal_reference(tmp_path):
    img = _test_image(45, 70, seed=3)
    p = str(tmp_path / "t.jpg")
    PIL.fromarray(img).save(p, quality=85, restart_marker_rows=1)
    _both_decode(p)
    PIL.fromarray(img[:, :, 0]).save(p, quality=90)
    assert _both_decode(p).ndim == 2


@pytest.mark.parametrize("quality", [50, 92])
def test_encode_equals_reference(tmp_path, quality):
    img = _test_image(40, 33, seed=quality)
    a, b = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    tjpeg.write_jpeg(a, img, quality=quality)
    jjpeg.write_jpeg(b, img, quality=quality)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    # the reference's encoded bytes decode the same in both packages
    dec = _both_decode(b)
    assert np.abs(dec.astype(int) - img.astype(int)).mean() < 8


def test_read_write_image_dispatch_equals_reference(tmp_path):
    img = _test_image()
    for ext in (".jpg", ".jpeg"):
        a, b = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
        tbitmap.write_image(a, img)
        jbitmap.write_image(b, img)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert np.array_equal(tbitmap.read_image(a), jbitmap.read_image(a))


def test_progressive_file_goes_to_pil(tmp_path, monkeypatch):
    p = str(tmp_path / "p.jpg")
    PIL.fromarray(_test_image()).save(p, quality=90, progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        tjpeg.read_jpeg(p)
    got = tbitmap.read_image(p)
    assert np.array_equal(got, jbitmap.read_image(p))
    assert np.array_equal(got, np.asarray(PIL.open(p)))
    # where PIL is not importable (the card's machine), the decoder's
    # ValueError stands
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="progressive"):
        tbitmap.read_image(p)


TEXTURED = """<scene>
 <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
 <camera type="perspective"><float name="fov" value="40"/>
  <transform name="toWorld"><lookAt ox="0" oy="2" oz="-3" tx="0" ty="0"
   tz="0" ux="0" uy="1" uz="0"/></transform>
  <film type="exrfilm"><integer name="width" value="8"/>
   <integer name="height" value="8"/></film></camera>
 <luminaire type="point"><point name="position" x="0" y="3" z="0"/>
  <rgb name="intensity" value="20"/></luminaire>
 <shape type="sphere"><float name="radius" value="0.7"/>
  <bsdf type="diffuse"><texture type="bitmap" name="reflectance">
   <string name="filename" value="t.jpg"/>
   <float name="uscale" value="2"/></texture></bsdf></shape>
 <shape type="sphere"><point name="center" x="1.5" y="0" z="0"/>
  <float name="radius" value="0.4"/>
  <bsdf type="diffuse"><texture type="bitmap" name="reflectance">
   <string name="filename" value="g.jpeg"/></texture></bsdf></shape>
</scene>"""


def test_jpeg_bitmap_scene_equals_reference(tmp_path):
    img = _test_image(48, 64, seed=5)
    tjpeg.write_jpeg(str(tmp_path / "t.jpg"), img, quality=80)
    PIL.fromarray(img[:, :, 1]).save(str(tmp_path / "g.jpeg"), quality=75)
    port, _ = txml.load_scene_string(TEXTURED, base_dir=str(tmp_path),
                                     device="cpu")
    ref, _ = jxml.load_scene_string(TEXTURED, base_dir=str(tmp_path))
    conv = from_jax_scene(ref, device="cpu")
    for f in dataclasses.fields(port):
        _same(getattr(port, f.name), getattr(conv, f.name), f.name)
    assert len(port.textures.images) == 2
