"""Volume data files: the reference's `.vol` grid format and the builders
of grid media from it (port of mitsuba_tpu/io/volio.py; reference
src/volume/gridvolume.cpp:211-256).

A `.vol` file is b"VOL", version 3 (u8), the encoding (i32: 1 float32,
2 float16, 3 uint8), xres, yres, zres and channels (i32), the bounding
box (6 float32: xmin ymin zmin xmax ymax zmax) and the raw data, x
fastest, little endian throughout. Host numpy.
"""
from __future__ import annotations

import struct

import numpy as np

VOL_FLOAT32 = 1
VOL_FLOAT16 = 2
VOL_UINT8 = 3


def load_vol(path: str):
    """Read a `.vol` file -> (data (Z, Y, X, C) float32, bbox_min,
    bbox_max)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:3] != b"VOL":
        raise ValueError(f"{path}: not a VOL file")
    version = raw[3]
    if version != 3:
        raise ValueError(f"{path}: unsupported VOL version {version}")
    dtype_code, xres, yres, zres, channels = struct.unpack_from(
        "<iiiii", raw, 4)
    bbox = struct.unpack_from("<6f", raw, 24)
    off = 48
    count = xres * yres * zres * channels
    if dtype_code == VOL_FLOAT32:
        data = np.frombuffer(raw, "<f4", count, off).astype(np.float32)
    elif dtype_code == VOL_FLOAT16:
        data = np.frombuffer(raw, "<f2", count, off).astype(np.float32)
    elif dtype_code == VOL_UINT8:
        data = np.frombuffer(raw, "u1", count, off).astype(np.float32) \
            / 255.0
    else:
        raise ValueError(f"{path}: unknown encoding {dtype_code}")
    data = data.reshape(zres, yres, xres, channels)
    return data, np.asarray(bbox[:3]), np.asarray(bbox[3:])


def save_vol(path: str, data, bbox_min, bbox_max):
    """Write (Z, Y, X, C) (or (Z, Y, X)) float32 data as a version-3
    `.vol` file."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    zres, yres, xres, channels = data.shape
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(bytes([3]))
        f.write(struct.pack("<iiiii", VOL_FLOAT32, xres, yres, zres,
                            channels))
        f.write(struct.pack("<6f", *np.asarray(bbox_min, np.float32),
                            *np.asarray(bbox_max, np.float32)))
        f.write(data.astype("<f4").tobytes())


def grid_world_to_index_transform(bbox_min, bbox_max, shape_zyx):
    """The 4x4 map of world points into (x, y, z) grid index space
    [0, res - 1], as media/medium.py lookup_density reads it (float64;
    the medium rounds it to float32)."""
    zres, yres, xres = shape_zyx[:3]
    ext = np.maximum(np.asarray(bbox_max) - np.asarray(bbox_min), 1e-12)
    scale = np.asarray([
        (xres - 1) / ext[0] if xres > 1 else 0.0,
        (yres - 1) / ext[1] if yres > 1 else 0.0,
        (zres - 1) / ext[2] if zres > 1 else 0.0,
    ])
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = scale
    m[:3, 3] = -np.asarray(bbox_min) * scale
    return m


def load_heterogeneous_from_vol(path: str, sigma_s, sigma_a,
                                density_scale: float = 1.0, g: float = 0.0,
                                orientation=None, flake_stddev=None,
                                phase_kind=None):
    """A grid MediumTable from a `.vol` density, optionally with a fiber
    orientation field and the Gaussian flake phase (the reference's
    heterogeneous.cpp density + orientation volume pair)."""
    from mitsuba_tpu_torch.media import make_heterogeneous

    data, bmin, bmax = load_vol(path)
    density = data[..., 0]
    w2g = grid_world_to_index_transform(bmin, bmax, density.shape)
    return make_heterogeneous(density, w2g, sigma_s, sigma_a,
                              density_scale=density_scale, g=g,
                              orientation=orientation,
                              flake_stddev=flake_stddev,
                              phase_kind=phase_kind)
