"""Bitmap image I/O: PNG, PFM, OpenEXR (uncompressed/ZIP scanline), PPM,
TGA, BMP and the MFilm text format (the port's copy of
mitsuba_tpu/io/bitmap.py; host numpy, no torch).

Capability parity with the reference Bitmap class (include/mitsuba/core/
bitmap.h:35, src/libcore/bitmap.cpp):
  * PNG: 8/16-bit RGB(A)+gray read/write (zlib deflate, filters 0-4)
  * PFM: float32 RGB read/write (the portable float format)
  * EXR: float32/half scanline images, compression none or ZIP — enough to
    read lat-long envmaps and write HDR output (exrfilm parity)
  * PPM/PGM binary, TGA and BMP read/write
  * baseline JPEG read/write (io/jpeg.py); a progressive file is read by
    PIL where PIL is importable, and raises ValueError where it is not
Each writer gives the reference writer's bytes for the same image.
"""
from __future__ import annotations

import collections
import os
import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    c = struct.pack(">I", len(data)) + tag + data
    return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W), (H, W, 1), (H, W, 3) or (H, W, 4); uint8 or uint16.
    Float input in [0,1] is converted to uint8."""
    img = np.asarray(img)
    if img.dtype in (np.float32, np.float64):
        img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    depth = 16 if img.dtype == np.uint16 else 8
    raw = img.astype(">u2" if depth == 16 else "u1").tobytes()
    stride = w * c * (depth // 8)
    lines = [b"\x00" + raw[y * stride : (y + 1) * stride] for y in range(h)]
    body = (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                          color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"".join(lines), 6))
            + _chunk(b"IEND", b""))
    if hasattr(path, "write"):          # file-like (in-memory encoders)
        path.write(body)
    else:
        with open(path, "wb") as f:
            f.write(body)


def _unfilter(data, h, stride, bpp):
    out = bytearray(h * stride)
    pos = 0
    prev = bytearray(stride)
    for y in range(h):
        ftype = data[pos]
        pos += 1
        line = bytearray(data[pos : pos + stride])
        pos += stride
        if ftype == 1:  # sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:  # up
            for i in range(stride):
                line[i] = (line[i] + prev[i]) & 0xFF
        elif ftype == 3:  # average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                cc = prev[i - bpp] if i >= bpp else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[i] = (line[i] + pred) & 0xFF
        out[y * stride : (y + 1) * stride] = line
        prev = line
    return bytes(out)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = depth = color = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", chunk)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = zlib.decompress(idat)
    bpp = max(1, channels * depth // 8)
    stride = (w * channels * depth + 7) // 8
    out = _unfilter(raw, h, stride, bpp)
    if depth == 8:
        img = np.frombuffer(out, np.uint8).reshape(h, w, channels)
    elif depth == 16:
        img = np.frombuffer(out, ">u2").astype(np.uint16).reshape(h, w, channels)
    else:
        # 1/2/4-bit gray or palette
        bits = np.unpackbits(np.frombuffer(out, np.uint8).reshape(h, stride), axis=1)
        vals = bits.reshape(h, -1, depth)
        img = np.zeros((h, w), np.uint8)
        for b in range(depth):
            img = (img << 1) | vals[:, :w, b]
        img = img[:, :, None]
    if color == 3:
        img = palette[img[:, :, 0]]
    return img


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    color = img.ndim == 3 and img.shape[2] == 3
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little endian
        f.write(np.flipud(img).tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        dtype = "<f4" if scale < 0 else ">f4"
        count = w * h * (3 if color else 1)
        img = np.frombuffer(f.read(count * 4), dtype).reshape(
            (h, w, 3) if color else (h, w)
        )
    return np.flipud(img).astype(np.float32)


# ---------------------------------------------------------------------------
# PPM / PGM
# ---------------------------------------------------------------------------

def write_ppm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if img.dtype in (np.float32, np.float64):
        img = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(maxsplit=4)
    magic, w, h, maxv = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    pix = parts[4]
    c = 3 if magic == b"P6" else 1
    dt = np.uint8 if maxv < 256 else ">u2"
    return np.frombuffer(pix, dt, count=w * h * c).reshape(h, w, c)


# ---------------------------------------------------------------------------
# OpenEXR (scanline, compression NONE or ZIP, float/half)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data


def write_exr(path: str, img: np.ndarray, half: bool = False,
              compress: bool = True) -> None:
    """Write (H, W, 3) float RGB as scanline EXR (ZIP per-line or none)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    pix_t = 1 if half else 2          # 1=HALF, 2=FLOAT
    dtype = np.float16 if half else np.float32
    comp = 2 if compress else 0        # 2 = ZIP(1-line? 2=ZIPS single line)
    comp = 2 if compress else 0        # ZIPS: one scanline per block
    chan = b""
    for c in (b"B", b"G", b"R"):
        chan += c + b"\x00" + struct.pack("<IiII", pix_t, 0, 1, 1)
    chan += b"\x00"
    header = b""
    header += _exr_attr(b"channels", b"chlist", chan)
    header += _exr_attr(b"compression", b"compression", bytes([comp]))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines = []
    for y in range(h):
        # channel order alphabetical: B, G, R
        row = np.concatenate(
            [img[y, :, 2], img[y, :, 1], img[y, :, 0]]
        ).astype(dtype).tobytes()
        if compress:
            row = _exr_zip_compress(row)
        lines.append(row)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", _EXR_MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, no tiles
        f.write(header)
        offset_table_pos = f.tell()
        f.write(b"\x00" * 8 * h)
        offsets = []
        for y, row in enumerate(lines):
            offsets.append(f.tell())
            f.write(struct.pack("<i", y))
            f.write(struct.pack("<I", len(row)))
            f.write(row)
        f.seek(offset_table_pos)
        f.write(struct.pack(f"<{h}Q", *offsets))


def _exr_zip_compress(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8).astype(np.int16)
    # EXR predictor: delta encode then interleave split
    delta = np.empty_like(arr)
    delta[0] = arr[0]
    delta[1:] = arr[1:] - arr[:-1] + 128 + 256
    d8 = (delta & 0xFF).astype(np.uint8)
    half = (len(d8) + 1) // 2
    inter = np.empty_like(d8)
    inter[:half] = d8[0::2]
    inter[half:] = d8[1::2]
    comp = zlib.compress(inter.tobytes())
    return comp if len(comp) < len(data) else data


def _exr_zip_decompress(data: bytes, expected: int) -> bytes:
    if len(data) == expected:
        return data
    raw = zlib.decompress(data)
    d8 = np.frombuffer(raw, np.uint8)
    half = (len(d8) + 1) // 2
    deinter = np.empty_like(d8)
    deinter[0::2] = d8[:half]
    deinter[1::2] = d8[half:]
    arr = deinter.astype(np.int16)
    out = np.empty_like(arr)
    out[0] = arr[0]
    np.cumsum((arr[1:] - 128 - 256), out=out[1:])
    out[1:] += arr[0]
    return (out & 0xFF).astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR (compression none/ZIPS/ZIP) into (H, W, C) f32."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR")
    if version & 0x200:
        raise ValueError("tiled EXR unsupported")
    pos = 8
    channels = []
    comp = 0
    dw = None
    while True:
        if data[pos] == 0:
            pos += 1
            break
        end = data.index(b"\x00", pos)
        name = data[pos:end]
        pos = end + 1
        end = data.index(b"\x00", pos)
        typ = data[pos:end]
        pos = end + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        val = data[pos : pos + size]
        pos += size
        if name == b"channels":
            cp = 0
            while val[cp] != 0:
                ce = val.index(b"\x00", cp)
                cname = val[cp:ce].decode()
                ptype, _, xs, ys = struct.unpack_from("<IiII", val, ce + 1)
                channels.append((cname, ptype))
                cp = ce + 1 + 16
        elif name == b"compression":
            comp = val[0]
        elif name == b"dataWindow":
            dw = struct.unpack("<iiii", val)
    if comp not in (0, 2, 3):
        raise ValueError(f"EXR compression {comp} unsupported (need none/ZIPS/ZIP)")
    x0, y0, x1, y1 = dw
    w, h = x1 - x0 + 1, y1 - y0 + 1
    nch = len(channels)
    lines_per_block = 1 if comp in (0, 2) else 16
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)
    ch_sizes = [2 if t == 1 else 4 for _, t in channels]
    line_bytes = w * sum(ch_sizes)
    out = np.zeros((h, w, nch), np.float32)
    for off in offsets:
        (y,) = struct.unpack_from("<i", data, off)
        (size,) = struct.unpack_from("<I", data, off + 4)
        block = data[off + 8 : off + 8 + size]
        rows = min(lines_per_block, h - (y - y0))
        raw = _exr_zip_decompress(block, line_bytes * rows)
        rp = 0
        for r in range(rows):
            for ci, (cname, ptype) in enumerate(channels):
                nbytes = w * (2 if ptype == 1 else 4)
                dt = np.float16 if ptype == 1 else (
                    np.float32 if ptype == 2 else np.uint32
                )
                vals = np.frombuffer(raw, dt, count=w, offset=rp)
                out[y - y0 + r, :, ci] = vals.astype(np.float32)
                rp += nbytes
    # reorder alphabetical BGR -> RGB if applicable
    names = [c[0] for c in channels]
    if names == ["B", "G", "R"]:
        out = out[:, :, ::-1]
    elif names == ["A", "B", "G", "R"]:
        out = out[:, :, [3, 2, 1, 0]]
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# dispatch by extension (reference Bitmap::load switches on file type)
# ---------------------------------------------------------------------------

def read_image(path: str) -> np.ndarray:
    p = path.lower()
    if p.endswith(".png"):
        return read_png(path)
    if p.endswith(".pfm"):
        return read_pfm(path)
    if p.endswith(".exr"):
        return read_exr(path)
    if p.endswith((".ppm", ".pgm")):
        return read_ppm(path)
    if p.endswith(".tga"):
        return read_tga(path)
    if p.endswith(".bmp"):
        return read_bmp(path)
    if p.endswith((".jpg", ".jpeg")):
        from mitsuba_tpu_torch.io.jpeg import read_jpeg

        try:
            return read_jpeg(path)
        except ValueError as err:
            # progressive or arithmetic-coded files: PIL where it is
            # importable (bitmap.py:377-387), else the decoder's error
            try:
                from PIL import Image
            except ImportError:
                raise err from None
            return np.asarray(Image.open(path))
    raise ValueError(f"unsupported image format: {path}")


_IMAGE_CACHE = collections.OrderedDict()
_IMAGE_CACHE_SIZE = 64


def read_image_cached(path: str) -> np.ndarray:
    """read_image through a cache of the last 64 files by absolute path
    (bitmap.py:393 read_image_cached): a scene whose materials name one
    texture file many times, or that is loaded twice in a process,
    decodes it once. The array is shared: callers do not write to it."""
    key = os.path.abspath(path)
    img = _IMAGE_CACHE.pop(key, None)
    if img is None:
        img = read_image(path)
    _IMAGE_CACHE[key] = img
    while len(_IMAGE_CACHE) > _IMAGE_CACHE_SIZE:
        _IMAGE_CACHE.popitem(last=False)
    return img


def write_image(path: str, img) -> None:
    img = np.asarray(img)
    p = path.lower()
    if p.endswith(".png"):
        write_png(path, img)
    elif p.endswith(".pfm"):
        write_pfm(path, img)
    elif p.endswith(".exr"):
        write_exr(path, img)
    elif p.endswith(".ppm"):
        write_ppm(path, img)
    elif p.endswith(".tga"):
        write_tga(path, img)
    elif p.endswith(".bmp"):
        write_bmp(path, img)
    elif p.endswith((".jpg", ".jpeg")):
        from mitsuba_tpu_torch.io.jpeg import write_jpeg

        write_jpeg(path, img)
    else:
        raise ValueError(f"unsupported image format: {path}")


# ---------------------------------------------------------------------------
# TGA (reference src/libcore/bitmap.cpp loadTGA/saveTGA: native decoder —
# truecolor/grayscale, uncompressed + RLE, bottom/top origin)
# ---------------------------------------------------------------------------

def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return np.clip(np.asarray(img, np.float64) * 255.0 + 0.5,
                   0, 255).astype(np.uint8)


def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    idlen, cmap_type, img_type = data[0], data[1], data[2]
    w = int.from_bytes(data[12:14], "little")
    h = int.from_bytes(data[14:16], "little")
    bpp = data[16]
    desc = data[17]
    if cmap_type != 0:
        raise ValueError(f"{path}: color-mapped TGA unsupported")
    if img_type not in (2, 3, 10, 11):
        raise ValueError(f"{path}: TGA image type {img_type} unsupported")
    nch = bpp // 8
    if nch not in (1, 3, 4):
        raise ValueError(f"{path}: {bpp}-bit TGA unsupported")
    off = 18 + idlen
    npix = w * h
    if img_type >= 10:                      # RLE
        out = np.empty(npix * nch, np.uint8)
        buf = np.frombuffer(data, np.uint8, offset=off)
        pos = 0
        filled = 0
        while filled < npix * nch:
            hdr = int(buf[pos]); pos += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:                  # run packet
                px = buf[pos:pos + nch]; pos += nch
                out[filled:filled + count * nch] = np.tile(px, count)
            else:                           # raw packet
                nb = count * nch
                out[filled:filled + nb] = buf[pos:pos + nb]; pos += nb
            filled += count * nch
        img = out.reshape(h, w, nch)
    else:
        img = np.frombuffer(data, np.uint8, offset=off,
                            count=npix * nch).reshape(h, w, nch)
    if not (desc & 0x20):                   # bottom-left origin
        img = img[::-1]
    if nch >= 3:                            # BGR(A) -> RGB(A)
        img = img[..., [2, 1, 0] + ([3] if nch == 4 else [])]
    return np.ascontiguousarray(img[..., 0] if nch == 1 else img)


def write_tga(path: str, img: np.ndarray) -> None:
    img = _to_u8(np.asarray(img))
    if img.ndim == 2:
        img = img[..., None]
    h, w, nch = img.shape
    if nch == 1:
        body, img_type, bpp = img, 3, 8
    else:
        if nch not in (3, 4):
            raise ValueError("TGA write expects 1/3/4 channels")
        body = img[..., [2, 1, 0] + ([3] if nch == 4 else [])]
        img_type, bpp = 2, nch * 8
    hdr = bytearray(18)
    hdr[2] = img_type
    hdr[12:14] = w.to_bytes(2, "little")
    hdr[14:16] = h.to_bytes(2, "little")
    hdr[16] = bpp
    hdr[17] = 0x20 | (8 if nch == 4 else 0)     # top-left origin
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.ascontiguousarray(body).tobytes())


# ---------------------------------------------------------------------------
# BMP (reference bitmap.cpp loadBMP: BITMAPINFOHEADER, 8/24/32-bit
# uncompressed)
# ---------------------------------------------------------------------------

def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    pix_off = int.from_bytes(data[10:14], "little")
    hdr_size = int.from_bytes(data[14:18], "little")
    if hdr_size < 40:
        raise ValueError(f"{path}: BITMAPCOREHEADER unsupported")
    w = int.from_bytes(data[18:22], "little", signed=True)
    h = int.from_bytes(data[22:26], "little", signed=True)
    bpp = int.from_bytes(data[28:30], "little")
    comp = int.from_bytes(data[30:34], "little")
    if comp not in (0, 3):
        raise ValueError(f"{path}: compressed BMP unsupported")
    flip = h > 0
    h = abs(h)
    nch = bpp // 8
    if nch not in (1, 3, 4):
        raise ValueError(f"{path}: {bpp}-bit BMP unsupported")
    stride = (w * nch + 3) & ~3
    rows = np.frombuffer(data, np.uint8, offset=pix_off,
                         count=stride * h).reshape(h, stride)
    img = rows[:, : w * nch].reshape(h, w, nch)
    if flip:
        img = img[::-1]
    if nch == 1:                            # palette: assume grayscale ramp
        return np.ascontiguousarray(img[..., 0])
    img = img[..., [2, 1, 0] + ([3] if nch == 4 else [])]
    return np.ascontiguousarray(img)


def write_bmp(path: str, img: np.ndarray) -> None:
    img = _to_u8(np.asarray(img))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img[::-1, :, [2, 1, 0]].reshape(h, w * 3)
    body = rows.tobytes()
    hdr = bytearray(54)
    hdr[0:2] = b"BM"
    hdr[2:6] = (54 + len(body)).to_bytes(4, "little")
    hdr[10:14] = (54).to_bytes(4, "little")
    hdr[14:18] = (40).to_bytes(4, "little")
    hdr[18:22] = w.to_bytes(4, "little")
    hdr[22:26] = h.to_bytes(4, "little")
    hdr[26:28] = (1).to_bytes(2, "little")
    hdr[28:30] = (24).to_bytes(2, "little")
    hdr[34:38] = len(body).to_bytes(4, "little")
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(body)


# ---------------------------------------------------------------------------
# MFilm (src/films/mfilm.cpp): matlab-style text output with statistics
# ---------------------------------------------------------------------------

def write_mfilm(path: str, mean, var=None, n=None) -> None:
    mean = np.asarray(mean)
    h, w = mean.shape[:2]
    with open(path, "w") as f:
        def emit(name, arr):
            f.write(f"{name} = [\n")
            for y in range(h):
                row = ", ".join(
                    " ".join(f"{v:.8g}" for v in np.atleast_1d(arr[y, x]))
                    for x in range(w)
                )
                f.write("  " + row + (";\n" if y < h - 1 else "\n"))
            f.write("];\n")

        emit("pixels", mean)
        if var is not None:
            emit("variance", np.asarray(var))
        if n is not None:
            emit("nSamples", np.asarray(n))


def read_mfilm(path: str):
    """Parse the pixels matrix back (inverse of write_mfilm, reference
    TestSupervisor::analyze input format)."""
    arrays = {}
    with open(path) as f:
        text = f.read()
    import re

    for match in re.finditer(r"(\w+) = \[\n(.*?)\n\];", text, re.S):
        name, body = match.group(1), match.group(2)
        rows = []
        for line in body.strip().split("\n"):
            line = line.strip().rstrip(";")
            cells = [c.strip() for c in line.split(",")]
            rows.append([[float(v) for v in c.split()] for c in cells])
        arrays[name] = np.asarray(rows)
    return arrays
