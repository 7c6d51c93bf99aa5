"""Native baseline JPEG codec (a copy of mitsuba_tpu/io/jpeg.py; the
reference libcore/bitmap.cpp uses libjpeg; this is a from-scratch numpy
implementation so no optional dependency is needed for LDR assets).

Decoder: baseline sequential DCT (SOF0), 8-bit, grayscale/YCbCr,
interleaved scan, 4:4:4 / 4:2:2 / 4:2:0 subsampling, restart markers.
Encoder: baseline 4:4:4 with the standard Annex-K quantization and
huffman tables at an adjustable quality factor.

Progressive (SOF2) and arithmetic-coded files raise ValueError — callers
(io.bitmap.read_image) fall back to PIL when present.
"""
from __future__ import annotations

import numpy as np

# --- JPEG constants --------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# Annex K.1 quantization tables
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.float64)
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.float64)

# Annex K.3 huffman tables: (bits[1..16], values)
_HT_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               list(range(12)))
_HT_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                 list(range(12)))
_HT_AC_LUMA = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
     0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
     0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
     0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
     0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
     0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
     0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
     0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
     0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
     0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
     0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_HT_AC_CHROMA = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
     0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
     0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
     0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
     0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
     0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
     0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
     0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
     0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
     0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
     0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
     0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _idct_2d(block):
    """8x8 type-III DCT (orthonormal), separable via matrix products."""
    return _DCT_M.T @ block @ _DCT_M


def _dct_2d(block):
    return _DCT_M @ block @ _DCT_M.T


def _make_dct_matrix():
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m *= np.sqrt(2.0 / 8.0)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m


_DCT_M = _make_dct_matrix()


class _HuffTable:
    """Canonical huffman table; decode via (length, code) -> symbol map."""

    def __init__(self, bits, values):
        self.lookup = {}
        code = 0
        vi = 0
        self.maxlen = 0
        for ln in range(1, 17):
            for _ in range(bits[ln - 1]):
                self.lookup[(ln, code)] = values[vi]
                vi += 1
                code += 1
                self.maxlen = ln
            code <<= 1
        # encode map: symbol -> (code, length)
        self.enc = {}
        code = 0
        vi = 0
        for ln in range(1, 17):
            for _ in range(bits[ln - 1]):
                self.enc[values[vi]] = (code, ln)
                vi += 1
                code += 1
            code <<= 1


class _BitReader:
    """Entropy-coded segment reader: 0xFF00 unstuffing, restart skip."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bits = 0
        self.nbits = 0

    def _fill(self):
        d = self.data
        b = d[self.pos]
        if b == 0xFF:
            nxt = d[self.pos + 1]
            if nxt == 0x00:
                self.pos += 2
            elif 0xD0 <= nxt <= 0xD7:       # restart marker mid-fill
                raise _Restart()
            # else the entropy segment is over (EOI / the next marker):
            # pad with 1s, staying on the marker
        else:
            self.pos += 1
        # keep only the bits not read yet: the reference's reader keeps
        # every bit of the segment in one integer, which makes each read
        # cost as much as the segment is long
        self.bits = ((self.bits << 8) | b) & ((1 << (self.nbits + 8)) - 1)
        self.nbits += 8

    def read_bit(self) -> int:
        if self.nbits == 0:
            self._fill()
        self.nbits -= 1
        return (self.bits >> self.nbits) & 1

    def receive(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def decode(self, table: _HuffTable) -> int:
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | self.read_bit()
            sym = table.lookup.get((ln, code))
            if sym is not None:
                return sym
        raise ValueError("corrupt JPEG: bad huffman code")

    def sync_restart(self):
        """Align to byte boundary and consume an RSTn marker."""
        self.nbits = 0
        d = self.data
        while d[self.pos] != 0xFF or not (0xD0 <= d[self.pos + 1] <= 0xD7):
            self.pos += 1
        self.pos += 2


class _Restart(Exception):
    pass


def _extend(v, n):
    """JPEG signed-magnitude extension (spec F.2.2.1)."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xFF\xD8":
        raise ValueError(f"{path}: not a JPEG")
    pos = 2
    qt = {}
    ht_dc, ht_ac = {}, {}
    comps = None
    w = h = 0
    restart_interval = 0
    while True:
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: expected marker")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:                  # EOI
            raise ValueError("corrupt JPEG: EOI before scan")
        seglen = int.from_bytes(data[pos:pos + 2], "big")
        seg = data[pos + 2:pos + seglen]
        if marker == 0xC0 or marker == 0xC1:        # SOF0/1 baseline
            h = int.from_bytes(seg[1:3], "big")
            w = int.from_bytes(seg[3:5], "big")
            nc = seg[5]
            comps = []
            for i in range(nc):
                cid, samp, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append(dict(id=cid, hs=samp >> 4, vs=samp & 15,
                                  tq=tq))
        elif marker == 0xC2:
            raise ValueError("progressive JPEG unsupported (use PIL)")
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError("non-baseline JPEG unsupported (use PIL)")
        elif marker == 0xC4:                # DHT
            p = 0
            while p < len(seg):
                tc_th = seg[p]
                bits = list(seg[p + 1:p + 17])
                n = sum(bits)
                values = list(seg[p + 17:p + 17 + n])
                tbl = _HuffTable(bits, values)
                if tc_th >> 4 == 0:
                    ht_dc[tc_th & 15] = tbl
                else:
                    ht_ac[tc_th & 15] = tbl
                p += 17 + n
        elif marker == 0xDB:                # DQT
            p = 0
            while p < len(seg):
                pq_tq = seg[p]
                if pq_tq >> 4 == 0:
                    tbl = np.frombuffer(seg[p + 1:p + 65], np.uint8)
                    p += 65
                else:
                    tbl = np.frombuffer(seg[p + 1:p + 129],
                                        ">u2").astype(np.uint16)
                    p += 129
                qt[pq_tq & 15] = tbl.astype(np.float64)
        elif marker == 0xDD:                # DRI
            restart_interval = int.from_bytes(seg[:2], "big")
        elif marker == 0xDA:                # SOS: start entropy decode
            ns = seg[0]
            scomp = []
            for i in range(ns):
                cs, td_ta = seg[1 + 2 * i:3 + 2 * i]
                c = next(c for c in comps if c["id"] == cs)
                c["td"] = td_ta >> 4
                c["ta"] = td_ta & 15
                scomp.append(c)
            pos += seglen
            break
        pos += seglen

    hmax = max(c["hs"] for c in comps)
    vmax = max(c["vs"] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    planes = []
    for c in comps:
        pw, ph = mcux * 8 * c["hs"], mcuy * 8 * c["vs"]
        planes.append(np.zeros((ph, pw), np.float64))

    br = _BitReader(data, pos)
    pred = [0] * len(comps)
    mcu_i = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and mcu_i and mcu_i % restart_interval == 0:
                br.sync_restart()
                pred = [0] * len(comps)
            mcu_i += 1
            for ci, c in enumerate(comps):
                for by in range(c["vs"]):
                    for bx in range(c["hs"]):
                        zz = np.zeros(64, np.float64)
                        t = br.decode(ht_dc[c["td"]])
                        diff = _extend(br.receive(t), t)
                        pred[ci] += diff
                        zz[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = br.decode(ht_ac[c["ta"]])
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break       # EOB
                            k += r
                            zz[k] = _extend(br.receive(s), s)
                            k += 1
                        blk = np.zeros(64, np.float64)
                        blk[_ZIGZAG] = zz * qt[c["tq"]]
                        px = _idct_2d(blk.reshape(8, 8)) + 128.0
                        y0 = (my * c["vs"] + by) * 8
                        x0 = (mx * c["hs"] + bx) * 8
                        planes[ci][y0:y0 + 8, x0:x0 + 8] = px

    # upsample chroma to full res, crop, color-convert. 2x factors use
    # libjpeg's "fancy" triangular filter (out = (3*near + far + c)/4 per
    # axis) so decodes match the de-facto reference decoder closely.
    def _up2(pl, axis):
        near = np.repeat(pl, 2, axis=axis)
        lo = np.concatenate([pl.take([0], axis), pl], axis)
        hi = np.concatenate([pl, pl.take([-1], axis)], axis)
        far = np.empty_like(near)
        sl_even = [slice(None)] * 2
        sl_odd = [slice(None)] * 2
        sl_even[axis] = slice(0, None, 2)
        sl_odd[axis] = slice(1, None, 2)
        far[tuple(sl_even)] = lo.take(range(pl.shape[axis]), axis)
        far[tuple(sl_odd)] = hi.take(range(1, pl.shape[axis] + 1), axis)
        return (3.0 * near + far) / 4.0

    full = []
    for c, pl in zip(comps, planes):
        ry, rx = vmax // c["vs"], hmax // c["hs"]
        while rx > 1:
            pl = _up2(pl, 1) if rx == 2 else np.repeat(pl, rx, axis=1)
            rx //= 2 if rx == 2 else rx
        while ry > 1:
            pl = _up2(pl, 0) if ry == 2 else np.repeat(pl, ry, axis=0)
            ry //= 2 if ry == 2 else ry
        full.append(pl[:h, :w])
    if len(full) == 1:
        return np.clip(full[0] + 0.5, 0, 255).astype(np.uint8)
    y, cb, cr = full[0], full[1] - 128.0, full[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], -1) + 0.5, 0, 255).astype(np.uint8)


# --- encoder ----------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)   # byte stuffing
                self.acc = 0
                self.n = 0

    def flush(self):
        while self.n:
            self.put(1, 1)                  # pad with 1s


def _scale_q(q: np.ndarray, quality: int) -> np.ndarray:
    quality = min(max(quality, 1), 100)
    s = 5000 / quality if quality < 50 else 200 - quality * 2
    return np.clip(np.floor((q * s + 50) / 100), 1, 255)


def write_jpeg(path: str, img: np.ndarray, quality: int = 90) -> None:
    """Baseline 4:4:4 encoder with Annex-K tables."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float64) * 255 + 0.5,
                      0, 255).astype(np.uint8)
    gray = img.ndim == 2 or img.shape[-1] == 1
    if gray:
        planes = [np.asarray(img.reshape(img.shape[0], img.shape[1]),
                             np.float64)]
    else:
        rgb = img[..., :3].astype(np.float64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
        planes = [y, cb, cr]
    h, w = planes[0].shape
    qluma = _scale_q(_Q_LUMA, quality)
    qchroma = _scale_q(_Q_CHROMA, quality)
    qts = [qluma] + ([qchroma] if not gray else [])
    dc_t = [_HuffTable(*_HT_DC_LUMA), _HuffTable(*_HT_DC_CHROMA)]
    ac_t = [_HuffTable(*_HT_AC_LUMA), _HuffTable(*_HT_AC_CHROMA)]

    out = bytearray(b"\xFF\xD8")            # SOI
    # DQT
    for tq, q in enumerate(qts):
        out += b"\xFF\xDB" + (67).to_bytes(2, "big") + bytes([tq])
        out += bytes(q[_ZIGZAG].astype(np.uint8).tolist())
    # SOF0
    nc = 1 if gray else 3
    sof = bytearray([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") \
        + bytes([nc])
    for ci in range(nc):
        sof += bytes([ci + 1, 0x11, 0 if ci == 0 else 1])
    out += b"\xFF\xC0" + (len(sof) + 2).to_bytes(2, "big") + sof
    # DHT
    for tc, tables in ((0, (_HT_DC_LUMA, _HT_DC_CHROMA)),
                       (1, (_HT_AC_LUMA, _HT_AC_CHROMA))):
        for th in range(2 if not gray else 1):
            bits, values = tables[th]
            seg = bytes([tc << 4 | th]) + bytes(bits) + bytes(values)
            out += b"\xFF\xC4" + (len(seg) + 2).to_bytes(2, "big") + seg
    # SOS
    sos = bytearray([nc])
    for ci in range(nc):
        sos += bytes([ci + 1, 0 if ci == 0 else 0x11])
    sos += b"\x00\x3F\x00"
    out += b"\xFF\xDA" + (len(sos) + 2).to_bytes(2, "big") + sos

    bw = _BitWriter()
    pred = [0] * nc

    def emit_block(blk, qtab, dct, act, ci):
        coef = _dct_2d(blk - 128.0)
        q = np.round(coef.reshape(64)[_ZIGZAG] / qtab[_ZIGZAG]).astype(int)
        diff = q[0] - pred[ci]
        pred[ci] = q[0]
        mag = diff if diff >= 0 else -diff
        n = int(mag).bit_length()
        code, ln = dct.enc[n]
        bw.put(code, ln)
        if n:
            v = diff if diff >= 0 else diff + (1 << n) - 1
            bw.put(v & ((1 << n) - 1), n)
        run = 0
        last = 63
        while last > 0 and q[last] == 0:
            last -= 1
        for k in range(1, last + 1):
            if q[k] == 0:
                run += 1
                continue
            while run > 15:
                code, ln = act.enc[0xF0]
                bw.put(code, ln)
                run -= 16
            v = int(q[k])
            mag = v if v >= 0 else -v
            s = mag.bit_length()
            code, ln = act.enc[(run << 4) | s]
            bw.put(code, ln)
            vv = v if v >= 0 else v + (1 << s) - 1
            bw.put(vv & ((1 << s) - 1), s)
            run = 0
        if last < 63:
            code, ln = act.enc[0x00]
            bw.put(code, ln)

    mcux, mcuy = -(-w // 8), -(-h // 8)
    padded = [np.pad(pl, ((0, mcuy * 8 - h), (0, mcux * 8 - w)),
                     mode="edge") for pl in planes]
    for my in range(mcuy):
        for mx in range(mcux):
            for ci in range(nc):
                t = 0 if ci == 0 else 1
                blk = padded[ci][my * 8:my * 8 + 8, mx * 8:mx * 8 + 8]
                emit_block(blk, qts[t], dc_t[t], ac_t[t], ci)
    bw.flush()
    out += bw.out
    out += b"\xFF\xD9"                      # EOI
    with open(path, "wb") as f:
        f.write(bytes(out))
