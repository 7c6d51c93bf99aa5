"""Weave-pattern file loader for the Irawan woven-cloth BSDF (a copy of
mitsuba_tpu/io/weave.py; host Python).

Format parity with the reference's boost-spirit grammar
(src/bsdfs/irawan.h:325 WeavePatternGrammar / :278 YarnGrammar):

    /* comments */  // line comments
    weave {
        name = "Denim",
        tileWidth = 3, tileHeight = 6,
        alpha = $alpha,      /* $identifiers resolve from props */
        ...
        pattern { 1, 2, 3, ... },          /* tileWidth*tileHeight ids */
        yarn { type = warp, umax = 30, ..., kd = {0.5, 0.5, 0.4} },
        yarn { ... }
    }

Angles (psi, umax, dWarp*/dWeft*) are given in degrees and stored in
radians, matching the reference's `* M_PI / 180` actions.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

EWARP, EWEFT = 0, 1
_DEG = np.pi / 180.0

# fields converted degrees -> radians (reference grammar actions)
_WEAVE_ANGLES = {"dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
                 "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft"}
_YARN_ANGLES = {"psi", "umax"}


@dataclass
class Yarn:
    type: int = EWARP
    psi: float = 0.0
    umax: float = 0.0
    kappa: float = 0.0
    width: float = 0.0
    length: float = 0.0
    centerU: float = 0.0
    centerV: float = 0.0
    kd: tuple = (0.0, 0.0, 0.0)
    ks: tuple = (0.0, 0.0, 0.0)


@dataclass
class WeavePattern:
    name: str = ""
    tileWidth: int = 1
    tileHeight: int = 1
    ss: float = 0.0
    alpha: float = 0.0
    beta: float = 0.0
    warpArea: float = 0.0
    weftArea: float = 0.0
    hWidth: float = 0.0
    dWarpUmaxOverDWarp: float = 0.0
    dWarpUmaxOverDWeft: float = 0.0
    dWeftUmaxOverDWarp: float = 0.0
    dWeftUmaxOverDWeft: float = 0.0
    fineness: float = 0.0
    period: float = 0.0
    pattern: list = field(default_factory=list)   # 1-based yarn ids
    yarns: list = field(default_factory=list)

    def grid(self) -> np.ndarray:
        """(tileHeight, tileWidth) array of 0-based yarn indices —
        pattern[x + y*tileWidth] indexing (irawan.cpp:118)."""
        a = np.asarray(self.pattern, np.int32) - 1
        return a.reshape(self.tileHeight, self.tileWidth)

    def warp_grid(self) -> np.ndarray:
        """(tileHeight, tileWidth) bool: cell covered by a warp yarn."""
        types = np.asarray([y.type for y in self.yarns], np.int32)
        return types[self.grid()] == EWARP


class WeaveParseError(ValueError):
    pass


def _tokenize(text: str):
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return re.findall(
        r'"[^"]*"|\$[A-Za-z_][A-Za-z0-9_]*|[A-Za-z_][A-Za-z0-9_]*'
        r'|-?\d+\.?\d*(?:[eE][-+]?\d+)?|[{}=,]', text)


class _Cursor:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise WeaveParseError("unexpected end of input")
        self.i += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise WeaveParseError(f"expected {t!r}, got {got!r}")


def _flt(cur: _Cursor, props: dict) -> float:
    t = cur.next()
    if t.startswith("$"):
        key = t[1:]
        if key not in props:
            raise WeaveParseError(f"undefined parameter ${key}")
        return float(props[key])
    return float(t)


def _spec(cur: _Cursor, props: dict):
    if cur.peek() == "{":
        cur.next()
        r = _flt(cur, props)
        cur.expect(",")
        g = _flt(cur, props)
        cur.expect(",")
        b = _flt(cur, props)
        cur.expect("}")
        return (r, g, b)
    t = cur.next()
    if t.startswith("$"):
        v = props[t[1:]]
        if isinstance(v, (int, float)):
            return (float(v),) * 3
        return tuple(float(c) for c in v)
    raise WeaveParseError(f"expected spectrum, got {t!r}")


def _parse_yarn(cur: _Cursor, props: dict) -> Yarn:
    cur.expect("{")
    y = Yarn()
    while True:
        key = cur.next()
        if key == "}":
            break
        cur.expect("=")
        if key == "type":
            t = cur.next()
            y.type = EWARP if t == "warp" else EWEFT
        elif key in ("kd", "ks"):
            setattr(y, key, _spec(cur, props))
        elif key in _YARN_ANGLES:
            setattr(y, key, _flt(cur, props) * _DEG)
        else:
            setattr(y, key, _flt(cur, props))
        if cur.peek() == ",":
            cur.next()
    return y


def load_weave_string(text: str, props: dict | None = None) -> WeavePattern:
    props = props or {}
    cur = _Cursor(_tokenize(text))
    cur.expect("weave")
    cur.expect("{")
    w = WeavePattern()
    while True:
        key = cur.peek()
        if key == "}":
            cur.next()
            break
        cur.next()
        if key == ",":
            continue
        if key == "yarn":
            w.yarns.append(_parse_yarn(cur, props))
            continue
        if key == "pattern":
            cur.expect("{")
            while cur.peek() != "}":
                t = cur.next()
                if t != ",":
                    w.pattern.append(int(float(t)))
            cur.next()
            continue
        cur.expect("=")
        if key == "name":
            w.name = cur.next().strip('"')
        elif key in ("tileWidth", "tileHeight"):
            setattr(w, key, int(_flt(cur, props)))
        elif key in _WEAVE_ANGLES:
            setattr(w, key, _flt(cur, props) * _DEG)
        else:
            setattr(w, key, _flt(cur, props))
    n = w.tileWidth * w.tileHeight
    if len(w.pattern) != n:
        raise WeaveParseError(
            f"pattern has {len(w.pattern)} entries, need "
            f"tileWidth*tileHeight = {n}")
    for pid in w.pattern:
        if not (1 <= pid <= len(w.yarns)):
            raise WeaveParseError(f"pattern id {pid} out of range "
                                  f"(1..{len(w.yarns)})")
    return w


def load_weave(path: str, props: dict | None = None) -> WeavePattern:
    with open(path) as f:
        return load_weave_string(f.read(), props)
