"""Drivers of the port's cost probes of the card, one module per TPU probe
script of scripts/ (the reference's, which stay as they are):

    python -m mitsuba_tpu_torch.probes.kernel_cost     # exp_kernel_cost.py
    python -m mitsuba_tpu_torch.probes.r3_kernel       # exp_r3_kernel.py
    python -m mitsuba_tpu_torch.probes.r3_mt           # exp_r3_mt.py
    python -m mitsuba_tpu_torch.probes.r3_refinebits   # exp_r3_refinebits.py
    python -m mitsuba_tpu_torch.probes.r5_megakernel   # exp_r5_megakernel.py

Each `main()` runs on the card and prints the card's name and power
limit, then one JSON line per probe and form: the TPU script and line it
stands for, the shape, the sizes run (the two of a slope), the times, the time
per step, item or launch, the rate, and the bound of that work (the
larger of its bytes over 3.35 TB/s and its operations over the peak rate
of their type; a floor does no work: `bound_by` "none"). The per-block
form runs one copy, as one 128-thread block (one SM of 132:
`one_sm_bound_ns` is the bound at 1/132 of the card's rates) but for the
spread products (kernel_cost.py), whose copy takes the blocks that its
launch counts as they run (`shape["blocks_launched"]`; no
`one_sm_bound_ns` where that is more than one); the card form 8,192
copies, as a 1,048,576-lane wavefront gives.

Each module's `run(device, sizes)` returns the lines. On a CPU device it
runs the plain versions at the sizes given, once each, and measures no
time (the tests' use).
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# H100 SXM data sheet, dense, at its 700 W limit
PEAK = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
SMS = 132
CARD_BLOCKS = 8192        # 128-lane blocks of a 1,048,576-lane wavefront
REPS = 3                  # timed runs per size, after one warm-up


_CARDS = {}


def card(device) -> dict:
    """The device's name and, on the card, its power limit as nvidia-smi
    reports them (asked once per device)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    idx = dev.index or 0
    if idx not in _CARDS:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        smi = out[idx] if idx < len(out) else out[0]
        _CARDS[idx] = {"name": torch.cuda.get_device_name(idx),
                       "power_limit": smi.split(",")[-1].strip()}
    return _CARDS[idx]


def timed_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time (ms) of fn() over `reps` runs, after one
    warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = REPS) -> float:
    """Device time (ms) per call of fn(), for calls whose kernels are
    shorter than their host work (a wrapper's checks, allocations and
    launch), where CUDA events around each call would time the host: the
    stream is first held by a spin kernel that outlasts the host's
    enqueueing of `reps` calls, so the events then time the calls' kernels
    back to back. fn must not synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # cycles at up to 2 GHz for twice the enqueueing time, and 5 ms more
    torch.cuda._sleep(int(2e9 * (2 * host_s * reps + 5e-3)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ns(ops: float = 0.0, nbytes: float = 0.0, kind: str = "fp32"):
    """(ns, bound_by) of work of `ops` operations of type `kind` and
    `nbytes` bytes on the whole card; (None, "none") without work."""
    if not ops and not nbytes:
        return None, "none"
    t_ops = ops / PEAK[kind] * 1e9
    t_bytes = nbytes / PEAK_BYTES * 1e9
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def measure(device, run, sizes, unit: str, work=None, rate=None,
            rate_unit=None, kind: str = "fp32", blocks: int = 1,
            blocks_of=None, **line):
    """One probe line: run(n) at each of `sizes` (one size: the device
    time per call; two: the slope between them of the CUDA-event times,
    per unit of n, which cancels the host's share). work(n, blocks) ->
    (ops, bytes) of run(n) on all its blocks, for the bound (none: a
    floor); rate(n, blocks) -> the amount counted in `rate_unit`
    (default: the ops, or for a bytes-only probe the bytes). blocks_of:
    for a probe whose copy spans several blocks, blocks_of(fn) -> the
    blocks that fn()'s launch ran; on the card those of run(sizes[0]) go
    to `shape["blocks_launched"]`, and the line has `one_sm_bound_ns` only
    where they are one. On a CPU device run(n) runs once per size and no
    time is measured."""
    dev = torch.device(device)
    res = dict(form="block" if blocks == 1 else "card", blocks=blocks,
               unit=unit, slope=list(sizes) if len(sizes) == 2 else None,
               device=card(dev)["name"])
    res.update(line)
    if dev.type != "cuda":
        for n in sizes:
            run(n)
        return dict(res, ms=None, ns_per_unit=None, rate=None,
                    bound_ns=None, bound_by=None)
    if blocks_of:
        res["shape"] = dict(res.get("shape", {}),
                            blocks_launched=blocks_of(lambda: run(sizes[0])))
    if len(sizes) == 2:
        ms = [timed_ms(lambda n=n: run(n)) for n in sizes]
    else:
        ms = [device_ms(lambda: run(sizes[0]))]
    if len(sizes) == 2:
        per = (ms[1] - ms[0]) / (sizes[1] - sizes[0]) * 1e6
        d_ops, d_bytes = (np.subtract(work(sizes[1], blocks),
                                       work(sizes[0], blocks))
                          if work else (0.0, 0.0))
        n_units = sizes[1] - sizes[0]
    else:
        per = ms[0] / sizes[0] * 1e6
        d_ops, d_bytes = work(sizes[0], blocks) if work else (0.0, 0.0)
        n_units = sizes[0]
    b_ns, b_by = bound_ns(d_ops / n_units, d_bytes / n_units, kind)
    res.update(ms=ms, ns_per_unit=per, bound_ns=b_ns, bound_by=b_by)
    if rate:
        amount = rate(sizes[-1], blocks) - (
            rate(sizes[0], blocks) if len(sizes) == 2 else 0)
    else:
        amount = d_ops if d_ops else d_bytes
    res["rate"] = amount / n_units / (per * 1e-9) if amount and per > 0 \
        else None
    res["rate_unit"] = rate_unit
    if res.get("shape", {}).get("blocks_launched", blocks) == 1 and \
            b_ns is not None:
        res["one_sm_bound_ns"] = b_ns * SMS
    return res


def both_forms(device, make, block_sizes, card_sizes, **kw):
    """The per-block and the card form of one probe: make(blocks) -> the
    run(n) of `measure`."""
    return [measure(device, make(1), block_sizes, blocks=1, **kw),
            measure(device, make(CARD_BLOCKS), card_sizes,
                    blocks=CARD_BLOCKS, **kw)]


def print_lines(device, lines):
    info = card(device)
    print(f"{info['name']}, {info['power_limit']}", flush=True)
    for ln in lines:
        print(json.dumps(ln), flush=True)


def main_of(run):
    """The `main()` of a driver module: run on the card, print the lines;
    without a card it raises."""
    if not torch.cuda.is_available():
        raise SystemExit("the probes run on a CUDA device")
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    lines = run(device)
    print_lines(device, lines)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
