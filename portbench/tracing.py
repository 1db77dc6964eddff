"""The traced run's device timeline: ``torch.profiler`` over the window,
its Chrome trace reduced to device operations on the host clock, and the
reductions the per-layer readers and the result's ``breakdown`` share.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np

# Trace categories of work on the device (kernels, copies, fills).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "portbench.sync"


class Profiler:
    """``torch.profiler`` (host and CUDA activity) from ``start`` to
    ``stop``; ``stop`` returns the device operations as
    ``(name, start, end, grid)`` on the ``perf_counter`` clock, aligned
    through one marker range recorded at a known host time."""

    def __init__(self) -> None:
        self.prof = None
        self.t_sync = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t_sync = time.perf_counter()
        with record_function(SYNC):
            pass

    def stop(self) -> List[tuple]:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        return device_ops(events, self.t_sync)


def device_ops(events: list, t_sync: float) -> List[tuple]:
    """Device operations of a Chrome trace as (name, start, end, grid) in
    seconds on the clock on which the SYNC range began at ``t_sync``."""
    base = None
    for e in events:
        if e.get("name") == SYNC and e.get("ph") == "X":
            base = t_sync - float(e["ts"]) / 1e6
            break
    if base is None:
        raise RuntimeError("the profiler's trace lacks the sync marker")
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            t0 = float(e["ts"]) / 1e6 + base
            grid = (e.get("args") or {}).get("grid")
            out.append((e["name"], t0, t0 + float(e.get("dur", 0)) / 1e6,
                        tuple(grid) if grid else None))
    out.sort(key=lambda o: o[1])
    return out


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], merged and sorted."""
    out: List[list] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(ops, spans) -> Tuple[float, float]:
    """Seconds some device operation ran within the host intervals
    ``spans``, and their total length."""
    total = sum(b - a for a, b in spans)
    covered = 0.0
    for lo, hi in spans:
        covered += sum(b - a for a, b in union(
            [(o[1], o[2]) for o in ops if o[2] > lo and o[1] < hi], lo, hi))
    return covered, total


def gaps(ops, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of the device within [lo, hi]."""
    out, t = [], lo
    for a, b in union([(o[1], o[2]) for o in ops], lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name as the breakdown gives it: without
    ``void`` and anonymous namespaces, cut before its argument list, at
    most ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    if not name.startswith("Memcpy") and not name.startswith("Memset"):
        name = name.split("(")[0]
    return name[:width]


def top_ops(ops, spans, n: int = 10) -> List[list]:
    """The ``n`` device operations that took the most time within
    ``spans``, summed by their short names."""
    tot: Dict[str, float] = {}
    for name, a, b, _ in ops:
        key = short_name(name)
        for lo, hi in spans:
            d = min(b, hi) - max(a, lo)
            if d > 0:
                tot[key] = tot.get(key, 0.0) + d
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def label_gaps(idle, host_spans, n: int = 10,
               outside: str = "outside the program's spans") -> List[list]:
    """Idle seconds summed by the innermost program span open at each
    instant of the gaps ``idle``, the ``n`` largest.  ``host_spans``:
    (name, start, end) on the same clock.  The gaps are cut at every span
    boundary, so a long gap is shared among the spans it crosses."""
    if not idle:
        return []
    cuts = sorted({t for g in idle for t in g}
                  | {t for s in host_spans for t in s[1:]
                     if idle[0][0] < t < idle[-1][1]})
    cuts = np.array(cuts)
    mids = (cuts[:-1] + cuts[1:]) / 2
    length = np.diff(cuts)
    starts = np.array([g[0] for g in idle])
    ends = np.array([g[1] for g in idle])
    k = np.searchsorted(starts, mids, side="right") - 1
    inside = (k >= 0) & (mids < ends[np.maximum(k, 0)])
    mids, length = mids[inside], length[inside]
    best = np.full(mids.size, np.inf)
    label = np.full(mids.size, -1)
    names = sorted({s[0] for s in host_spans})
    code = {name: i for i, name in enumerate(names)}
    for name, a, b in host_spans:
        lo, hi = np.searchsorted(mids, a), np.searchsorted(mids, b, "right")
        seg = slice(lo, hi)
        hit = (b - a) < best[seg]
        best[seg] = np.where(hit, b - a, best[seg])
        label[seg] = np.where(hit, code[name], label[seg])
    tot: Dict[str, float] = {}
    for lab, d in zip(label.tolist(), length.tolist()):
        key = names[lab] if lab >= 0 else outside
        tot[key] = tot.get(key, 0.0) + d
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
