"""The traced batches: `torch.profiler` over one batch, its Chrome trace
read back, and the reductions the per-layer metrics read.

- `device_only` batch: CUDA activity alone, so the host runs at its plain
  speed and the device's busy share is not diluted by the profiler's
  host-op tracing. It gives the device operations, their count, the busy
  seconds within the batch's wall and the kernels' device time by name.
- `with_host` batch: host operations too, and the benchmark's own spans
  (`system.instrument`). Each device operation is attributed to the spans
  that were open on the host thread when it was launched (the launch's
  runtime or driver call, matched by its correlation id; the count of
  operations without one is logged). Each idle gap of the device is named
  by what the host was doing when it opened.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import Counter, defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


def profile(run, with_host):
    """Run `run()` (which synchronises at its end) under the profiler;
    returns (its result, the Chrome trace's complete events)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if with_host:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events["traceEvents"] if isinstance(events, dict) else events
    return out, [e for e in events if e.get("ph") == "X"]


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


class DeviceSummary:
    """What the device did in a device-only traced batch of `wall` seconds."""

    def __init__(self, events, wall):
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.wall_s = wall
        self.ops = len(dev)
        self.busy_s = _union_us([(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in dev]) / 1e6
        self.by_name = defaultdict(float)  # device seconds by operation name
        self.count_by_name = Counter()
        for e in dev:
            self.by_name[e["name"]] += e.get("dur", 0.0) / 1e6
            self.count_by_name[e["name"]] += 1

    def seconds(self, parts):
        """(device seconds, count) of the operations whose name holds one
        of `parts` (a kernel's name comes demangled: "void
        factor_t1_reg_kernel<float, ...>(...)")."""
        names = [n for n in self.by_name if any(p in n for p in parts)]
        return sum(self.by_name[n] for n in names), sum(self.count_by_name[n] for n in names)

    def top(self, k=10):
        return [[n, s] for n, s in sorted(self.by_name.items(), key=lambda kv: -kv[1])[:k]]


def _enclosing(intervals, times):
    """For each time in `times` (sorted or not), the tuple of the names of
    the (start, end, name) intervals that contain it, outermost first
    (intervals nest, as spans on one thread do)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, j = [None] * len(times), [], 0
    for i in order:
        t = times[i]
        while j < len(ivs) and ivs[j][0] <= t:
            while stack and stack[-1][1] <= ivs[j][0]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(iv[2] for iv in stack if iv[0] <= t <= iv[1])
    return out


class HostAttribution:
    """Device time by the benchmark's spans in a traced batch with host
    operations (`seconds`), and `gaps`, the device's idle time by what
    the host was doing."""

    def __init__(self, events, labels_prefixes=("oracle.", "kkt.", "differentiation.")):
        dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = e
        spans = [
            (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"], e.get("tid"))
            for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith(labels_prefixes)
        ]
        tids = Counter(iv[3] for iv in spans)
        main_tid = tids.most_common(1)[0][0] if tids else None
        spans = [iv[:3] for iv in spans if iv[3] == main_tid]
        times, idx = [], []
        for k, e in enumerate(dev):
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is not None:
                times.append(launch["ts"])
                idx.append(k)
        chains = [None] * len(dev)
        for k, chain in zip(idx, _enclosing(spans, times)):
            chains[k] = chain
        self.linked, self.unlinked = len(idx), len(dev) - len(idx)
        self.chains = chains
        self.dev = dev
        self.gaps = self._gaps(events, dev, main_tid)

    def seconds(self, prefix, outside=()):
        """Device seconds of operations launched inside a span whose label
        starts with `prefix`, and inside none that starts with one of
        `outside`."""
        total = 0.0
        for e, chain in zip(self.dev, self.chains):
            chain = chain or ()
            if any(c.startswith(prefix) for c in chain) and not any(c.startswith(outside) for c in chain if outside):
                total += e.get("dur", 0.0) / 1e6
        return total

    @staticmethod
    def _gaps(events, dev, main_tid, k=10):
        """[[host activity, idle seconds]]: the device's idle gaps between
        its operations, summed by the innermost span and host operation
        open on the main thread when the gap opened, largest first."""
        host = [
            (e["ts"], e["ts"] + e.get("dur", 0.0), (e["cat"], e["name"]))
            for e in events
            if e.get("cat") in HOST_CATS and e.get("tid") == main_tid
        ]
        starts, lengths, end = [], [], None
        for e in dev:
            if end is not None and e["ts"] > end:
                starts.append(end)
                lengths.append(e["ts"] - end)
            end = max(end or e["ts"], e["ts"] + e.get("dur", 0.0))
        totals = defaultdict(float)
        for chain, us in zip(_enclosing(host, starts), lengths):
            spans = [n for cat, n in chain if cat == "user_annotation"]
            ops = [n for cat, n in chain if cat == "cpu_op"]
            totals[f"{spans[-1] if spans else 'solve loop'}/{ops[-1] if ops else 'python'}"] += us / 1e6
        return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]
