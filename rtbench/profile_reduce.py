"""From a torch.profiler trace to the numbers the per-layer metrics read.

The traced run wraps every frame in a ``rtbench.frame`` span
(``torch.profiler.record_function``) and exports the profile as a Chrome
trace. ``summarize`` reduces its events to one rank's summary:

- the traced window: the frames' own time, the union of the frame
  spans (the benchmark's work between frames is left out);
- busy: the union of the intervals in which a kernel, a copy or a
  memset ran on the card, clipped to the frame spans (overlapping
  operations count once);
- device time, runs and threads (grid x block, as the trace records
  each launch) by kernel, copies by kind (DtoH, HtoD, DtoD) and
  memsets. A CUDA graph's kernels are all reported only if the graph
  was captured while the profiler ran: of a graph captured before, the
  profiler (torch 2.11, CUDA 12.8) reports a WHILE body's kernels on
  the loop's first iteration alone, so the traced run starts profiling
  before its warm frame, which captures the graphs;
- the host's runtime calls by name (``cuda_runtime`` / ``cuda_driver``
  events): kernel and graph launches, copies, memsets;
- idle gaps: the stretches of the window with nothing on the card, each
  named by the innermost host event open at its middle.
"""

from __future__ import annotations

import bisect
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
FRAME_SPAN = "rtbench.frame"
LABEL_LOOKBACK = 512   # host events searched back for one open at a gap
# the host's calls that start work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
COPY_CALLS = ("cudaMemcpy", "cudaMemcpyAsync", "cudaMemset",
              "cudaMemsetAsync", "cuMemcpyAsync", "cuMemsetD8Async",
              "cuMemsetD32Async")


def kernel_name(key: str) -> str:
    """A kernel's function name without namespace, template arguments or
    parameters (copies and memsets keep their first 60 characters)."""
    if key.startswith(("Memcpy", "Memset")):
        return key[:60]
    name = key.replace("(anonymous namespace)::", "")
    name = re.split(r"[(<]", name, maxsplit=1)[0].split("::")[-1]
    return (name.split()[-1] if name.strip() else key)[:60]


def _threads(args: dict) -> int:
    """A kernel launch's threads, grid x block, from its trace args (0
    where the trace records no launch shape)."""
    n = 1
    for key in ("grid", "block"):
        dims = args.get(key)
        if not isinstance(dims, list) or not dims:
            return 0
        for d in dims:
            n *= int(d)
    return n


def load_chrome_trace(path: str) -> list:
    """The complete ("X") events of an exported Chrome trace as dicts
    with cat, name, ts and dur (microseconds), and a kernel's threads."""
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    out = []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        d = {"cat": e.get("cat", ""), "name": e.get("name", ""),
             "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0))}
        if d["cat"] == "kernel":
            d["threads"] = _threads(e.get("args") or {})
        out.append(d)
    return out


def union(intervals) -> list:
    """Merged, sorted (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _label_gaps(gaps, host) -> dict:
    """Seconds of idle gap by the innermost host event open at each
    gap's middle (the latest-starting one that has not ended)."""
    host = sorted(host, key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    out: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host: nothing traced"
        for j in range(i, max(i - LABEL_LOOKBACK, -1), -1):
            if host[j]["ts"] + host[j]["dur"] >= mid:
                label = host[j]["name"][:60]
                break
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def clip(merged: list, spans: list) -> list:
    """The parts of merged (sorted, disjoint) intervals that lie inside
    the sorted, disjoint spans."""
    out = []
    i = 0
    for a, b in spans:
        while i < len(merged) and merged[i][1] <= a:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < b:
            out.append((max(merged[j][0], a), min(merged[j][1], b)))
            j += 1
    return out


def summarize(events: list) -> dict:
    """One rank's summary of a traced window (times in seconds). The
    window is the frames' own time: the union of the frame spans, so the
    benchmark's work between frames is not counted as the card's idle
    time."""
    frames = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["cat"] == "user_annotation" and e["name"] == FRAME_SPAN]
    spans = union(frames)
    if not spans:
        return {"frames": 0}
    w0, w1 = spans[0][0], spans[-1][1]
    dev = [e for e in events if e["cat"] in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy_parts = clip(union((e["ts"], e["ts"] + e["dur"]) for e in dev),
                      spans)
    kernel_s: dict = {}
    kernel_n: dict = {}
    threads: dict = {}
    copy_s: dict = {}
    copy_n: dict = {}
    for e in dev:
        if e["cat"] == "kernel":
            k = kernel_name(e["name"])
            kernel_s[k] = kernel_s.get(k, 0.0) + e["dur"] * 1e-6
            kernel_n[k] = kernel_n.get(k, 0) + 1
            threads[k] = threads.get(k, 0) + e.get("threads", 0)
        else:
            parts = e["name"].split()
            kind = parts[1] if e["cat"] == "gpu_memcpy" and len(parts) > 1 \
                else "Memset"
            copy_s[kind] = copy_s.get(kind, 0.0) + e["dur"] * 1e-6
            copy_n[kind] = copy_n.get(kind, 0) + 1
    calls: dict = {}
    for e in events:
        if e["cat"] in HOST_CALL_CATS and any(a <= e["ts"] <= b
                                              for a, b in spans):
            calls[e["name"]] = calls.get(e["name"], 0) + 1
    gaps = clip(union([(a, b) for a, b in _complement(busy_parts, w0, w1)]),
                spans)
    host = [e for e in events if e["cat"] in HOST_CATS
            and e["name"] != FRAME_SPAN and e["ts"] < w1
            and e["ts"] + e["dur"] > w0]
    return {"frames": len(frames),
            "window_s": sum(b - a for a, b in spans) * 1e-6,
            "busy_s": sum(b - a for a, b in busy_parts) * 1e-6,
            "kernel_s": kernel_s, "kernel_n": kernel_n,
            "kernel_threads": threads, "copy_s": copy_s,
            "copy_n": copy_n, "host_calls": calls,
            "idle_gaps_s": _label_gaps(gaps, host)}


def _complement(parts: list, w0: float, w1: float) -> list:
    """The stretches of [w0, w1] that the sorted, disjoint parts leave."""
    out = []
    prev = w0
    for a, b in parts:
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        out.append((prev, w1))
    return out


def kernel_time(summary: dict, name: str) -> float:
    return sum(s for k, s in summary.get("kernel_s", {}).items()
               if name in k)


def kernel_runs(summary: dict, name: str) -> int:
    return sum(n for k, n in summary.get("kernel_n", {}).items()
               if name in k)


def kernel_threads(summary: dict, name: str) -> int:
    return sum(n for k, n in summary.get("kernel_threads", {}).items()
               if name in k)


def host_launch_calls(summary: dict) -> int:
    """Launch, copy and memset calls the host made in the window."""
    return sum(n for k, n in summary.get("host_calls", {}).items()
               if k in LAUNCH_CALLS or k in COPY_CALLS)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def merge_ranks(summaries: list) -> dict:
    """Several ranks' summaries added up (windows and busy summed too)."""
    out = {"frames": 0, "window_s": 0.0, "busy_s": 0.0}
    for s in summaries:
        out["frames"] = max(out["frames"], s.get("frames", 0))
        out["window_s"] += s.get("window_s", 0.0)
        out["busy_s"] += s.get("busy_s", 0.0)
        for key in ("kernel_s", "kernel_n", "kernel_threads", "copy_s",
                    "copy_n",
                    "host_calls", "idle_gaps_s"):
            acc = out.setdefault(key, {})
            for k, v in s.get(key, {}).items():
                acc[k] = acc.get(k, 0) + v
    return out


def idle_pct(summaries: list):
    """100 x (1 - summed busy / summed windows), or None without device
    activity."""
    window = sum(s.get("window_s", 0.0) for s in summaries)
    busy = sum(s.get("busy_s", 0.0) for s in summaries)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
