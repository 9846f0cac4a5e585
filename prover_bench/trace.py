"""The traced window: ``torch.profiler`` over the window's proofs, reduced
to what the per-layer metrics read.

The harness marks each proof (``pb:proof``) and each ``PhaseTimer`` phase
(``pb:phase:<name>``) with ``record_function``, so the host's spans and
the device's operations come from one clock, the profiler's.  The reduction
reads the profiler's raw events (no per-event Python objects beyond one
pass) and gives:

- the device's busy seconds (the union of kernel, copy and fill intervals)
  inside the window, and the window's length;
- each kernel family's launches and device seconds (``families/``);
- the device operations that took most time, and the idle time by what
  the host was doing (the innermost span over each gap).
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, NamedTuple

PROOF_SPAN = "pb:proof"
PHASE_SPAN = "pb:phase:"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class TraceIncomplete(RuntimeError):
    """The profiler saw other launches than the kernels' counters hold."""


class Summary(NamedTuple):
    busy_s: float
    window_s: float
    proofs: int
    families: Dict[str, Dict[str, float]]   # family -> launches, seconds
    launches: Dict[str, int]                 # counter -> launches seen
    device_ops: list
    idle_gaps: list
    outside: Dict[str, int] = {}             # counter -> launches seen
                                             # outside the window


def load_families(root: Path) -> Dict[str, Dict[str, str]]:
    """{family: {kernel name: launch counter}} from every
    ``families/<family>/*.json`` file (``{"kernels": {name: counter}}``)."""
    fams: Dict[str, Dict[str, str]] = defaultdict(dict)
    for path in sorted((root / "prover_bench" / "families").glob("*/*.json")):
        fams[path.parent.name].update(json.loads(path.read_text())["kernels"])
    return dict(fams)


def _mangled(name: str) -> str:
    """The function's own identifier in an Itanium-mangled name:
    ``_Z16leaf_hash_kernelPKm`` and
    ``_ZN12_GLOBAL__N_116leaf_hash_kernelEPKm`` -> ``leaf_hash_kernel``."""
    i = 3 if name.startswith("_ZN") else 2
    ident = ""
    while True:
        m = re.match(r"\d+", name[i:])
        if not m:
            return ident
        n = int(m.group(0))
        i += m.end()
        ident = name[i:i + n]
        i += n
        if not name.startswith("_ZN"):
            return ident


def kernel_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces, template
    arguments and parameters: ``void (anonymous namespace)::f<2>(unsigned
    long const*)`` -> ``f``, ``void at::native::g<float>(...)`` ->
    ``at::native::g``; a mangled name's own identifier."""
    if name.startswith("_Z"):
        return _mangled(name)
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        i = name.find(stop)
        if i >= 0:
            name = name[:i]
    return name.strip()


def _own(name: str) -> str:
    """The last component of a qualified kernel name: a family names its
    kernels unqualified."""
    return name.rsplit("::", 1)[-1]


def _kind(ev) -> str:
    """The event's kineto activity type; where this torch's events do not
    say, told from the device and the name: on the card a name of ours is
    the annotation's shadow, a ``cuda...`` name a runtime call, a
    ``Memcpy``/``Memset`` a copy or a fill, a ``Sync`` a wait, anything
    else a kernel."""
    at = getattr(ev, "activity_type", None)
    if at is not None:
        return at()
    name = ev.name()
    if "CUDA" not in str(ev.device_type()):
        return "user_annotation" if name.startswith("pb:") else "cpu_op"
    if name.startswith("pb:"):
        return "gpu_user_annotation"
    if name.startswith("cuda"):
        return "cuda_runtime"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if "Sync" in name:
        return "cuda_sync"
    return "kernel"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, families: Dict[str, Dict[str, str]]) -> Summary:
    proofs, phases, device = [], [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind == "user_annotation":
            name = ev.name()
            if name == PROOF_SPAN:
                proofs.append((ev.start_ns(), ev.end_ns()))
            elif name.startswith(PHASE_SPAN):
                phases.append((ev.start_ns(), ev.end_ns(),
                               name[len(PHASE_SPAN):]))
        elif kind in DEVICE_ACTIVITIES:
            device.append((ev.start_ns(), ev.end_ns(), ev.name()))
    if not proofs:
        raise TraceIncomplete("the trace holds no proof span")
    w0 = min(s for s, _ in proofs)
    w1 = max(e for _, e in proofs)

    by_kernel = defaultdict(lambda: [0, 0])
    intervals = []
    off = defaultdict(int)
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            off[_own(kernel_name(name))] += 1
            continue
        intervals.append((s, e))
        k = by_kernel[kernel_name(name)]
        k[0] += 1
        k[1] += e - s
    busy = _merge(intervals)
    busy_ns = sum(e - s for s, e in busy)

    own = defaultdict(lambda: [0, 0])
    for name, (n, ns) in by_kernel.items():
        own[_own(name)][0] += n
        own[_own(name)][1] += ns
    launches: Dict[str, int] = defaultdict(int)
    outside: Dict[str, int] = defaultdict(int)
    fam_out = {}
    for fam, kernels in families.items():
        n, ns = 0, 0
        for k, counter in kernels.items():
            seen = own.get(k, (0, 0))
            n += seen[0]
            ns += seen[1]
            launches[counter] += seen[0]
            outside[counter] += off.get(k, 0)
        fam_out[fam] = {"launches": n, "seconds": ns / 1e9}

    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:TOP]
    device_ops = [[name, ns / 1e9] for name, (_, ns) in ops]

    # idle gaps, each labelled with the innermost host span over its middle
    # by start, the longer first: scanning back from a point meets the
    # innermost span holding it first
    spans = sorted([(s, e, "api") for s, e in proofs] + phases,
                   key=lambda sp: (sp[0], -sp[1]))
    starts = [s for s, _, _ in spans]
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = defaultdict(lambda: [0, 0, 0])
    for s, e in gaps:
        mid = (s + e) // 2
        label = "harness"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            ss, se, name = spans[i]
            if ss <= mid < se:
                label = name
                break
            if name == "api":
                break   # proofs are disjoint: no earlier span holds mid
        g = idle[label]
        g[0] += 1
        g[1] += e - s
        g[2] = max(g[2], e - s)
    idle_gaps = [[f"{label}: {n} gaps, longest {mx / 1e9:.6f} s", ns / 1e9]
                 for label, (n, ns, mx) in
                 sorted(idle.items(), key=lambda kv: -kv[1][1])[:TOP]]
    return Summary(busy_ns / 1e9, (w1 - w0) / 1e9, len(proofs), fam_out,
                   dict(launches), device_ops, idle_gaps,
                   {c: n for c, n in outside.items() if n})


def check_launches(summary: Summary, expected: Dict[str, int]) -> None:
    """Raise where the profiler saw other launches of a family's kernels
    than their counters say the window made."""
    wrong = {c: (summary.launches.get(c, 0), n) for c, n in expected.items()
             if summary.launches.get(c, 0) != n}
    if wrong:
        raise TraceIncomplete(
            "profiler launches != counters (seen, counted): " +
            ", ".join(f"{c} {s} != {n}" for c, (s, n) in sorted(wrong.items()))
            + "; records of these counters outside the window: " +
            (", ".join(f"{c} {n}" for c, n in sorted(summary.outside.items())
                       if c in wrong) or "none")
            + "; the device operations that took most time: " +
            ", ".join(f"{n} {t:.6f} s" for n, t in summary.device_ops))
