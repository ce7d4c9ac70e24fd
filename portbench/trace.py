"""The device's kernel events of a ``torch.profiler`` trace, reduced to
what the per-layer metrics read: busy time as the union of the events'
intervals, each kernel's events and time, and the breakdown line.

The trace is recorded by :class:`Recorder`, which stops the profiler
and keeps its raw kineto results: ``torch.profiler`` would build a Python
event, and a tree of them, for each of the 10^5 to 10^6 events of a
window, which takes minutes. The profiler was seen to drop a few events
of a CUDA graph's replay, so a reader takes the mean time of the events
present, never their sum.
"""

from __future__ import annotations

import collections
import functools
import re
from typing import Dict, Iterable, List, Tuple

import torch

Span = Tuple[str, int, int]      # (demangled name, start ns, end ns)


class Recorder:
    """A kineto trace of the device's activity (of the host's operators
    on a CPU run) between ``start`` and ``stop``; ``stop`` returns the
    raw results, unparsed."""

    def __init__(self, cuda: bool):
        from torch.autograd import profiler

        self.cuda = cuda
        self.prof = profiler.profile(use_kineto=True, use_cpu=not cuda,
                                     use_device="cuda" if cuda else None)

    def start(self) -> None:
        self.prof.__enter__()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        results = torch.autograd._disable_profiler()
        self.prof = None
        return results


def device_spans(results) -> List[Span]:
    """Each device event of a finished trace's kineto results that is a
    kernel or a copy (not a host operator, nor the device span of a host
    annotation), with its name demangled."""
    from torch.autograd import DeviceType

    raw = [e for e in results.events()
           if not e.name().startswith("[") and not e.is_hidden_event()]
    host = {e.name() for e in raw if e.device_type() == DeviceType.CPU}
    names: Dict[str, str] = {}
    out = []
    for e in raw:
        if e.device_type() == DeviceType.CPU or e.name() in host or e.is_user_annotation():
            continue
        n = e.name()
        if n not in names:
            names[n] = torch._C._demangle(n)
        out.append((names[n], e.start_ns(), e.end_ns()))
    return out


def union_ns(spans: Iterable[Span]) -> int:
    """The length of the union of the spans' intervals: the time the
    device had an event running (a graph may run kernels at once)."""
    out, end = 0, None
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if end is None or b > end:
            out += b - (a if end is None else max(a, end))
            end = b
    return out


@functools.lru_cache(maxsize=None)
def short(name: str) -> str:
    """A kernel's name without its return type and its argument list (the
    last balanced parentheses), at most 120 letters."""
    depth = 0
    for i in range(len(name) - 1, -1, -1) if name.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            name = name[:i]
            break
    return name.removeprefix("void ")[:120]


def kernel(spans: Iterable[Span], names: Iterable[str]) -> Tuple[int, int]:
    """(events, total ns) of the kernels whose function is one of
    ``names`` (matched as a whole word of the demangled name)."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    match: Dict[str, bool] = {}
    n = total = 0
    for name, a, b in spans:
        if name not in match:
            match[name] = bool(pat.search(short(name)))
        if match[name]:
            n += 1
            total += b - a
    return n, total


def breakdown(spans: List[Span], top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each summed under the kernel the device waited to start."""
    ops: Dict[str, int] = collections.Counter()
    for name, a, b in spans:
        ops[short(name)] += b - a
    gaps: Dict[str, int] = collections.Counter()
    end = None
    for name, a, b in sorted(spans, key=lambda s: s[1]):
        if end is not None and a > end:
            gaps["before " + short(name)] += a - end
        end = b if end is None else max(end, b)
    return {"device_ops": [[n, t / 1e9] for n, t in ops.most_common(top)],
            "idle_gaps": [[n, t / 1e9] for n, t in gaps.most_common(top)]}
