"""Timing and profiling helpers of the bench, the probes and the smoke run.

- :func:`timed`: seconds per call, the clock stopped only after a value
  of the last call is on the host (``bench.py:330-345``,
  ``tools/perf_probe.py:23-35``);
- :func:`card_line`: the card's name and power limit, as ``nvidia-smi``
  gives them;
- :func:`device_spans`, :func:`by_name`, :func:`kernel_events`,
  :func:`device_union`: the device's kernel events of a ``torch.profiler``
  trace, by name or as the time the device had a kernel running;
- :func:`kernel_names`, :func:`graph_kernel_names`: the kernel nodes of a
  CUDA graph by symbol, read through libcuda, where the profiler drops the
  events of the ctypes-launched kernels.

Each raises ``RuntimeError`` where a call into libcuda fails.
"""

from __future__ import annotations

import collections
import ctypes
import subprocess
import time
from typing import Callable, Dict, Optional

import torch

# CUDA's CU_GRAPH_NODE_TYPE_KERNEL and CU_GRAPH_NODE_TYPE_GRAPH
_KERNEL_NODE, _CHILD_GRAPH_NODE = 0, 4


def timed(fn: Callable, iters: int = 6, warmup: int = 2) -> float:
    """Seconds per call of ``fn()`` over ``iters`` calls after ``warmup``.
    One element of the tensor ``fn`` returns is read back to the host
    after the warm-up and after the last call, so the clock stops only
    once every queued call has run."""
    out = None
    for _ in range(warmup):
        out = fn()
    if out is not None:
        float(out.reshape(-1)[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    float(out.reshape(-1)[0])
    return (time.perf_counter() - t0) / iters


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def power_limit_w(card: str) -> Optional[float]:
    """The power limit in W of a :func:`card_line` (None where it reads
    ``[N/A]``)."""
    try:
        return float(card.rsplit(",", 1)[1].split()[0])
    except (IndexError, ValueError):
        return None


def device_spans(prof) -> list:
    """``(name, start_ns, end_ns)`` of each device event of a finished
    ``torch.profiler`` run that is a kernel (or a copy): not a host
    operator, and not the device span of a host annotation such as
    ``Optimizer.step#Adamax.step``, which also appears on the host under
    the same name. Read from the profiler's raw kineto events: building
    its Python events takes seconds per 10^4 of them, and one IW batch's
    trace holds 10^4 to 10^5."""
    from torch.autograd import DeviceType

    raw = [e for e in prof.profiler.kineto_results.events()
           if not e.name().startswith("[") and not e.is_hidden_event()]
    host_names = {e.name() for e in raw if e.device_type() == DeviceType.CPU}
    return [(e.name(), e.start_ns(), e.end_ns()) for e in raw
            if e.device_type() != DeviceType.CPU and e.name() not in host_names
            and not e.is_user_annotation()]


def by_name(spans) -> Dict[str, list]:
    """{demangled name: [events, total ns]} of :func:`device_spans`."""
    names, out = {}, {}
    for name, a, b in spans:
        if name not in names:
            names[name] = torch._C._demangle(name)
        row = out.setdefault(names[name], [0, 0])
        row[0] += 1
        row[1] += b - a
    return out


def kernel_events(fn: Callable, want: int) -> dict:
    """{demangled kernel name: events} of the device kernels of one
    profiled call of ``fn``: the first of up to five traces whose events
    add up to ``want``, else the last. (The profiler was seen to drop some
    or all events of the ctypes-launched kernels from a trace.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    found = {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        found = {name: n for name, (n, _) in by_name(device_spans(prof)).items()}
        if sum(found.values()) >= want:
            break
    return found


def _libcuda():
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphChildGraphNodeGetGraph.argtypes = [ctypes.c_void_p,
                                                 ctypes.POINTER(ctypes.c_void_p)]
    return cu


def _ok(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUresult {status}")


def kernel_names(raw_graph: int) -> collections.Counter:
    """{kernel symbol (mangled): kernel nodes} of a captured
    ``cudaGraph_t`` (``CUDAGraph(keep_graph=True).raw_cuda_graph()``),
    child graphs' included: ``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphChildGraphNodeGetGraph``, ``cuGraphKernelNodeGetParams`` (its
    ``func`` or ``kern`` field) and ``cuFuncGetName`` /
    ``cuKernelGetName``."""
    cu = _libcuda()
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
        cu.cuGraphKernelNodeGetParams
    handle, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t(0)
    _ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = collections.Counter()
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value == _CHILD_GRAPH_NODE:
            child = ctypes.c_void_p()
            _ok(cu.cuGraphChildGraphNodeGetGraph(ctypes.c_void_p(node), ctypes.byref(child)),
                "cuGraphChildGraphNodeGetGraph")
            names += kernel_names(child.value)
        if kind.value != _KERNEL_NODE:
            continue
        params = (ctypes.c_byte * 256)()        # CUDA_KERNEL_NODE_PARAMS_v2 and room
        _ok(get_params(ctypes.c_void_p(node), params), "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p.from_buffer(params, 0).value
        kern = ctypes.c_void_p.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        if func:
            _ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)), "cuFuncGetName")
        else:
            _ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern)),
                "cuKernelGetName")
        names[name.value.decode()] += 1
    return names


def graph_kernel_names(fn: Callable) -> collections.Counter:
    """:func:`kernel_names` of a CUDA graph of one call of ``fn`` (after
    one call on a side stream): the kernels a call launches where the
    profiler drops their events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return kernel_names(graph.raw_cuda_graph())


def device_union(fn: Callable, reps: int = 1, warm: bool = True):
    """(device ms per call as the union of the kernels' intervals, the sum
    of their durations, wall ms per call, kernel events) of ``reps`` calls
    of ``fn`` under torch.profiler (device activity only, which keeps the
    trace of an eager call's ~10^5 host operators out), after one call
    outside it unless ``warm`` is False. A graph replay may run
    independent kernels at once, so the sum can exceed the wall time; the
    union is the time the device had a kernel running."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    spans = sorted((a, b) for _, a, b in device_spans(prof))
    return (union(spans) / 1e6 / reps, sum(b - a for a, b in spans) / 1e6 / reps, wall,
            len(spans))


def union(spans) -> float:
    """The length of the union of sorted ``(start, end)`` intervals."""
    out, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            out += b - max(a, end)
            end = b
    return out
