"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library and bind it
with ``ctypes``.

The library has a plain C interface (no PyTorch headers), so a cold
build takes seconds: one ``nvcc`` per source, all started together, then
one link. It is built at first use into
``build/lvae_tpu_torch/<hash>/`` at the repository root, keyed by a hash
of the sources and flags, and loaded once per process. A missing
``nvcc`` or a failed build raises: there is no fallback.

Every kernel wrapper counts its launches in :data:`LAUNCHES`, adding one
where it launches the kernel and nowhere else, so a run can show that its
main path went through the kernels; a bf16 instantiation counts under its
own name (:func:`launch_name`). A CUDA graph of train steps
(``train/state.py`` ``MultiStep``) takes back the counts of its capture,
which records launches without running them, and adds the launches it
holds at each replay.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lvae_tpu_torch"
# -fmad=false: no multiply-add contraction, so each kernel rounds every
# operation where its plain PyTorch version does. The sample+KL and segment
# kernels are bound by bytes, where FMAs would buy nothing. The mixture
# kernels contract by hand (fmaf) where it pays: a throwaway build of the
# first one-pass backward with -use_fast_math, which also contracts, made it
# only 6% faster and moved it ~400x further from its plain version, and the
# redesigned one pass built with -fmad=true gained nothing over its own fmaf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

LAUNCHES = {
    "sample_kl": 0,                  # K2, keyed noise
    "sample_kl_eps": 0,              # K2, given eps
    "sample_kl_per_sample": 0,       # K1, keyed noise
    "sample_kl_per_sample_eps": 0,   # K1, given eps
    "sample_kl_bwd": 0,              # K2-bwd
    "sample_kl_per_sample_bwd": 0,   # K1-bwd
    "logsumexp": 0,                  # K4
    "mix_log_prob": 0,               # K3
    "mix_log_prob_bwd": 0,           # K3-bwd
    "segment": 0,                    # K5
    "segment_bwd": 0,                # K5-bwd
    "dropout": 0,                    # K5's bits8 dropout alone, forward and backward
    # K5 and K5-bwd over R > 1 ranks (--num-data-shards): two launches a
    # direction around the all-reduce of the statistics
    "segment_split_stats": 0,        # K5-split, this rank's sums
    "segment_split_apply": 0,        # K5-split, y from the global sums
    "segment_split_bwd_reduce": 0,   # K5-bwd-split, this rank's sums
    "segment_split_bwd_apply": 0,    # K5-bwd-split, dx from the global sums
    # the bf16 instantiations (--precision bf16), each counted apart
    "mix_log_prob[bf16]": 0,         # K3, bf16 params
    "mix_log_prob_bwd[bf16]": 0,     # K3-bwd, bf16 params and dparams
    "segment[bf16]": 0,              # K5, bf16 x and y
    "segment_bwd[bf16]": 0,          # K5-bwd, bf16 x, g and dx
    "dropout[bf16]": 0,              # the bits8 dropout, bf16 x and y
    "segment_split_stats[bf16]": 0,
    "segment_split_apply[bf16]": 0,
    "segment_split_bwd_reduce[bf16]": 0,
    "segment_split_bwd_apply[bf16]": 0,
}


def launch_name(name: str, dtype: torch.dtype) -> str:
    """The :data:`LAUNCHES` key of kernel ``name``'s instantiation for
    storage ``dtype``: the name itself for fp32, ``name[bf16]`` for bf16."""
    return f"{name}[bf16]" if dtype == torch.bfloat16 else name


def esize(dtype: torch.dtype) -> int:
    """Bytes per element of a kernel's storage dtype, as the C entry points
    take it (4: fp32, 2: bf16)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels store float32 or bfloat16, got {dtype}")
    return 4 if dtype == torch.float32 else 2

_P = ctypes.c_void_p
_I64, _U32, _U64, _INT = ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int
# q, p, p_row_stride, index, sample (or NULL), sample_word, seed, stream_word,
# the band map's plane, gplane and base (ops/philox.py band_map)
_KEYED = (_P, _P, _I64, _P, _P, _U32, _U64, _U32, _I64, _I64, _I64)
_SIGNATURES = {
    # keyed, z, kl, rows, c, hw, stream
    "lvae_sample_kl": (*_KEYED, _P, _P, _I64, _INT, _INT, _P),
    # q, p, p_row_stride, eps, z, kl, rows, c, hw, stream
    "lvae_sample_kl_eps": (_P, _P, _I64, _P, _P, _P, _I64, _INT, _INT, _P),
    # plan (kernels/stochastic.py K1Plan), keyed, eps (or NULL: keyed
    # noise), z, kl_rows, rows, c, hw, stream
    "lvae_sample_kl_per_sample": (_P, *_KEYED, _P, _P, _P, _I64, _INT, _INT, _P),
    # plan (kernels/stochastic.py BwdPlan), keyed, eps (or NULL: regenerate
    # the keyed noise), gz, gkl, dq, dp, rows, c, hw, stream
    "lvae_sample_kl_bwd": (_P, *_KEYED, _P, _P, _P, _P, _P, _I64, _INT, _INT, _P),
    "lvae_sample_kl_per_sample_bwd": (_P, *_KEYED, _P, _P, _P, _P, _P, _I64, _INT,
                                      _INT, _P),
    # plan (kernels/logsumexp.py LsePlan), x, k, b, out, stream
    "lvae_logsumexp": (_P, _P, ctypes.c_int, ctypes.c_int64, _P, _P),
    # x, params, out, b, hw, k, c, n_bins, pixels a thread (kernels/mixture.py
    # fwd_plan), params' esize, stream
    "lvae_mix_log_prob": (_P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _INT, _P),
    # x, params, g, dparams, dx (or NULL), b, hw, k, c, n_bins, the plan
    # (kernels/mixture.py PLANS index), pixels a group (bwd_plan's v), esize,
    # stream
    "lvae_mix_log_prob_bwd_plan": (_P, _P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT,
                                   _INT, _INT, _P),
    # plan (kernels/segment.py _CPlan), x, gamma, beta, running_mean,
    # running_var (or NULL), y, stats, t, act, eps, momentum, 1 - momentum,
    # train seed, dropout site, step (a device pointer; NULL without a
    # mask), stream
    "lvae_segment_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT, ctypes.c_double,
                         ctypes.c_float, ctypes.c_float, _U64, _U64, _P, _P),
    # plan, x, g, gamma, stats, dx, dgb, t, act, seed, site, step, stream
    "lvae_segment_bwd": (_P, _P, _P, _P, _P, _P, _P, _INT, _INT, _U64, _U64, _P, _P),
    # plan, direction, act, out
    "lvae_segment_max_clusters": (_P, _INT, _INT, _P),
    # x, y, n, esize, t, train seed, dropout site, step (device pointer),
    # the element map's plane, gplane and base (ops/philox.py ElementMap), stream
    "lvae_dropout_bits8": (_P, _P, _I64, _INT, _INT, _U64, _U64, _P, _I64, _I64, _I64, _P),
    # which, x, g, gamma, beta, part, local, out_part, running_mean,
    # running_var, stats, y, dgb, b, c, hw, slices, threads, esize, t, act,
    # n_global, eps, momentum, 1 - momentum, seed, site, step, the element
    # map, stream
    "lvae_segment_split": (_INT, *(_P,) * 12, _I64, _INT, _I64, _INT, _INT, _INT, _INT, _INT,
                           ctypes.c_double, ctypes.c_double, ctypes.c_float, ctypes.c_float,
                           _U64, _U64, _P, _I64, _I64, _I64, _P),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from csrc/ at first use"
        )
    return path


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet. Returns its path and
    the compiler's log (``-Xptxas -v``: registers and spills per kernel;
    empty when the library was already built)."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):       # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / "liblvae_tpu_torch.so"
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a temporary directory, then rename the library: a concurrent
    # or interrupted build never leaves a half-written one under its name
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        logs = [p.communicate()[0] for p in procs]
        lib = os.path.join(tmp, out.name)
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", lib, *objs]
        for cmd, p, log in zip(cmds, procs, logs):
            _check_run(cmd, p.returncode, log)
        res = subprocess.run(link, capture_output=True, text=True)
        _check_run(link, res.returncode, res.stdout + res.stderr)
        os.replace(lib, out)
    return out, "".join(logs)


def _check_run(cmd: list, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{log}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.lvae_error_string.argtypes = [ctypes.c_int]
    lib.lvae_error_string.restype = ctypes.c_char_p
    return lib


def on_device(t: torch.Tensor, launch):
    """``launch(stream)``, the stream the current one of ``t``'s device,
    with that device current (no device guard when it already is)."""
    if t.get_device() == torch.cuda.current_device():
        return launch(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(t.device):
        return launch(torch.cuda.current_stream().cuda_stream)


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error
    (``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        msg = library().lvae_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")
