"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library and bind it
with ``ctypes``.

The library has a plain C interface (no PyTorch headers), so a cold
build takes seconds. It is built at first use into
``build/lvae_tpu_torch/<hash>/`` at the repository root, keyed by a hash
of the sources and flags, and loaded once per process. A missing
``nvcc`` or a failed build raises: there is no fallback.

Every kernel wrapper counts its launches in :data:`LAUNCHES`, adding one
where it launches the kernel and nowhere else, so a run can show that its
main path went through the kernels.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "lvae_tpu_torch"
# -fmad=false: no multiply-add contraction, so each kernel rounds every
# operation where its plain PyTorch version does (both are memory-bound;
# the FMAs would buy nothing).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

LAUNCHES = {"sample_kl": 0, "sample_kl_eps": 0, "logsumexp": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    # q, p, p_row_stride, index, sample (or NULL), sample_word, seed,
    # stream_word, z, kl, rows, c, hw, stream
    "lvae_sample_kl": (_P, _P, ctypes.c_int64, _P, _P, ctypes.c_uint32,
                       ctypes.c_uint64, ctypes.c_uint32, _P, _P, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, _P),
    # q, p, p_row_stride, eps, z, kl, rows, c, hw, stream
    "lvae_sample_kl_eps": (_P, _P, ctypes.c_int64, _P, _P, _P,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P),
    # x, k, b, out, stream
    "lvae_logsumexp": (_P, ctypes.c_int, ctypes.c_int64, _P, _P),
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
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / "liblvae_tpu_torch.so"
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    sources = [str(s) for s in srcs]
    # build to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


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


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error
    (``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        msg = library().lvae_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")
