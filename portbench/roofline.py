"""Peaks, the least time a kernel could take, and the kernels' bytes and
operations, counted from shapes alone.

A bound counts each input read once and each output written once at the
HBM rate, or the fp32 operations at the fp32 rate, whichever is longer
(frozen copies of ``chip_smoke.py`` ``bound`` and ``lvae_tpu_torch.
mixture_ab`` ``bwd_bound``, with their operation counts). The same work
is counted whatever implements it.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

from portbench import trace
from portbench.reference.model import ladder

# Published dense peaks of one NVIDIA H100 SXM (data sheet, at the 700 W
# limit): FLOP/s by precision, HBM bytes/s
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12

# fp32 operations, counted from the kernels' code (a Philox call as ~70
# integer operations, a transcendental as one): sample+KL ~110 an element
# with keyed noise, its backward ~30 more; the mixture ~40 a bin forward
# and ~80 backward (30 bins a component and channel)
OPS_SAMPLE_KL, OPS_SAMPLE_KL_BWD = 110, 30
OPS_BIN_FWD, OPS_BIN_BWD = 40, 80


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS["fp32"])


def latent_shapes(config: dict) -> List[Tuple[int, int, int]]:
    """``(c, h, w)`` of each latent layer, bottom first: the map after the
    initial stride-2 conv and each layer's stride-2 steps."""
    a, (hh, ww) = ladder(config), config["data"]["img_size"]
    out, s = [], 1
    for z, d in zip(a["zdims"], a["downsample"]):
        s += d
        out.append((z, hh >> s, ww >> s))
    return out


def sample_kl(rows: int, config: dict, train: bool, backward: bool = False) -> List[float]:
    """The bound of each layer's call of K1 (``train``), K1-bwd
    (``backward``) or K2: q and z (and gz, dq) per element, p (and dp)
    once per row of its own (the top layer's prior is one row), each
    row's index and its KL sum (K2: its sample and the KL map)."""
    shapes = latent_shapes(config)
    out = []
    for i, (c, h, w) in enumerate(shapes):
        n, p_rows = rows * c * h * w, 1 if i == len(shapes) - 1 else rows
        if backward:
            b = n * 20 + p_rows * c * h * w * 16 + rows * 12
            ops = n * (OPS_SAMPLE_KL + OPS_SAMPLE_KL_BWD)
        elif train:
            b, ops = n * 12 + p_rows * c * h * w * 8 + rows * 12, n * OPS_SAMPLE_KL
        else:
            b, ops = n * 16 + p_rows * c * h * w * 8 + rows * 16, n * OPS_SAMPLE_KL
        out.append(bound_s(b, ops))
    return out


def mixture(rows: int, config: dict, backward: bool = False, k: int = 10) -> float:
    """The bound of K3 (or K3-bwd) over ``rows`` images: the ``K(1+3C)``
    parameters, x and the log-prob a pixel (the backward adds the
    gradient in and the parameters' gradient out)."""
    (h, w), c = config["data"]["img_size"], config["data"]["color_ch"]
    q, npix = k * (1 + 3 * c), rows * h * w
    per = 4 * (q + c + 1) + (4 * q if backward else 0)
    return bound_s(npix * per, npix * k * c * (OPS_BIN_BWD if backward else OPS_BIN_FWD))


def share(ctx, label: str, parts: Sequence[Tuple[Sequence[str], str, float]]
          ) -> Optional[float]:
    """% of the roofline of a group of kernels: the sum of their bounds
    a call over the sum of their mean device times a call. ``parts``:
    ``(kernel function names, LAUNCHES key, bound of a call in s)``. The
    mean is over the events present (a dropped event biases nothing);
    where a call launches several kernels, their time over the calls.
    None where a kernel has no launch or no event."""
    bound = time = 0.0
    for names, key, per_call in parts:
        calls = ctx.launches.get(key, 0)
        n, total_ns = trace.kernel(ctx.spans, names)
        print(f"portbench: {label}: {'/'.join(names)} {n} events, {calls} launches",
              file=sys.stderr)
        if not calls or not n:
            return None
        time += total_ns / 1e9 / min(n, calls)
        bound += per_call
    return 100.0 * bound / time
