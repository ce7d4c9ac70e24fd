"""Console (and optional TensorBoard) logging with ``lvae_tpu``'s lines and
metric names (port of ``lvae_tpu/train/logging.py``): ``elbo/train``,
``recons/train``, ``kl/train``, ``loss/train``, ``kl/layer_i``,
``perf/images_per_sec``, ``<metric>/test`` and the image grids
(``samples``, ``reconstructions``, ``kl_spatial``). TensorBoard event files are
written when ``tensorboardX`` imports, as in ``lvae_tpu``; nothing else
depends on it. (``torch.utils.tensorboard`` would import TensorFlow where
it is installed: seconds per process.)"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


class MetricLogger:
    def __init__(self, run_dir: str, enable_tb: bool = True):
        self.run_dir = run_dir
        self.history: list = []       # (kind, step, host metrics) per line
        self._tb = None
        if enable_tb:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception:
                self._tb = None

    def log_train(self, step: int, ema: Mapping, images_per_sec: Optional[float] = None) -> str:
        m = {k: _host(v) for k, v in ema.items()}
        line = (
            f"[train] step {step:>7d}  elbo {float(m['elbo']):>10.2f}  "
            f"recons {float(m['ll']):>10.2f}  kl {float(m['kl']):>8.2f}"
        )
        if images_per_sec is not None:
            line += f"  {images_per_sec:>8.0f} img/s"
            m["images_per_sec"] = images_per_sec
        print(line, flush=True)
        self.history.append(("train", step, m))
        if self._tb is not None:
            for k, name in (("elbo", "elbo"), ("ll", "recons"), ("kl", "kl"), ("loss", "loss")):
                self._tb.add_scalar(f"{name}/train", float(m[k]), step)
            for i, v in enumerate(m["kl_layers"]):
                self._tb.add_scalar(f"kl/layer_{i}", float(v), step)
            if images_per_sec is not None:
                self._tb.add_scalar("perf/images_per_sec", images_per_sec, step)
        return line

    def log_deferred(self, step: int, images_per_sec: float) -> None:
        """``--defer-metrics``' progress line: no readback of the EMA, so
        the rate is the host's dispatch rate, not the device's."""
        print(
            f"[train] step {step:>7d}  (metrics deferred)  "
            f"{images_per_sec:>8.0f} img/s dispatched",
            flush=True,
        )

    def log_test(self, step: int, metrics: Mapping) -> str:
        line = (
            f"[test ] step {step:>7d}  elbo {metrics['elbo']:>10.2f}  "
            f"recons {metrics['ll']:>10.2f}  kl {metrics['kl']:>8.2f}"
        )
        if "bpd" in metrics:
            line += f"  bpd {metrics['bpd']:.4f}"
        print(line, flush=True)
        self.history.append(("test", step, dict(metrics)))
        if self._tb is not None:
            for k, v in metrics.items():
                if np.ndim(v) == 0:
                    self._tb.add_scalar(f"{k}/test", float(v), step)
        return line

    def log_images(self, tag: str, step: int, grid_hwc: np.ndarray) -> None:
        if self._tb is not None:
            self._tb.add_image(tag, grid_hwc, step, dataformats="HWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
