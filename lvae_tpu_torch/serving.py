"""Serving surfaces, in process and as ``torch.export`` artifacts (the
contracts of ``lvae_tpu/serving.py``).

- ``reconstruct(model, x_u8, seed, index, preprocess)`` -> ``{out_mean,
  ll, kl, elbo, bpd}``, bpd over the image's H x W x C dimensions
- ``encode(model, x_u8, seed, index, preprocess)`` -> ``{mu, z}``:
  per-layer posterior means and draws, tuples indexed bottom-up
- ``generate(model, n, seed)`` -> ``[n, H, W, C]`` prior samples (the
  likelihood mean)

Keying contract: image ``i``'s preprocessing and latents are keyed by
``(seed, index[i])``. Pass global dataset indices for ``evaluate``'s
keying (outputs then invariant to batching and permutation), or
``arange(B)`` for position keying. Inputs are uint8 NHWC on the model's
device or the host, preprocessed as the dataset is evaluated
(``preprocess``: ``none``, ``binarize``, or ``dequantize`` for the RGB
datasets); outputs are float32 NHWC on the model's device. ``seed`` is an
int or a 0-d integer tensor.

:func:`export_run` turns a saved run into one self-contained artifact per
surface, ``<run>/serving/{generate,reconstruct,encode}.pt2``
(``torch.export.save``; the weights inside), and a ``manifest.json``:

- ``generate(seed int32[]) -> float32[n_images, H, W, C]``, with
  ``n_images``, ``temperature`` and the mode and constant layers baked in;
- ``reconstruct(x uint8[B, H, W, C], seed int32[], index int32[B])`` and
  ``encode(x, seed, index)``, as above, with B symbolic unless ``batch``
  pins it: one artifact serves any B >= 1.

A serving process needs torch and the file, not this package:
``load_artifact(path, device).module()(x, seed, index)``, or
``torch.export.load(path)`` itself. It turns TF32 off (the manifest's
``fp32_math``), as the port does, since a graph carries no backend flag:
with TF32 on, the fp32 convolutions round to 10-bit mantissas. The
artifacts hold plain aten operations only: the run is restored with
``fused='none'``, because a graph that called a ctypes-bound kernel
could neither be traced nor be loaded without the port. The model keeps the precision it was trained in
(bf16 convolutions under ``--precision bf16``), or takes ``precision``'s.
The noise is the port's keyed Philox (``ops/philox.py``), traced into the
graph as integer operations, so an artifact gives the plain eager path's
outputs on whichever device it runs.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional, Sequence, Union

import torch
from torch import nn

from lvae_tpu_torch import fp32_math
from lvae_tpu_torch.data.device import eval_preprocess_batch
from lvae_tpu_torch.models.stochastic import Noise
from lvae_tpu_torch.ops.philox import Ints

LN2 = math.log(2.0)
SURFACES = ("generate", "reconstruct", "encode")
MAX_BATCH = 65535
# what the serving process sets for the artifact's fp32 convolutions to be
# the port's: a graph holds no backend flag, and a fresh process has TF32 on
FP32_MATH = ("torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 "
             "= False")
KEYING = ("(seed, index[i]) per image: pass global dataset indices for "
          "evaluate-identical permutation-invariant keying, or arange(B) "
          "for position keying")


def _seed(seed: Ints) -> Ints:
    """An int, or a 0-d integer tensor as the int64 the noise reads."""
    return seed.to(torch.int64) if isinstance(seed, torch.Tensor) else seed


def _inputs(model, x_u8: torch.Tensor, index: torch.Tensor, preprocess: str):
    if x_u8.dtype != torch.uint8 or x_u8.dim() != 4:
        raise ValueError(f"x must be uint8 [B, H, W, C], got {x_u8.dtype} "
                         f"{tuple(x_u8.shape)}")
    index = torch.as_tensor(index, dtype=torch.int64, device=model.device)
    if index.shape != (x_u8.shape[0],):
        raise ValueError(f"index must be [{x_u8.shape[0]}], got {tuple(index.shape)}")
    x = eval_preprocess_batch(x_u8.to(model.device), preprocess, index)
    return x, index


@torch.no_grad()
def reconstruct(model, x_u8: torch.Tensor, seed: Ints, index: torch.Tensor,
                preprocess: str = "none") -> dict:
    x, index = _inputs(model, x_u8, index, preprocess)
    out = model(x, noise=Noise(_seed(seed), index))
    kl = out["kl_sep"].sum(dim=0)
    elbo = out["ll"] - kl
    return {
        "out_mean": out["out_mean"].float(),
        "ll": out["ll"],
        "kl": kl,
        "elbo": elbo,
        "bpd": -elbo / (x[0].numel() * LN2),
    }


@torch.no_grad()
def encode(model, x_u8: torch.Tensor, seed: Ints, index: torch.Tensor,
           preprocess: str = "none") -> dict:
    """The top layer's ``mu`` is a function of the image alone; lower
    layers condition on the draws above them and so vary with ``seed``."""
    x, index = _inputs(model, x_u8, index, preprocess)
    out = model(x, noise=Noise(_seed(seed), index))
    c = [q.shape[-1] // 2 for q in out["q_params"]]
    return {
        "mu": tuple(q[..., :ci] for q, ci in zip(out["q_params"], c)),
        "z": tuple(out["z"]),
    }


@torch.no_grad()
def generate(model, n: int, seed: Ints, *,
             temperature: Union[float, Sequence[float]] = 1.0,
             mode_layers: Sequence[int] = (),
             constant_layers: Sequence[int] = ()) -> torch.Tensor:
    return model.sample_prior(
        n, seed=_seed(seed), mode_layers=tuple(mode_layers),
        constant_layers=tuple(constant_layers), temperature=temperature,
    )["out_mean"].float()


# ----------------------------------------------------------------------
# torch.export artifacts
# ----------------------------------------------------------------------
class _Generate(nn.Module):
    def __init__(self, model, n_images: int, **baked):
        super().__init__()
        self.model, self.n_images, self.baked = model, n_images, baked

    def forward(self, seed: torch.Tensor) -> torch.Tensor:
        return generate(self.model, self.n_images, seed, **self.baked)


class _Keyed(nn.Module):
    """``reconstruct`` or ``encode`` (int32 seed and index in, cast to the
    port's int64 inside the graph)."""

    def __init__(self, fn, model, preprocess: str):
        super().__init__()
        self.fn, self.model, self.preprocess = fn, model, preprocess

    def forward(self, x_u8: torch.Tensor, seed: torch.Tensor, index: torch.Tensor) -> dict:
        return self.fn(self.model, x_u8, seed, index, self.preprocess)


@dataclasses.dataclass
class ServingArtifacts:
    """Paths written by :func:`export_run` (and the manifest)."""

    out_dir: str
    paths: dict
    manifest: dict


def _restore_for_export(run_dir: str, step: Optional[int], device: torch.device,
                        precision: Optional[str] = None,
                        state_dict: Optional[str] = None):
    """The run as ``evaluate`` restores it (its ``config.json``, the
    port's trainer's or ``lvae_tpu``'s; the latest checkpoint, ``step``'s,
    or the weights in the file ``state_dict``), with the export-safe
    overrides: plain operations only (``fused='none'``) on one device.
    Returns ``(model, data, step, cfg)``."""
    from lvae_tpu_torch.config import config_from_dict
    from lvae_tpu_torch.data.registry import load_test_set
    from lvae_tpu_torch.train.checkpoint import CheckpointManager, load_config_dict
    from lvae_tpu_torch.train.convert import load_state_dict_file
    from lvae_tpu_torch.train.trainer import make_model

    d = load_config_dict(run_dir)
    d.update(fused="none", spatial_shards=1)
    if precision is not None:
        d["precision"] = precision
    cfg = config_from_dict(d)
    if state_dict is None:
        ckpt = CheckpointManager(run_dir).load(step)
        weights, step = ckpt["model"], int(ckpt["step"])
    elif step is not None:
        raise ValueError("step picks one of the run's checkpoints; it cannot be "
                         "combined with state_dict, which names the weights itself")
    else:
        weights, step = load_state_dict_file(state_dict), 0
    data = load_test_set(cfg.dataset, cfg.data_dir)
    model = make_model(cfg, data, device)
    model.load_state_dict(weights, strict=True)
    return model.eval().requires_grad_(False), data, step, cfg


def _export(module: nn.Module, args: tuple, dynamic_shapes, path: str) -> float:
    """Trace ``module`` on ``args`` and save it at ``path``; returns the
    seconds both took."""
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(module, args, dynamic_shapes=dynamic_shapes)
    torch.export.save(ep, path)
    return time.perf_counter() - t0


def export_run(
    run_dir: str,
    *,
    what: Sequence[str] = SURFACES,
    step: Optional[int] = None,
    out_dir: Optional[str] = None,
    n_images: int = 64,
    temperature: Union[float, Sequence[float]] = 1.0,
    mode_layers: Sequence[int] = (),
    constant_layers: Sequence[int] = (),
    batch: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    device: Union[str, torch.device] = "cuda",
    precision: Optional[str] = None,
    state_dict: Optional[str] = None,
) -> ServingArtifacts:
    """Export a saved run's serving surfaces to ``<run_dir>/serving/``.

    ``batch=None`` exports ``reconstruct`` and ``encode`` with a symbolic
    batch (one artifact, any B >= 1); an int pins it. The trace runs on
    ``device``; ``platforms`` (default: that device's type) are the
    devices the manifest says the artifacts serve: :func:`load_artifact`
    moves an artifact to any of them."""
    unknown = set(what) - set(SURFACES)
    if unknown:
        raise ValueError(f"unknown surfaces {sorted(unknown)}; choose from {SURFACES}")
    device = torch.device(device)
    model, data, step, cfg = _restore_for_export(run_dir, step, device, precision,
                                                 state_dict)
    out_dir = out_dir or os.path.join(run_dir, "serving")
    os.makedirs(out_dir, exist_ok=True)
    h, w = data.img_size
    c = data.color_ch
    paths: dict = {}
    manifest: dict = {
        "run_dir": os.path.abspath(run_dir),
        "step": step,
        "dataset": cfg.dataset,
        "img_shape": [h, w, c],
        "preprocess": data.preprocess,
        "platforms": list(platforms) if platforms else [device.type],
        "torch_version": torch.__version__,
        "precision": cfg.precision,
        "fp32_math": FP32_MATH,
        "traced_on": str(device),
        "surfaces": {},
    }
    seed = torch.zeros((), dtype=torch.int32, device=device)

    if "generate" in what:
        baked = dict(temperature=temperature, mode_layers=tuple(mode_layers),
                     constant_layers=tuple(constant_layers))
        p = os.path.join(out_dir, "generate.pt2")
        secs = _export(_Generate(model, n_images, **baked), (seed,), None, p)
        paths["generate"] = p
        manifest["surfaces"]["generate"] = {
            "export_s": secs,
            "in": "seed int32[]",
            "out": f"float32[{n_images},{h},{w},{c}]",
            "n_images": n_images,
            "temperature": temperature if isinstance(temperature, (int, float))
            else list(temperature),
            "mode_layers": list(mode_layers),
            "constant_layers": list(constant_layers),
        }

    # trace with two images at least: an example batch of 1 would be
    # specialised to 1
    b = batch or 2
    x = torch.zeros((b, h, w, c), dtype=torch.uint8, device=device)
    index = torch.arange(b, dtype=torch.int32, device=device)
    dims = None
    if batch is None:
        # at most 65,535: the exporter refuses a wider range on CUDA, where
        # the backends the trace picks hold only up to there
        bdim = torch.export.Dim("b", min=1, max=MAX_BATCH)
        dims = ({0: bdim}, None, {0: bdim})
    bname = "b" if batch is None else batch
    outs = {
        "reconstruct": "{out_mean float32[B,H,W,C], ll/kl/elbo/bpd float32[B]}",
        "encode": "{mu, z}: tuples of float32[B,H_i,W_i,z_i], indexed bottom-up "
                  "(kl/layer_i numbering)",
    }
    for name, fn in (("reconstruct", reconstruct), ("encode", encode)):
        if name not in what:
            continue
        p = os.path.join(out_dir, f"{name}.pt2")
        secs = _export(_Keyed(fn, model, data.preprocess), (x, seed, index), dims, p)
        paths[name] = p
        manifest["surfaces"][name] = {
            "export_s": secs,
            "in": f"x uint8[{bname},{h},{w},{c}], seed int32[], index int32[{bname}]",
            "out": outs[name],
            "batch": batch,
            "keying": KEYING,
        }
        if name == "encode":
            manifest["surfaces"][name]["zdims"] = list(cfg.zdims)

    mp = os.path.join(out_dir, "manifest.json")
    with open(mp, "w") as f:
        json.dump(manifest, f, indent=2)
    paths["manifest"] = mp
    return ServingArtifacts(out_dir=out_dir, paths=paths, manifest=manifest)


def move_artifact(ep, device: Union[str, torch.device]):
    """``ep`` moved (in place) to ``device`` where its weights lie
    elsewhere: the weights, the constants and every device the graph
    names."""
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if {t.device for t in ep.state_dict.values()} != {device}:
        ep = move_to_device_pass(ep, device)
    return ep


def load_artifact(path: str, device: Union[str, torch.device, None] = None):
    """The ``ExportedProgram`` saved at ``path``, on ``device`` (default:
    the device it was traced on); call it with ``.module()(*args)``. One
    artifact serves the card and the CPU. Turns TF32 off, as the manifest
    asks. All a serving process needs is torch."""
    fp32_math()
    ep = torch.export.load(path)
    return ep if device is None else move_artifact(ep, device)
