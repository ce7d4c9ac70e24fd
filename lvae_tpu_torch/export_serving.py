"""Export a trained run's serving surfaces to ``torch.export`` artifacts
(port of ``tools/export_serving.py``).

    python -m lvae_tpu_torch.export_serving --load <run name or dir> \\
        [--platforms cuda cpu] [--check] [--device cuda]

Writes ``<run_dir>/serving/{generate,reconstruct,encode}.pt2`` and
``manifest.json``. The artifacts hold the weights and the whole
computation; a serving process needs only torch to load them:

    ep = torch.export.load("<run_dir>/serving/reconstruct.pt2")
    out = ep.module()(x_uint8, torch.tensor(0, dtype=torch.int32), index_int32)

or ``lvae_tpu_torch.serving.load_artifact(path, device)``, which also
moves an artifact to another device. See ``lvae_tpu_torch/serving.py`` for
the surface contracts. ``--device cuda`` (the default) traces on the card
and never falls back to the CPU. ``--state-dict`` takes the weights from a
file instead of the run's checkpoints, as ``evaluate`` does (an
``lvae_tpu`` run's, converted with ``flax_to_torch_state_dict``).
"""

from __future__ import annotations

import argparse
import os

import torch

PLATFORMS = ("cuda", "cpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a trained run's serving surfaces "
                                            "to torch.export artifacts")
    p.add_argument("--load", required=True, help="run name (or full run dir)")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--state-dict", default=None,
                   help="weights from this file instead of the run's checkpoint")
    p.add_argument("--what", nargs="+", default=["generate", "reconstruct", "encode"],
                   choices=["generate", "reconstruct", "encode"])
    p.add_argument("--artifact-dir", default=None,
                   help="where to write (default: <run_dir>/serving)")
    p.add_argument("--nimages", type=int, default=64,
                   help="batch size baked into the generate surface")
    p.add_argument("--temperature", type=float, nargs="+", default=None,
                   help="prior sampling temperature(s) baked into generate")
    p.add_argument("--mode-layers", type=int, nargs="*", default=[])
    p.add_argument("--constant-layers", type=int, nargs="*", default=[])
    p.add_argument("--batch", type=int, default=None,
                   help="pin reconstruct's and encode's batch dim (default: "
                        "symbolic, one artifact serves any batch size)")
    p.add_argument("--platforms", nargs="+", default=None, choices=PLATFORMS,
                   help="devices the artifacts serve (default: --device's); "
                        "--check loads each artifact onto each of them")
    p.add_argument("--device", default="cuda", choices=PLATFORMS,
                   help="the device the export traces on")
    p.add_argument("--check", action="store_true",
                   help="load each artifact onto each platform and call it "
                        "after writing")
    return p.parse_args(argv)


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "cuda: no CUDA device is visible (torch.cuda.is_available() is "
            "False); the port does not fall back to the CPU"
        )
    return torch.device(name)


def main(argv=None):
    args = parse_args(argv)
    device = _device(args.device)
    platforms = args.platforms or [args.device]
    for p in platforms:
        _device(p)
    from lvae_tpu_torch.serving import export_run, load_artifact, move_artifact

    run_dir = args.load if os.path.isdir(args.load) else os.path.join(args.output_dir,
                                                                      args.load)
    temps = args.temperature
    temperature = 1.0 if temps is None else temps[0] if len(temps) == 1 else tuple(temps)
    arts = export_run(
        run_dir, what=args.what, step=args.step, out_dir=args.artifact_dir,
        n_images=args.nimages, temperature=temperature, mode_layers=args.mode_layers,
        constant_layers=args.constant_layers, batch=args.batch, platforms=platforms,
        device=device, state_dict=args.state_dict,
    )
    for name, path in arts.paths.items():
        print(f"wrote {name}: {path} ({os.path.getsize(path):,} bytes)")
    if not args.check:
        return arts

    h, w, c = arts.manifest["img_shape"]
    b = args.batch or 2
    for name, path in arts.paths.items():
        if name == "manifest":
            continue
        ep = load_artifact(path)
        for plat in platforms:
            dev = torch.device(plat)
            ep = move_artifact(ep, dev)
            seed = torch.tensor(0, dtype=torch.int32, device=dev)
            x = torch.zeros((b, h, w, c), dtype=torch.uint8, device=dev)
            idx = torch.arange(b, dtype=torch.int32, device=dev)
            if name == "generate":
                out = ep.module()(seed)
                print(f"check generate [{plat}]: out {tuple(out.shape)} "
                      f"finite={bool(torch.isfinite(out).all())}")
            elif name == "reconstruct":
                out = ep.module()(x, seed, idx)
                print(f"check reconstruct [{plat}]: out_mean {tuple(out['out_mean'].shape)} "
                      f"bpd[0]={float(out['bpd'][0]):.4f}")
            else:
                out = ep.module()(x, seed, idx)
                print(f"check encode [{plat}]: mu shapes {[tuple(m.shape) for m in out['mu']]}")
    return arts


if __name__ == "__main__":
    main()
