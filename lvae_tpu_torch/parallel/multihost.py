"""Joining and starting the ranks (port of
``lvae_tpu/parallel/multihost.py:34-231``).

``lvae_tpu`` runs one process per host and addresses every device of the
job through one global mesh. The port runs one process per rank:

- :func:`initialize` joins the process group. It reads ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` as ``torchrun`` sets
  them, or takes the coordinator's address, the process count and this
  process's id, as ``multihost.initialize`` takes them. With neither it
  is a no-op (one process, no collectives). A failure to join
  propagates. The backend is NCCL where every rank has a card of its
  own, gloo on the CPU and where ranks share a card; under NCCL a second,
  gloo group carries the host's agreements (:func:`agree`,
  :func:`broadcast_object`), so that they never wait on the card.
- :func:`launch` starts the ranks of a command itself: ``python -m
  lvae_tpu_torch.main --num-data-shards N ...`` without ``torchrun``
  starts N copies of itself with those variables set, passes SIGTERM and
  SIGINT on to every rank, and returns the first failing exit code
  (:func:`run_ranks`, the commands' shared entry).

``make_global_batch_indices``, ``replicate_to_mesh`` and
``eval_batch_stream`` are in :mod:`lvae_tpu_torch.parallel.mesh`.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import Optional, Sequence

import torch

from lvae_tpu_torch.parallel.mesh import Layout, current, set_layout

ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether this process is one rank of a launched group (``torchrun``'s
    variables, or :func:`launch`'s, are set)."""
    return "WORLD_SIZE" in os.environ


def check_world(num_data_shards: int, spatial_shards: int = 1) -> None:
    """Under a launcher, raise unless its group has ``num_data_shards x
    spatial_shards`` ranks (before joining it: a wrong count would wait for
    ranks that never come)."""
    if launched() and int(os.environ["WORLD_SIZE"]) != num_data_shards * spatial_shards:
        flags = f"--num-data-shards {num_data_shards}" + (
            f" --spatial-shards {spatial_shards}" if spatial_shards > 1 else "")
        raise SystemExit(
            f"{flags}: this process is one of {os.environ['WORLD_SIZE']} launched ranks "
            f"(WORLD_SIZE); give the rank count as --num-data-shards x --spatial-shards")


def pick_backend(device: str, world_size: int) -> str:
    """NCCL where every rank has a card of its own, else gloo (the CPU, or
    ranks sharing a card)."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda", backend: Optional[str] = None,
               timeout_s: float = 600.0, spatial: int = 1) -> Layout:
    """Join the process group and make its layout :func:`current`; return
    it. ``coordinator_address`` is ``host:port``; without it the
    ``torchrun`` variables are read, and without those this is a no-op
    that returns the one-rank layout. On CUDA each rank takes card
    ``LOCAL_RANK`` (else its rank) modulo the visible cards. ``spatial``
    is the space axis' size S: every rank then makes each space group
    (ranks ``d S`` to ``d S + S - 1``) and each data group (ranks ``s, s +
    S, ...``), in that order, and keeps its own two."""
    import torch.distributed as dist

    if coordinator_address is None and num_processes is None and not launched():
        return current()
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        init = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        missing = [v for v in ENV_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(f"a launched rank needs {', '.join(ENV_VARS)}; missing "
                               f"{', '.join(missing)}")
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is visible")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    else:   # the ranks share the host's cores (OMP_NUM_THREADS still caps them)
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world)))
    backend = backend or pick_backend(device, world)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s), **kw)
    group = dist.group.WORLD
    control = dist.new_group(backend="gloo") if backend == "nccl" else group
    space_group = data_group = None
    if spatial > 1:
        if world % spatial:
            raise ValueError(f"--spatial-shards {spatial} does not divide the {world} ranks")
        for d in range(world // spatial):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if rank // spatial == d:
                space_group = g
        for s_ in range(spatial):
            g = dist.new_group(list(range(s_, world, spatial)))
            if rank % spatial == s_:
                data_group = g
    layout = Layout(rank=rank, size=world, group=group, control=control, backend=backend,
                    n_space=spatial, space_group=space_group, data_group=data_group)
    set_layout(layout)
    return layout


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    set_layout(Layout())


def barrier(layout: Optional[Layout] = None) -> None:
    """Wait for every rank (on the host's group)."""
    layout = layout or current()
    if layout.distributed:
        import torch.distributed as dist

        dist.barrier(group=layout.control)


def agree(flag: bool, layout: Optional[Layout] = None) -> bool:
    """Whether any rank's ``flag`` is set: one all-reduce on the host's
    group, so every rank that calls it at the same point gets the same
    answer there (the train loop's stop at a k-step boundary)."""
    layout = layout or current()
    if not layout.distributed:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, group=layout.control)
    return bool(t.item())


def broadcast_object(obj, layout: Optional[Layout] = None):
    """Rank 0's ``obj`` on every rank (a run name, a path)."""
    layout = layout or current()
    if not layout.distributed:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(layout.control, 0),
                               group=layout.control)
    return box[0]


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, base: Optional[dict] = None) -> dict:
    """The environment of rank ``rank`` of ``world`` meeting on ``port``."""
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def launch(command: Sequence[str], world: int, timeout_s: Optional[float] = None) -> int:
    """Run ``command`` (an argv, e.g. ``[sys.executable, "-m",
    "lvae_tpu_torch.main", ...]``) as ``world`` ranks meeting on a free
    localhost port; SIGTERM and SIGINT are passed on to every rank. Waits
    for all of them and returns 0, or the first non-zero exit code: a rank
    that fails ends the others at once (they would wait for it in their
    next collective). Past ``timeout_s`` every rank is killed and
    ``TimeoutError`` raised."""
    port = free_port()
    procs = [subprocess.Popen(list(command), env=rank_env(r, world, port))
             for r in range(world)]

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    saved = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            saved[sig] = signal.signal(sig, forward)
        except ValueError:      # not the main thread
            pass
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {' '.join(command[:4])} ... ran past "
                                   f"{timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for sig, h in saved.items():
            signal.signal(sig, h)


def run_ranks(module: str, argv: Sequence[str], shards: int, device: str, body,
              spatial: int = 1):
    """A command's ``--num-data-shards`` (and ``--spatial-shards``)
    handling: with more than one rank and no launcher, start the ``shards
    x spatial`` ranks of ``python -m module argv`` (:func:`launch`) and
    return None once all have ended (a failing rank raises SystemExit
    naming the flags); else join the group (a no-op for one process,
    :func:`initialize`) and return ``body(layout)``, leaving the group
    after it."""
    world = shards * spatial
    if world > 1 and not launched():
        code = launch([sys.executable, "-m", module, *argv], world)
        if code:
            flags = f"--num-data-shards {shards}" + (
                f" --spatial-shards {spatial}" if spatial > 1 else "")
            raise SystemExit(f"{flags}: a rank exited with code {code}")
        return None
    check_world(shards, spatial)
    layout = initialize(device=device, spatial=spatial)
    try:
        return body(layout)
    finally:
        shutdown()
