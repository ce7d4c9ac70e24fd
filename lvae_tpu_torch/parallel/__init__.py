"""Data-parallel training over several ranks (port of ``lvae_tpu/parallel/``):
the rank layout and the reductions the ``data`` mesh makes
(:mod:`~lvae_tpu_torch.parallel.mesh`), joining and starting the ranks
(:mod:`~lvae_tpu_torch.parallel.multihost`). ``--spatial-shards`` (the
``space`` axis) has no port yet."""

from lvae_tpu_torch.parallel.mesh import (
    Layout,
    all_reduce_,
    all_reduce_sum,
    current,
    element_offset,
    eval_batch_stream,
    make_global_batch_indices,
    make_mesh,
    reduce_gradients_,
    replicate_to_mesh,
    shard_batch,
    use,
)
from lvae_tpu_torch.parallel.multihost import (
    agree,
    barrier,
    broadcast_object,
    initialize,
    launch,
    launched,
    run_ranks,
    shutdown,
)

__all__ = [
    "Layout",
    "agree",
    "all_reduce_",
    "all_reduce_sum",
    "barrier",
    "broadcast_object",
    "current",
    "element_offset",
    "eval_batch_stream",
    "initialize",
    "launch",
    "launched",
    "make_global_batch_indices",
    "make_mesh",
    "reduce_gradients_",
    "replicate_to_mesh",
    "run_ranks",
    "shard_batch",
    "shutdown",
    "use",
]
