"""Device-mesh construction and sharding layouts.

The reference is strictly single-process/single-thread (SURVEY.md §2.6); this
module is the build's first-class distribution story:

* mesh axes ``("data", "model")`` — interaction minibatches are sharded over
  ``data`` (pairwise-loss math is embarrassingly data-parallel), embedding
  tables (``v_u``, ``v_i``, ``w_i``, ``x_uf``, ``x_if``) are **row-sharded**
  over ``model``. Small dense feature weights (``w_if``, ``v_uf``, ``v_if``)
  are replicated; their gradient contributions are reduced by XLA (psum over
  both axes) automatically under GSPMD.
* the mesh shape follows the algorithm alone (how many devices replicate
  vs shard the tables), not the interconnect: the devices of one GPU host
  are linked all to all, and XLA lowers the collectives (psum,
  all-gather, all-to-all) to NCCL.
* multi-host: build the mesh from ``jax.devices()`` after
  ``jax.distributed.initialize()``; nothing else changes.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize the multi-host runtime (idempotent convenience wrapper).

    Pass the coordinator's ``host:port``, the process count and this
    process's id; under a cluster manager that JAX detects (SLURM, Open
    MPI) ``init_distributed()`` with no arguments is enough on each host.
    Build the mesh from the global ``jax.devices()`` afterwards. This is
    the process-group bootstrap the reference never had (SURVEY.md §2.6).
    """
    if getattr(init_distributed, "_done", False):
        return
    # check for an existing distributed runtime WITHOUT jax.process_count():
    # that call initializes the XLA backends, after which
    # jax.distributed.initialize() always raises — the guard would defeat
    # the function on every host and the swallow below would turn it
    # into N silently-diverged single-process runs
    try:
        if jax.distributed.is_initialized():
            return
    except AttributeError:  # older jax
        from jax._src import distributed as _dist
        if _dist.global_state.client is not None:
            return
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
        init_distributed._done = True
    except (RuntimeError, ValueError):
        # A bootstrap failure with an explicitly requested coordinator (bad
        # address, port clash) must NOT be swallowed: each host would proceed
        # as an independent single-process run and silently train diverged
        # replicas. Only the zero-argument single-process case (tests,
        # one-device dev box, no cluster to discover) is benign.
        if coordinator_address is not None:
            raise
        import os
        if any(os.environ.get(k) for k in
               ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")):
            raise
        # cluster managers announce their task count instead of a
        # coordinator — more than one task means this host genuinely
        # expected a distributed bootstrap
        tasks = [os.environ.get(var, "1")
                 for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")]
        if any(t.isdigit() and int(t) > 1 for t in tasks):
            raise


def make_mesh(data=None, model=None, devices=None):
    """Create a ``(data, model)`` mesh.

    With no arguments, uses all local devices on the data axis (pure DP).
    ``data * model`` must equal the number of devices used.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    return Mesh(devices.reshape(data, model), axis_names=("data", "model"))


def weight_shardings(mesh):
    """NamedShardings for the weight pytree: big tables row-sharded over
    'model', small dense feature weights replicated."""
    row = NamedSharding(mesh, P("model", None))
    vec = NamedSharding(mesh, P("model"))
    rep = NamedSharding(mesh, P())
    return {
        "w_i": vec,   # [I]
        "v_u": row,   # [U, F]
        "v_i": row,   # [I, F]
        "w_if": rep,  # [Q]
        "v_uf": rep,  # [P, F]
        "v_if": rep,  # [Q, F]
    }


def feature_shardings(mesh):
    """x_uf [U,P] / x_if [I,Q] row-sharded like their tables."""
    row = NamedSharding(mesh, P("model", None))
    return {"x_uf": row, "x_if": row}


def batch_sharding(mesh):
    """1-D per-interaction arrays sharded over the 'data' axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh):
    return NamedSharding(mesh, P())
