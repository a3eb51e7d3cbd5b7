"""Sharded training: the same batched BPR/WARP step compiled over a
``(data, model)`` mesh — in the regime-appropriate flavor.

Two regimes (SURVEY.md §2.6; the scaling-book recipe of picking the
parallelism by where the bytes live):

* **DP — tables fit per device** (the overwhelmingly common case: even a
  1M x 64 f32 item table is 256 MB). Tables REPLICATE, the batch shards
  over every mesh axis, each device runs the unmodified single-device
  step on its shard with its own fold_in'd PRNG stream, and the only
  collective is ONE psum of the weight DELTAS per batch. Expressed as an
  explicit `shard_map` — `make_dp_epoch_fn` — because GSPMD cannot know
  the deltas are sparse-rank-deficient and would schedule per-gather
  exchanges instead.

* **TP — tables bigger than a device's budget**: row-sharded tables over ``model``,
  batch over ``data``, GSPMD lowering gathers to all-gather/all-to-all
  exchanges and scatters to psums back to owner shards
  (`make_sharded_train_step` / the ``dp=False`` epoch path).

`make_sharded_epoch_fn` picks DP automatically when the weight pytree fits
the per-device budget (`dp_table_budget`).
"""

from __future__ import annotations

from functools import lru_cache

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from rankfm_tpu.ops.training import make_train_step
from rankfm_tpu.parallel.mesh import batch_sharding, feature_shardings, weight_shardings


def make_sharded_train_step(mesh, num_items, max_samples, x_uf_any, x_if_any,
                            sample_rounds=8, sampler="bsearch"):
    """Jit the single-batch train step with explicit input shardings.

    Returns ``step(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta,
    key) -> (w, ll)`` compiled for the mesh, where ``hist`` is the
    ``{'offsets', 'flat', 'bitmap'}`` history dict (bitmap row-sharded like
    the user table; CSR arrays replicated).
    """
    step = make_train_step(num_items, max_samples, x_uf_any, x_if_any,
                           sample_rounds, sampler)
    ws = weight_shardings(mesh)
    fs = feature_shardings(mesh)
    bs = batch_sharding(mesh)
    rep = NamedSharding(mesh, P())
    hist_sh = {"offsets": rep, "flat": rep,
               "bitmap": NamedSharding(mesh, P("model", None))
               if sampler == "bitmap" else rep}

    in_shardings = (
        ws,                     # w
        fs["x_uf"], fs["x_if"],
        hist_sh,                # user-history structures
        bs, bs, bs, bs,         # u, i, sw, valid
        rep, rep, rep, rep,     # eta, alpha, beta, key
    )
    return jax.jit(step, in_shardings=in_shardings, out_shardings=(ws, rep),
                   donate_argnums=(0,))


@lru_cache(maxsize=16)
def _cached_sharded_step(mesh_key, num_items, max_samples, x_uf_any, x_if_any,
                         sample_rounds, sampler):
    mesh = mesh_key.mesh
    return make_sharded_train_step(mesh, num_items, max_samples, x_uf_any,
                                   x_if_any, sample_rounds, sampler)


class _MeshKey:
    """hashable wrapper so meshes can key an lru_cache"""

    def __init__(self, mesh):
        self.mesh = mesh
        self._k = (tuple(mesh.axis_names), tuple(mesh.shape.values()),
                   tuple(d.id for d in mesh.devices.flat))

    def __hash__(self):
        return hash(self._k)

    def __eq__(self, other):
        return isinstance(other, _MeshKey) and self._k == other._k


def sharded_train_step(mesh, num_items, max_samples, x_uf_any, x_if_any,
                       sample_rounds=8, sampler="bsearch"):
    """Cached accessor for the sharded step (avoids re-tracing per model)."""
    return _cached_sharded_step(_MeshKey(mesh), num_items, max_samples,
                                bool(x_uf_any), bool(x_if_any), sample_rounds,
                                sampler)


def place_weights(mesh, w):
    """Device-put a weight pytree onto the mesh with the canonical
    row-sharded (TP) layout."""
    ws = weight_shardings(mesh)
    return {k: jax.device_put(v, ws[k]) for k, v in w.items()}


def place_weights_replicated(mesh, w):
    """Device-put a weight pytree fully replicated (the DP layout)."""
    rep = NamedSharding(mesh, P())
    return {k: jax.device_put(v, rep) for k, v in w.items()}


@lru_cache(maxsize=16)
def _cached_sharded_epoch(mesh_key, num_items, max_samples, x_uf_any, x_if_any,
                          batch_size, sample_rounds, sampler, step_kind):
    from rankfm_tpu.ops.training import (
        make_train_step, make_window_train_step)

    mesh = mesh_key.mesh
    ws = weight_shardings(mesh)
    fs = feature_shardings(mesh)
    bs_sh = batch_sharding(mesh)
    rep = NamedSharding(mesh, P())
    if step_kind == "window":
        # same fast step family as single-chip (VERDICT r1 weak #5): window
        # scoring is batched matmuls over row-sharded tables; the blocked
        # history pack is row-sharded like the user table and its per-batch
        # window rows ride one gather exchange
        step = make_window_train_step(num_items, max_samples, x_uf_any,
                                      x_if_any)
        hist_sh = NamedSharding(mesh, P("model", None))
    else:
        step = make_train_step(num_items, max_samples, x_uf_any, x_if_any,
                               sample_rounds, sampler)
        hist_sh = {"offsets": rep, "flat": rep,
                   "bitmap": NamedSharding(mesh, P("model", None))
                   if sampler == "bitmap" else rep}

    # identical shuffle/PRNG/validity conventions to the single-device path
    # BY CONSTRUCTION (same epoch-body builder)
    from rankfm_tpu.ops.training import make_epoch_body
    epoch_fn = make_epoch_body(step, batch_size)

    in_shardings = (ws, fs["x_uf"], fs["x_if"], hist_sh,
                    bs_sh, bs_sh, bs_sh, rep, rep, rep, rep, rep)
    return jax.jit(epoch_fn, static_argnums=(7,), donate_argnums=(0,),
                   in_shardings=in_shardings, out_shardings=(ws, rep))


@lru_cache(maxsize=16)
def _cached_dp_epoch(mesh_key, num_items, max_samples, x_uf_any, x_if_any,
                     batch_size, sample_rounds, sampler, step_kind,
                     sync_every=1):
    from jax.sharding import PartitionSpec

    import jax.numpy as jnp

    shard_map = jax.shard_map

    from rankfm_tpu.ops.training import (
        make_train_step, make_window_train_step)

    mesh = mesh_key.mesh
    axes = tuple(mesh.axis_names)          # batch shards over EVERY axis
    n_dev = 1
    for v in mesh.shape.values():
        n_dev *= v
    assert batch_size % n_dev == 0, (batch_size, n_dev)
    if step_kind == "window":
        step = make_window_train_step(num_items, max_samples, x_uf_any,
                                      x_if_any)
    else:
        step = make_train_step(num_items, max_samples, x_uf_any, x_if_any,
                               sample_rounds, sampler)

    rep = PartitionSpec()
    bsh = PartitionSpec(None, axes)   # [K, batch]: batch axis sharded

    def device_batch(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta,
                     key):
        # distinct negative-sampling stream per device
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * mesh.shape[ax] + jax.lax.axis_index(ax)
        key = jax.random.fold_in(key, idx)
        # u/i/sw/valid arrive stacked [K, bs/ndev]: K local steps on this
        # device's replica, then ONE delta-psum for the whole group.
        # K = 1 reproduces per-batch sync exactly; K > 1 is local SGD —
        # replicas drift for K batches, the merge sums their deltas. The
        # collective volume drops K-fold: the lever for DCN-linked hosts,
        # where a per-batch table-sized psum would dominate the step.
        def local(carry, xs):
            wl, t = carry
            ul, il, swl, vl = xs
            wl, ll = step(wl, x_uf, x_if, hist, ul, il, swl, vl,
                          eta, alpha, beta, jax.random.fold_in(key, t))
            return (wl, t + 1), ll
        (w2, _), lls = jax.lax.scan(local, (w, 0), (u, i, sw, valid))
        # ONE table-sized collective: sum of the per-device deltas.
        # (Linearizes the per-touch decay across devices — the same
        # approximation the chunked single-chip paths already make.)
        delta = jax.tree.map(lambda a, b: jax.lax.psum(a - b, axes), w2, w)
        ll = jax.lax.psum(jnp.sum(lls), axes)
        return jax.tree.map(jnp.add, w, delta), ll

    sharded_step = shard_map(
        device_batch, mesh=mesh,
        in_specs=(rep, rep, rep, rep, bsh, bsh, bsh, bsh,
                  rep, rep, rep, rep),
        out_specs=(rep, rep),
        check_vma=False)

    def epoch_fn(w, x_uf, x_if, hist, u, i, sw, n_real, eta, alpha, beta,
                 key, epoch):
        n_pad = u.shape[0]
        nb = n_pad // batch_size
        # largest group size <= sync_every that divides the batch count
        # (clamped: sync_every < 1 would make the range empty and raise an
        # opaque max() error at trace time)
        k = max(d for d in range(1, max(1, min(sync_every, nb)) + 1)
                if nb % d == 0)
        ng = nb // k
        kperm, ksamp = jax.random.split(jax.random.fold_in(key, epoch))
        perm = jax.random.permutation(kperm, n_pad)
        valid = perm < n_real
        ub = u[perm].reshape(ng, k, batch_size)
        ib = i[perm].reshape(ng, k, batch_size)
        swb = sw[perm].reshape(ng, k, batch_size)
        vb = valid.reshape(ng, k, batch_size)

        def body(carry, xs):
            wc = carry
            ub_, ib_, swb_, vb_, t = xs
            wc, ll = sharded_step(wc, x_uf, x_if, hist, ub_, ib_, swb_, vb_,
                                  eta, alpha, beta,
                                  jax.random.fold_in(ksamp, t))
            return wc, ll

        w, lls = jax.lax.scan(body, w, (ub, ib, swb, vb, jnp.arange(ng)))
        return w, jnp.sum(lls)

    rep_sh = NamedSharding(mesh, P())
    bsh_named = NamedSharding(mesh, P(axes))
    in_shardings = (rep_sh, rep_sh, rep_sh, rep_sh,
                    bsh_named, bsh_named, bsh_named, rep_sh, rep_sh, rep_sh,
                    rep_sh, rep_sh)
    return jax.jit(epoch_fn, static_argnums=(7,), donate_argnums=(0,),
                   in_shardings=in_shardings,
                   out_shardings=(rep_sh, rep_sh))


# A replicated weight pytree may take this share of one device's memory
# (`memory_stats()["bytes_limit"]`, the allocator's limit): each replica
# also holds table-sized gradient tables, the updated copy and the
# delta-psum buffers during a step, several times the pytree itself. The
# share is an estimate from that count, not a measurement: no fit near
# the limit it sets has been run.
DP_MEMORY_SHARE = 1 / 8
# The DP budget where the backend reports no device memory (the CPU
# backend, as in the tests): weight pytrees up to this many bytes replicate.
DP_TABLE_BYTES = 256 * 2**20


def dp_table_budget(mesh):
    """Bytes a weight pytree may take and still train data-parallel on
    ``mesh``: `DP_MEMORY_SHARE` of the smallest local device's memory limit,
    or `DP_TABLE_BYTES` when no device reports one."""
    limits = []
    for d in mesh.devices.flat:
        try:
            stats = d.memory_stats()
        except Exception:  # non-addressable device of another process
            stats = None
        if stats and stats.get("bytes_limit"):
            limits.append(int(stats["bytes_limit"]))
    if not limits:
        return DP_TABLE_BYTES
    return int(min(limits) * DP_MEMORY_SHARE)


def uses_dp(mesh, batch_size, table_bytes, budget):
    """Single source of truth for the DP-vs-TP choice: data-parallel
    (replicated tables, delta-psum) needs the weight pytree to fit the
    per-device ``budget`` (`dp_table_budget`, worked out by the caller)
    AND the batch to shard evenly over the devices. Reads only the mesh's
    shape. Callers that PLACE weights (replicated vs row-sharded) must
    consult this too — a placement that disagrees with the epoch fn's
    in_shardings is a resharding (or an error) at the first call."""
    n_dev = 1
    for v in mesh.shape.values():
        n_dev *= v
    return table_bytes <= budget and batch_size % n_dev == 0


def make_sharded_epoch_fn(mesh, num_items, max_samples, x_uf_any, x_if_any,
                          batch_size, sample_rounds=8, sampler="bsearch",
                          step_kind="window", dp=None, table_bytes=0,
                          dp_sync_every=1):
    """Whole-epoch training compiled over the mesh; same signature as
    `rankfm_tpu.ops.training.make_epoch_fn` (``hist`` is the blocked history
    pack for ``step_kind='window'``, the CSR/bitmap dict for
    ``'candidate'``).

    ``dp=None`` picks data-parallel (replicated tables, one delta-psum per
    batch) when ``table_bytes`` fits `dp_table_budget`, else the row-sharded
    GSPMD path. Pass ``dp=True/False`` to force.

    ``dp_sync_every=K`` accumulates K batches of local updates per replica
    before the delta-psum (local SGD): K-fold less collective volume — the
    lever when hosts are linked by a network slower than the links between
    the devices of one host. K = 1 (default) syncs every batch."""
    if dp is None:
        dp = uses_dp(mesh, batch_size, table_bytes, dp_table_budget(mesh))
    else:
        dp = dp and uses_dp(mesh, batch_size, 0, 0)
    if dp:
        return _cached_dp_epoch(_MeshKey(mesh), num_items, max_samples,
                                bool(x_uf_any), bool(x_if_any), batch_size,
                                sample_rounds, sampler, step_kind,
                                sync_every=int(dp_sync_every))
    return _cached_sharded_epoch(_MeshKey(mesh), num_items, max_samples,
                                 bool(x_uf_any), bool(x_if_any), batch_size,
                                 sample_rounds, sampler, step_kind)
