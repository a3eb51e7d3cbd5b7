"""Child process for tests/test_distributed.py: one rank of a 2-process
CPU ring (4 virtual devices each -> a global 8-device mesh).

Runs the REAL multi-host bootstrap (`parallel.mesh.init_distributed`,
which wraps `jax.distributed.initialize`) and then one epoch of the
requested engine over the global mesh:

* ``dp`` — data-parallel delta-psum epoch
  (`parallel.train.make_sharded_epoch_fn`) with the interaction batch
  genuinely split across the two processes
  (`jax.make_array_from_process_local_data`);
* ``tp`` — explicit table-parallel window epoch (`parallel.tp`) on a
  (1, 8) mesh: tables row-sharded ACROSS THE TWO PROCESSES, owner-shard
  gather/psum exchange riding the gloo ring.

Prints one RESULT line the parent compares across ranks: identical
log-likelihood and an identical sha256 of the final user table prove
the replicas/shards converged identically (a swallowed bootstrap
failure would give each rank an independent 4-device run with different
negatives — different hashes).

Invoked as: python dist_child.py <rank> <coordinator_address> [dp|tp]
(not a pytest file — the leading `test_` is deliberately absent)
"""
import hashlib
import os
import sys

import jax

# force the CPU backend via config (works any time before backend init,
# whatever JAX_PLATFORMS the parent environment carries)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rankfm_tpu.ops.window import pack_history_device  # noqa: E402
from rankfm_tpu.parallel.mesh import (  # noqa: E402
    batch_sharding, init_distributed, make_mesh)
from rankfm_tpu.parallel.train import (  # noqa: E402
    make_sharded_epoch_fn, place_weights_replicated)


def main():
    rank, coord = int(sys.argv[1]), sys.argv[2]
    mode = sys.argv[3] if len(sys.argv) > 3 else "dp"
    init_distributed(coordinator_address=coord, num_processes=2,
                     process_id=rank)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4, len(jax.local_devices())
    # idempotence: a second call must be a no-op, not a raise
    init_distributed(coordinator_address=coord, num_processes=2,
                     process_id=rank)

    U, I, F, n, bs = 64, 96, 4, 1024, 128
    rng = np.random.default_rng(5)  # identical data on both ranks
    w = {"w_i": jnp.zeros(I), "w_if": jnp.zeros(1),
         "v_u": jnp.asarray(rng.normal(0, .1, (U, F)).astype(np.float32)),
         "v_i": jnp.asarray(rng.normal(0, .1, (I, F)).astype(np.float32)),
         "v_uf": jnp.zeros((1, F)), "v_if": jnp.zeros((1, F))}
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    uniq = np.unique(np.stack([u, i], 1), axis=0)
    counts = np.bincount(uniq[:, 0], minlength=U)
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    hist = np.asarray(pack_history_device(
        offsets, uniq[:, 1].astype(np.int32), U, I))

    if mode == "tp":
        _run_tp(rank, U, I, F, n, w, u, i, offsets, uniq, hist)
        return

    mesh = make_mesh()  # (8, 1): pure DP over the 2x4 global devices
    w = place_weights_replicated(mesh, w)
    bsh = batch_sharding(mesh)
    half = n // 2

    def shard_local(a):
        # each process contributes ONLY its half of the global batch
        return jax.make_array_from_process_local_data(
            bsh, a[rank * half:(rank + 1) * half])

    u_g, i_g = shard_local(u), shard_local(i)
    sw_g = shard_local(np.ones(n, np.float32))

    fn = make_sharded_epoch_fn(mesh, I, 4, False, False, bs,
                               step_kind="window", dp=True, dp_sync_every=2)
    vu0 = np.asarray(jax.device_get(w["v_u"]))  # before: w is DONATED below
    w2, ll = fn(w, np.zeros((U, 1), np.float32),
                np.zeros((I, 1), np.float32), hist, u_g, i_g, sw_g,
                n, jnp.float32(0.1), jnp.float32(0.01), jnp.float32(0.1),
                jax.random.PRNGKey(3), 0)
    vu = np.asarray(jax.device_get(w2["v_u"]))
    llv = float(ll)
    assert np.isfinite(llv) and np.isfinite(vu).all()
    assert np.abs(vu - vu0).max() > 0  # the epoch actually trained
    print(f"RESULT {rank} {llv!r} "
          f"{hashlib.sha256(vu.tobytes()).hexdigest()}", flush=True)


def _run_tp(rank, U, I, F, n, w, u, i, offsets, uniq, hist):
    """One explicit-TP window epoch on a (1, 8) mesh: tables row-sharded
    across BOTH processes, the owner-shard gather/psum exchange riding
    the 2-process gloo ring. Model replicas are bit-identical by
    construction, so both ranks must report the same table hash."""
    from rankfm_tpu.parallel import tp as tp_mod

    bs = 128
    mesh = make_mesh(data=1, model=8)
    # host values in, so device_put can lay out each process's shards
    # (re-sharding committed single-device arrays is not allowed
    # cross-process)
    w_np = {k: np.asarray(v) for k, v in w.items()}
    w_tp, xu_t, xi_t = tp_mod.pad_and_place(
        mesh, w_np, np.zeros((U, 1), np.float32),
        np.zeros((I, 1), np.float32))
    fn = tp_mod.tp_epoch_fn(mesh, I, 4, False, False, bs,
                            step_kind="window")
    hist_w = {"packed": tp_mod.pad_packed_hist(mesh, hist, U)}
    w2, ll = fn(w_tp, xu_t, xi_t, hist_w,
                u, i, np.ones(n, np.float32),
                n, jnp.float32(0.1), jnp.float32(0.01), jnp.float32(0.1),
                jax.random.PRNGKey(3), 0)
    out = tp_mod.extract(w2, U, I)
    # v_u is row-sharded ACROSS the two processes — all-gather it to a
    # replicated layout before pulling to host (a plain device_get of a
    # non-fully-addressable array would fail)
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))
    vu = np.asarray(jax.device_get(rep(out["v_u"])))
    llv = float(ll)
    assert np.isfinite(llv) and np.isfinite(vu).all()
    assert np.abs(vu - w_np["v_u"]).max() > 0
    print(f"RESULT {rank} {llv!r} "
          f"{hashlib.sha256(vu.tobytes()).hexdigest()}", flush=True)


if __name__ == "__main__":
    main()
