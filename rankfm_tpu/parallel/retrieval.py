"""Sharded top-N retrieval: per-shard scoring + local top-k + cross-shard merge.

The long axis in retrieval is the item catalog I (`_rankfm.pyx:440-444` scans
it per user). Here the item-side matrices are row-sharded over the ``model``
mesh axis; each shard computes scores only for its own item rows, takes a
local ``top_k``, and the ``k``-sized candidate lists are all-gathered and
merged — an exact MIPS-style distributed top-k: communication is
O(shards * B * k), never O(B * I).

Built with `shard_map` so the collective schedule is explicit (one
all-gather of the k-sized candidate lists), unlike the GSPMD training path
where XLA chooses.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from rankfm_tpu.ops import scoring

NEG_INF = float("-inf")  # plain float: a jnp scalar here would init the device backend at IMPORT time


def _local_topk_kernel(u_mat, i_mat, item_bias, seen_rows, seen_cols, n_items,
                       items_per_shard, axis="model"):
    """Runs per model-shard: score the local item rows, mask seen, local top-k,
    all-gather + merge. ``i_mat``/``item_bias`` are the LOCAL shard rows."""
    shard = jax.lax.axis_index(axis)
    offset = shard * items_per_shard

    scores = jnp.dot(u_mat, i_mat.T, precision=scoring.SERVING_PRECISION,
                     preferred_element_type=jnp.float32)
    scores = scores + item_bias[None, :]                       # [B, I_shard]

    # mask previously-seen items that live on this shard
    if seen_rows.shape[0] > 0:
        local_col = seen_cols - offset
        on_shard = (seen_rows >= 0) & (local_col >= 0) & (local_col < items_per_shard)
        rows = jnp.where(on_shard, seen_rows, 0)
        cols = jnp.where(on_shard, local_col, 0)
        scores = scores.at[rows, cols].add(jnp.where(on_shard, NEG_INF, 0.0))

    k = min(n_items, items_per_shard)
    local_vals, local_idx = jax.lax.top_k(scores, k)           # [B, k]
    local_idx = local_idx + offset

    all_vals = jax.lax.all_gather(local_vals, axis)            # [S, B, k]
    all_idx = jax.lax.all_gather(local_idx, axis)
    S = all_vals.shape[0]
    B = all_vals.shape[1]
    merged_vals = jnp.transpose(all_vals, (1, 0, 2)).reshape(B, S * k)
    merged_idx = jnp.transpose(all_idx, (1, 0, 2)).reshape(B, S * k)

    top_vals, pos = jax.lax.top_k(merged_vals, n_items)        # [B, n]
    top_idx = jnp.take_along_axis(merged_idx, pos, axis=1)
    # exhausted-catalog convention (see ops/topk.py): -inf-masked seen/pad
    # slots come back as -1, mapped to NaN at the API edge
    top_idx = jnp.where(jnp.isneginf(top_vals), -1, top_idx)
    return top_idx.astype(jnp.int32), top_vals


def make_sharded_topk(mesh, n_items, num_items_padded):
    """Build the jitted sharded retrieval function.

    Expects item-side inputs PADDED so ``num_items_padded`` divides evenly by
    the model-axis size (pad rows carry bias ``-inf`` so they never surface).

    Signature: ``fn(u_mat [B,2F], i_mat [I_pad,2F], item_bias [I_pad],
    seen_rows, seen_cols) -> (top_idx [B,n], top_vals [B,n])``.
    """
    n_shards = mesh.shape["model"]
    assert num_items_padded % n_shards == 0
    items_per_shard = num_items_padded // n_shards

    kernel = partial(
        _local_topk_kernel,
        n_items=n_items,
        items_per_shard=items_per_shard,
    )
    mapped = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(), P("model", None), P("model"), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def make_sharded_recommend(mesh, n_items, num_items):
    """Full model-facing sharded retrieval: builds the 2F user/item matrices
    from the weight pytree, pads the item axis to the shard grid (pad bias
    -inf so pad rows never surface), and runs the per-shard top-k merge.

    Signature: ``fn(w, x_uf, x_if, u_idx, seen_rows, seen_cols)
    -> (top_idx, top_vals)`` — same contract as `rankfm_tpu.ops.topk.topk_fn`.
    """
    shards = mesh.shape["model"]
    i_pad = (num_items + shards - 1) // shards * shards
    topk = make_sharded_topk(mesh, n_items, i_pad)

    def fn(w, x_uf, x_if, u_idx, seen_rows, seen_cols):
        ur = scoring.user_reps(w, x_uf)
        ir = scoring.item_reps(w, x_if)
        ib = scoring.item_biases(w, x_if)
        u_mat = jnp.concatenate([ur[u_idx], w["v_u"][u_idx]], axis=-1)
        i_mat = jnp.concatenate([w["v_i"], ir - w["v_i"]], axis=-1)
        pad = i_pad - num_items
        if pad:
            i_mat = jnp.pad(i_mat, ((0, pad), (0, 0)))
            ib = jnp.pad(ib, (0, pad), constant_values=NEG_INF)
        return topk(u_mat, i_mat, ib, seen_rows, seen_cols)

    return jax.jit(fn)
