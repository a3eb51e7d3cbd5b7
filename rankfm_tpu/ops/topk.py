"""Top-N retrieval: one matmul over the whole catalog + `lax.top_k`.

Replaces the reference's slowest path — a per-user Python/C loop scoring all
items, a full `np.argsort`, and Python-set membership filtering
(`/root/reference/rankfm/_rankfm.pyx:393-460`; 45.6 s for ~10k users x 33k
items per `BASELINE.md`). Here: batched ``[B, 2F] x [2F, I]`` scores,
previously-seen items masked to -inf, and a single ``lax.top_k``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rankfm_tpu.ops import scoring

NEG_INF = float("-inf")  # plain float: a jnp scalar here would init the device backend at IMPORT time


def topk_for_users(w, x_uf, x_if, u_idx, n_items, seen_rows, seen_cols):
    """Top-``n_items`` item indices (and scores) for each user in ``u_idx``.

    ``seen_rows``/``seen_cols`` are flat int32 arrays of (batch-row, item)
    pairs to exclude (already-seen items when ``filter_previous=True``);
    pass empty arrays to disable filtering. Pad entries must point at row 0 /
    col 0 with ``seen_rows`` values repeated — use ``row < 0`` sentinel to
    disable a pad slot.
    """
    scores = scoring.score_all_items(w, x_uf, x_if, u_idx)          # [B, I]
    if seen_rows.shape[0] > 0:
        ok = seen_rows >= 0
        rows = jnp.where(ok, seen_rows, 0)
        cols = jnp.where(ok, seen_cols, 0)
        scores = scores.at[rows, cols].add(jnp.where(ok, NEG_INF, 0.0))
    top_scores, top_items = jax.lax.top_k(scores, n_items)
    # a user with fewer than n_items unseen items would otherwise get
    # -inf-masked SEEN items back as apparently valid recommendations;
    # emit -1 (mapped to NaN at the API edge) for those slots
    top_items = jnp.where(jnp.isneginf(top_scores), -1, top_items)
    return top_items.astype(jnp.int32), top_scores


def topk_fn(n_items):
    """A jitted closure over ``n_items`` (static for `top_k`)."""
    return jax.jit(
        lambda w, x_uf, x_if, u_idx, seen_rows, seen_cols: topk_for_users(
            w, x_uf, x_if, u_idx, n_items, seen_rows, seen_cols
        )
    )


def topk_bitmap_fn(n_items, num_items):
    """Top-N with previously-seen filtering driven by the packed membership
    bitmap: one row gather + an elementwise bit expansion instead of a
    scatter of -inf into the score matrix."""

    def fn(w, x_uf, x_if, u_idx, bitmap_words):
        scores = scoring.score_all_items(w, x_uf, x_if, u_idx)      # [B, I]
        rows = bitmap_words[u_idx]                                  # [B, W32]
        rep = jnp.repeat(rows, 32, axis=1)[:, :num_items]           # [B, I]
        col = jax.lax.broadcasted_iota(jnp.uint32, rep.shape, 1)
        seen = (rep >> (col & jnp.uint32(31))) & jnp.uint32(1)
        scores = jnp.where(seen.astype(bool), NEG_INF, scores)
        top_scores, top_items = jax.lax.top_k(scores, n_items)
        # same exhausted-catalog convention as `topk_for_users`
        top_items = jnp.where(jnp.isneginf(top_scores), -1, top_items)
        return top_items.astype(jnp.int32), top_scores

    return jax.jit(fn)
