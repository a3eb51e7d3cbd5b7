"""On-device negative sampling against ragged user histories.

The accelerator replacement for the reference's rejection loop
(`/root/reference/rankfm/_rankfm.pyx:249-252`): draw ``j = rand() % I`` and
reject while ``j`` is in the user's sorted item array (`lsearch`,
`_rankfm.pyx:20-27`).

Here the per-user histories live in a CSR pair ``(offsets [U+1], flat [nnz])``
with rows sorted ascending, and membership is a fully vectorized binary search
(fixed trip count, no data-dependent control flow). Rejection re-draws run for
a fixed number of rounds; the residual probability that a sampled candidate is
still a member after R rounds is (h_u / I)^(R+1), negligible for real data —
survivors are flagged invalid and masked out of the loss downstream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def csr_member(flat_items, offsets, u, j, max_row_len=None):
    """Vectorized membership test: is item ``j`` in user ``u``'s sorted row?

    ``u`` and ``j`` are int32 arrays of identical (arbitrary) shape.
    Returns a bool array of the same shape. Binary search with a static trip
    count of ceil(log2(max_row_len)) + 1 — pass the host-known longest row
    (``np.diff(offsets).max()``) to avoid the loose total-nnz bound
    (~20 rounds at ML-1M nnz where the longest history needs ~12).
    """
    nnz = flat_items.shape[0]
    if nnz == 0:
        return jnp.zeros(u.shape, dtype=bool)
    lo = offsets[u].astype(jnp.int32)
    hi = offsets[u + 1].astype(jnp.int32)
    # max possible row length bounds the search depth
    iters = max(1, int(max_row_len if max_row_len else nnz).bit_length())

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) // 2
        mid_val = flat_items[jnp.clip(mid, 0, nnz - 1)]
        go_right = (mid_val < j) & (lo < hi)
        new_lo = jnp.where(go_right, mid + 1, lo)
        new_hi = jnp.where(go_right | (lo >= hi), hi, mid)
        return new_lo, new_hi

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    found_val = flat_items[jnp.clip(lo, 0, nnz - 1)]
    return (lo < offsets[u + 1]) & (found_val == j)


def build_bitmap_words(offsets, flat_items, num_users, num_items):
    """Host-side: pack each user's item history into a [U, ceil(I/32)] uint32
    bitmap. One row gather + bit test replaces the O(log nnz) binary search —
    the fast membership path when U * I / 8 bytes is affordable."""
    import numpy as np

    words = (num_items + 31) // 32
    bm = np.zeros((num_users, words), dtype=np.uint32)
    counts = np.diff(offsets).astype(np.int64)
    users = np.repeat(np.arange(num_users, dtype=np.int64), counts)
    items = flat_items.astype(np.int64)
    np.bitwise_or.at(bm, (users, items >> 5), (np.uint32(1) << (items & 31).astype(np.uint32)))
    return bm


def bitmap_member(bitmap_words, u, j):
    """Vectorized membership test against the packed bitmap.

    ``u [B]``, ``j [B, K]`` -> bool [B, K]. One contiguous row gather
    (``bitmap[u]``) plus an in-row take_along_axis — cheaper than
    per-element 2-D gathers.
    """
    return _rows_member(bitmap_words[u], j)


def _rows_member(rows, j):
    """Bit test of items ``j [B, K]`` against pre-gathered bitmap rows
    ``rows [B, words]`` — the single home of the word/bit layout contract
    (`build_bitmap_words`)."""
    word = jnp.take_along_axis(rows, (j >> 5).astype(jnp.int32), axis=1)
    bit = (word >> (j & 31).astype(jnp.uint32)) & jnp.uint32(1)
    return bit.astype(bool)


def sample_negatives_bitmap(key, u, bitmap_words, num_items, max_samples, rounds=2):
    """Bitmap-backed negative sampling: draw ``rounds`` candidate sets up
    front, test membership against the gathered bitmap rows, take the first
    non-member per slot.

    All arrays stay in ``[B, M]`` layout — no 3-D reshapes (a trailing dim of
    ``rounds`` would force a relayout of every candidate array). Residual
    all-member slots (probability (h_u/I)^rounds) are flagged invalid and
    masked downstream, mirroring `sample_negatives`.
    """
    B = u.shape[0]
    M = max_samples
    rows = bitmap_words[u]                                    # [B, words] one gather

    def member_of(j):
        return _rows_member(rows, j)

    keys = jax.random.split(key, rounds)
    chosen = jax.random.randint(keys[0], (B, M), 0, num_items, dtype=jnp.int32)
    still_member = member_of(chosen)
    for r in range(1, rounds):
        fresh = jax.random.randint(keys[r], (B, M), 0, num_items, dtype=jnp.int32)
        chosen = jnp.where(still_member, fresh, chosen)
        still_member = jnp.where(still_member, member_of(fresh), still_member)
    return chosen, ~still_member


def sample_negatives(key, u, offsets, flat_items, num_items, max_samples,
                     rounds=8, max_row_len=None):
    """Draw ``[B, max_samples]`` candidate negative items for each user in ``u``.

    Rejection sampling with ``rounds`` fixed re-draw rounds against the user's
    history. Returns ``(candidates int32 [B, M], valid bool [B, M])`` where
    ``valid`` is False for the (vanishingly rare) candidates still in-history
    after all rounds. ``max_row_len`` tightens the per-round binary-search
    depth (see `csr_member`).
    """
    B = u.shape[0]
    M = max_samples
    u_bm = jnp.broadcast_to(u[:, None], (B, M))

    def draw(k):
        return jax.random.randint(k, (B, M), 0, num_items, dtype=jnp.int32)

    keys = jax.random.split(key, rounds + 1)
    cand = draw(keys[0])
    member = csr_member(flat_items, offsets, u_bm, cand, max_row_len)

    def body(r, carry):
        cand, member = carry
        fresh = jax.random.randint(
            jax.random.fold_in(keys[1], r), (B, M), 0, num_items, dtype=jnp.int32
        )
        cand = jnp.where(member, fresh, cand)
        member = csr_member(flat_items, offsets, u_bm, cand, max_row_len)
        return cand, member

    cand, member = jax.lax.fori_loop(0, rounds, body, (cand, member))
    return cand, ~member
