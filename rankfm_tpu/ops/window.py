"""Window-negative layout helpers for the window-WARP training step.

The window step (`rankfm_tpu.ops.training.make_window_train_step` and its
table-parallel twin in `rankfm_tpu.parallel.tp`) draws each group's WARP
negatives from ONE contiguous block of ``BLK`` items — the "window". This
module defines everything that fixes the sampling semantics of that step:

* the window block size and the item padding (`block_size`, `item_pad`);
* the catalog-size-weighted block draw (`window_block_cdf`,
  `draw_window_blocks`), so negatives stay uniform over the catalog even
  though the tail block is partial;
* the blocked 16-bit history bit-pack that the step reads membership from
  (`pack_history`, `pack_history_device`).

Plain JAX and numpy; nothing here depends on the backend.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

BITS_PER_LANE = 16  # history bits carried per int32 word of the pack
MIN_BLK = 128
MAX_BLK = 1024


def _round_up(x, m):
    return (x + m - 1) // m * m


def block_size(num_items):
    """Window block size: a POWER OF TWO in [128, 1024] (the step's bit
    extraction shifts by ``col // (BLK/16)``, so BLK/16 must be a power of
    two)."""
    p = 1 << max(MIN_BLK.bit_length() - 1, (max(num_items, 1) - 1).bit_length())
    return min(MAX_BLK, p)


def item_pad(num_items):
    """Item-table padding: a whole number of window blocks."""
    return _round_up(max(num_items, 1), block_size(num_items))


def num_blocks(num_items):
    """Window blocks in the padded catalog (the planner's regime selector)."""
    return item_pad(num_items) // block_size(num_items)


def window_block_cdf(num_items):
    """Cumulative REAL item count per window block (host-side, np).

    Negatives must be uniform over the CATALOG, so window blocks are drawn
    with probability proportional to their real item count — the tail
    block is partial, and a uniform block draw would oversample its items.
    Shared by the single-device and table-parallel window steps so the two
    can never drift in sampling semantics."""
    blk = block_size(num_items)
    return np.minimum(np.arange(1, num_blocks(num_items) + 1) * blk, num_items)


def draw_window_blocks(key, shape, num_items, real_cum=None):
    """``shape``-shaped int32 window-block ids, catalog-size-weighted
    (see `window_block_cdf`)."""
    if real_cum is None:
        real_cum = window_block_cdf(num_items)
    return jnp.searchsorted(
        jnp.asarray(real_cum, jnp.float32),
        jax.random.uniform(key, shape, maxval=float(num_items)),
        side="right").astype(jnp.int32)


def _pack_coords(items, blk):
    """item index -> (lane, bit) in the blocked 16-bit pack.

    Block ``b = i // blk`` occupies words ``[b*LW, (b+1)*LW)`` with
    ``LW = blk/16``; within the block, item ``j`` lives at word ``j % LW``,
    bit ``j // LW``. The step tiles a window's ``LW`` words 16 times along
    the last axis (`jnp.tile`), so window position ``L`` holds word
    ``L % LW`` and reads bit ``L // LW`` of it — exactly item ``L``.
    """
    lw = blk // BITS_PER_LANE
    b = items // blk
    j = items - b * blk
    return b * lw + (j % lw), j // lw


def pad_row(num_items):
    """int32 [W] row with the bits of pad items (>= num_items) set."""
    blk = block_size(num_items)
    i_pad = item_pad(num_items)
    row = np.zeros(i_pad // BITS_PER_LANE, dtype=np.int32)
    pads = np.arange(num_items, i_pad, dtype=np.int64)
    lane, bit = _pack_coords(pads, blk)
    np.bitwise_or.at(row, lane, np.int32(1) << bit)
    return row


def pack_history(offsets, flat_items, num_users, num_items):
    """Host-side blocked 16-bit history pack -> int32 [U, NBLK*BLK/16].

    Items ``>= num_items`` (window padding) are marked as members for every
    user so they can never be drawn as negatives.
    """
    blk = block_size(num_items)
    packed = np.zeros((num_users, item_pad(num_items) // BITS_PER_LANE),
                      dtype=np.int32)
    counts = np.diff(offsets).astype(np.int64)
    users = np.repeat(np.arange(num_users, dtype=np.int64), counts)
    lane, bit = _pack_coords(flat_items.astype(np.int64), blk)
    np.bitwise_or.at(packed, (users, lane), np.int32(1) << bit)
    packed |= pad_row(num_items)[None, :]
    return packed


@partial(jax.jit, static_argnums=(3, 4))
def _pack_scatter(users, items, padrow, num_users, blk):
    lane, bit = _pack_coords(items, blk)  # dtype-agnostic: works on jnp
    packed = jnp.zeros((num_users, padrow.shape[0]), dtype=jnp.int32).at[
        users, lane].add(jnp.int32(1) << bit, mode="drop")
    return packed | padrow[None, :]


def pack_history_device(offsets, flat_items, num_users, num_items):
    """Device-side history pack (one XLA scatter instead of a host loop).
    Each (user, item) pair appears once in the CSR, so the scatter-add of
    distinct bits equals their bitwise OR."""
    blk = block_size(num_items)
    counts = np.diff(np.asarray(offsets)).astype(np.int64)
    users = np.repeat(np.arange(num_users, dtype=np.int32), counts)
    return _pack_scatter(jnp.asarray(users),
                         jnp.asarray(flat_items, dtype=jnp.int32),
                         jnp.asarray(pad_row(num_items)),
                         num_users, blk)
