"""Window-negative layout helpers (`rankfm_tpu.ops.window`): the blocked
16-bit history pack the window step reads membership from, and the block
size / item padding that fix the window geometry."""

import numpy as np
import pytest

from rankfm_tpu.ops import window


def _csr_from_sets(sets):
    offsets = np.zeros(len(sets) + 1, np.int32)
    offsets[1:] = np.cumsum([len(s) for s in sets])
    flat = (np.concatenate(sets).astype(np.int32) if offsets[-1]
            else np.zeros(0, np.int32))
    return offsets, flat


def _unpack(packed, num_items):
    """inverse of the blocked 16-bit pack, for layout verification"""
    blk = window.block_size(num_items)
    lw = blk // window.BITS_PER_LANE
    i_pad = window.item_pad(num_items)
    U = packed.shape[0]
    out = np.zeros((U, i_pad), dtype=bool)
    for i in range(i_pad):
        b, j = divmod(i, blk)
        lane, bit = b * lw + (j % lw), j // lw
        out[:, i] = (packed[:, lane] >> bit) & 1
    return out


@pytest.mark.parametrize("num_items", [60, 128, 1000, 1024, 2500])
def test_pack_history_blocked_layout(num_items):
    U = 5
    rng = np.random.default_rng(0)
    sets = [np.sort(rng.choice(num_items, size=rng.integers(0, 30),
                               replace=False)) for _ in range(U)]
    offsets, flat = _csr_from_sets(sets)
    packed = window.pack_history(offsets, flat, U, num_items)
    got = _unpack(packed, num_items)
    for u in range(U):
        for i in range(num_items):
            assert got[u, i] == (i in sets[u]), (u, i)
        # pad items are marked as members (never sampled as negatives)
        assert got[u, num_items:].all()
    assert packed.max() < 2**16 or packed.min() < 0  # 16 bits per lane


def test_pack_history_device_matches_host():
    U, num_items = 7, 300
    rng = np.random.default_rng(3)
    sets = [np.sort(rng.choice(num_items, size=rng.integers(0, 40),
                               replace=False)) for _ in range(U)]
    offsets, flat = _csr_from_sets(sets)
    host = window.pack_history(offsets, flat, U, num_items)
    dev = np.asarray(window.pack_history_device(offsets, flat, U, num_items))
    np.testing.assert_array_equal(host, dev)


def test_block_size_and_pad():
    assert window.block_size(60) == 128
    assert window.block_size(500) == 512
    assert window.block_size(3706) == 1024
    assert window.item_pad(3706) == 4096
    assert window.item_pad(128) == 128
