"""Native C++ data-pipeline tests: results must be identical to the numpy /
pandas paths."""

import ctypes
import platform
import subprocess

import numpy as np
import pandas as pd
import pytest

from parity_common import make_latent_dataset
from rankfm_tpu import RankFM, native
from rankfm_tpu.utils import data


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_unique_sorted(lib):
    rng = np.random.default_rng(0)
    ids = rng.integers(-10**12, 10**12, 10000)
    got = native.unique_sorted(ids)
    np.testing.assert_array_equal(got, np.unique(ids))


def test_map_ids(lib):
    rng = np.random.default_rng(1)
    uniq = np.unique(rng.integers(0, 10**9, 500))
    raw = np.concatenate([rng.choice(uniq, 2000), rng.integers(10**10, 10**11, 50)])
    rng.shuffle(raw)
    got = native.map_ids(raw, uniq)
    want = pd.Series(raw).map(pd.Series(np.arange(len(uniq)), index=uniq)).fillna(-1).values
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_map_ids_both_lookup_regimes(lib):
    """round-5 rewrite: map_ids picks a direct range table for
    near-contiguous vocabularies and an open-addressing hash for sparse
    (snowflake-scale) ids — both must reproduce the searchsorted oracle
    exactly, including unknowns below/above/inside the vocabulary range
    and negative raw ids."""
    rng = np.random.default_rng(7)

    def oracle(raw, su):
        pos = np.minimum(np.searchsorted(su, raw), len(su) - 1)
        return np.where(su[pos] == raw, pos, -1).astype(np.int32)

    # dense range (span == m): the table path
    su = np.arange(100, 100 + 5000, dtype=np.int64)
    raw = np.concatenate([rng.integers(0, 6000, 20000),
                          np.array([-5, 99, 100, 5099, 5100])]).astype(np.int64)
    np.testing.assert_array_equal(native.map_ids(raw, su), oracle(raw, su))
    # sparse 64-bit ids (span >> 8m): the hash path
    su2 = np.unique(rng.integers(-2**62, 2**62, 5000).astype(np.int64))
    raw2 = np.concatenate([rng.choice(su2, 20000),
                           rng.integers(-2**62, 2**62, 5000)]).astype(np.int64)
    np.testing.assert_array_equal(native.map_ids(raw2, su2),
                                  oracle(raw2, su2))
    # single-id vocabulary and empty-ish edges
    su3 = np.array([42], dtype=np.int64)
    raw3 = np.array([41, 42, 43], dtype=np.int64)
    np.testing.assert_array_equal(native.map_ids(raw3, su3), [-1, 0, -1])
    # tiny query against a big vocabulary (n*8 < m): the binary-search
    # fallback — building an O(m) structure per interactive
    # recommend([one_user]) call would be the regression the round-5
    # review flagged
    raw5 = np.concatenate([rng.choice(su2, 10),
                           [int(su2[0]) - 1]]).astype(np.int64)
    np.testing.assert_array_equal(native.map_ids(raw5, su2),
                                  oracle(raw5, su2))
    # vocabulary spanning (almost) the whole int64 range: hi - lo
    # overflows SIGNED arithmetic — must take the hash path, not a
    # wrapped-span table (and span==0 full wrap must not allocate a
    # 0-slot table)
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    su4 = np.array([lo, -7, 0, 123, hi], dtype=np.int64)
    raw4 = np.array([lo, hi, 0, 122, 123, -7, 55], dtype=np.int64)
    np.testing.assert_array_equal(native.map_ids(raw4, su4),
                                  [0, 4, 2, -1, 3, 1, -1])


def test_build_csr_matches_numpy(lib):
    rng = np.random.default_rng(2)
    U = 50
    pairs = np.stack([rng.integers(0, U, 3000), rng.integers(0, 200, 3000)], 1).astype(np.int32)
    got_off, got_items = native.build_csr(pairs[:, 0], pairs[:, 1], U)

    uniq = np.unique(pairs, axis=0)
    counts = np.bincount(uniq[:, 0], minlength=U)
    want_off = np.zeros(U + 1, np.int32)
    want_off[1:] = np.cumsum(counts)
    np.testing.assert_array_equal(got_off, want_off)
    np.testing.assert_array_equal(got_items, uniq[:, 1].astype(np.int32))


def test_data_pipeline_native_vs_pandas_end_to_end(lib):
    """map_interactions + build_user_items_csr agree between paths"""
    rng = np.random.default_rng(3)
    raw_u = rng.choice(np.arange(100, 200), 5000)
    raw_i = rng.choice(np.arange(9000, 9100), 5000)
    inter = np.stack([raw_u, raw_i], 1)
    _, u2i = data.build_index(inter[:, 0])
    _, i2i = data.build_index(inter[:, 1])

    pairs_native, keep_native = data.map_interactions(inter, u2i, i2i)

    # force the pandas path by casting ids to object strings
    inter_str = inter.astype(str).astype(object)
    _, u2i_s = data.build_index(inter_str[:, 0])
    _, i2i_s = data.build_index(inter_str[:, 1])
    pairs_pd, keep_pd = data.map_interactions(inter_str, u2i_s, i2i_s)

    # string sort order over equal-length numeric strings == numeric order here
    np.testing.assert_array_equal(pairs_native, pairs_pd)
    np.testing.assert_array_equal(keep_native, keep_pd)


def test_ingest_vocabulary_containing_int64_min(lib):
    """the fit-path IdHash used INT64_MIN as its empty-slot marker, so a
    vocabulary CONTAINING that id was silently corrupted (its insert left
    the slot looking empty; rows could map to the wrong user) — round-5
    self-review. The marker is now vals==-1; pin the full native ingest
    on such a vocabulary."""
    lo = np.iinfo(np.int64).min
    u = np.array([lo, lo, 5, 5, 9], dtype=np.int64)
    i = np.array([1, 2, 1, 3, 2], dtype=np.int64)
    uids, iids = np.unique(u), np.unique(i)
    pairs, keep, offsets, items = native.ingest(u, i, uids, iids)
    assert keep.all()
    want = [[0, 0], [0, 1], [1, 0], [1, 2], [2, 1]]
    np.testing.assert_array_equal(pairs, want)
    # CSR row for user INT64_MIN (index 0) holds items {0, 1}
    assert list(items[offsets[0]:offsets[1]]) == [0, 1]


def test_uint64_ids_above_int63_do_not_wrap():
    """uint64 vocabularies with values >= 2^63 must NOT take the int64
    native path (they would wrap negative and corrupt the sorted order) —
    build_index must fall back and sort them correctly"""
    big = np.uint64(2**63 + 7)
    ids = np.array([big, np.uint64(5), big, np.uint64(9)], dtype=np.uint64)
    assert data._int64_view(ids) is None
    vocab, to_index = data.build_index(ids)
    assert list(vocab.values) == [np.uint64(5), np.uint64(9), big]
    assert int(to_index.loc[big]) == 2


def test_uint64_ids_small_range_take_native_path():
    ids = np.array([3, 1, 2], dtype=np.uint64)
    iv = data._int64_view(ids)
    assert iv is not None and iv.dtype == np.int64


def test_oracle_fit_is_the_same_for_every_x86_target(tmp_path, monkeypatch):
    """the oracle, built with the package's flags for an AVX2 target and
    for this host, trains bitwise the same weights: the reference must not
    move with the machine it is built on (with multiply-add contraction
    left on, the F=20 loops below differ in the last bit)"""
    assert platform.machine() in ("x86_64", "AMD64")
    train, _ = make_latent_dataset(np.random.default_rng(3), n_users=400,
                                   n_items=600, per_user=40)
    model = RankFM(factors=20, loss="warp", max_samples=20, seed=3)
    model._init_all(train)
    w0 = {k: np.asarray(v) for k, v in model._weights.items()}
    out = {}
    for march in ("native", "x86-64-v3"):
        so = tmp_path / f"oracle-{march}.so"
        flags = [f if not f.startswith("-march=") else f"-march={march}"
                 for f in native._CXXFLAGS]
        subprocess.run(["g++", *flags, "-o", str(so), native.ORACLE_SRC],
                       check=True, capture_output=True)
        monkeypatch.setattr(native, "_oracle_lib",
                            native.bind_oracle(ctypes.CDLL(str(so))))
        out[march], _ = native.oracle_fit(
            model.interactions, model.sample_weight, model._ui_offsets,
            model._ui_items, model.x_uf, model.x_if, w0, 0.01, 0.1, 0.1,
            "invscaling", 0.25, 20, 2, 3)
    for k in w0:
        np.testing.assert_array_equal(out["native"][k], out["x86-64-v3"][k],
                                      err_msg=k)
