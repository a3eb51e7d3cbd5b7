"""Unit tests for the compute core: FM scoring math vs an independent numpy
oracle of the reference equation (`/root/reference/rankfm/_rankfm.pyx:48-89`),
CSR membership search, WARP selection semantics, and the decay correction."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rankfm_tpu.ops import scoring
from rankfm_tpu.ops.negatives import csr_member, sample_negatives
from rankfm_tpu.ops.training import _decay_apply, make_train_step


def _random_state(rng, U=7, I=11, P=3, Q=4, F=5):
    w = {
        "w_i": rng.normal(size=I).astype(np.float32),
        "w_if": rng.normal(size=Q).astype(np.float32),
        "v_u": rng.normal(size=(U, F)).astype(np.float32),
        "v_i": rng.normal(size=(I, F)).astype(np.float32),
        "v_uf": rng.normal(size=(P, F)).astype(np.float32),
        "v_if": rng.normal(size=(Q, F)).astype(np.float32),
    }
    x_uf = rng.normal(size=(U, P)).astype(np.float32)
    x_if = rng.normal(size=(I, Q)).astype(np.float32)
    return w, x_uf, x_if


def _oracle_score(w, x_uf, x_if, u, i):
    """independent numpy implementation of the reference FM utility"""
    return (
        w["w_i"][i]
        + x_if[i] @ w["w_if"]
        + w["v_u"][u] @ w["v_i"][i]
        + x_uf[u] @ (w["v_uf"] @ w["v_i"][i])
        + x_if[i] @ (w["v_if"] @ w["v_u"][u])
    )


def test_score_pairs_matches_oracle():
    rng = np.random.default_rng(0)
    w, x_uf, x_if = _random_state(rng)
    u = rng.integers(0, 7, size=20).astype(np.int32)
    i = rng.integers(0, 11, size=20).astype(np.int32)
    got = np.asarray(scoring.score_pairs(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x_uf), jnp.asarray(x_if),
        jnp.asarray(u), jnp.asarray(i)))
    want = np.array([_oracle_score(w, x_uf, x_if, uu, ii) for uu, ii in zip(u, i)])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_score_all_items_matches_oracle():
    rng = np.random.default_rng(1)
    w, x_uf, x_if = _random_state(rng)
    u = np.array([0, 3, 6], dtype=np.int32)
    got = np.asarray(scoring.score_all_items(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x_uf), jnp.asarray(x_if),
        jnp.asarray(u)))
    want = np.array([[_oracle_score(w, x_uf, x_if, uu, ii) for ii in range(11)] for uu in u])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_csr_member():
    rng = np.random.default_rng(2)
    U, I = 20, 50
    sets = [np.sort(rng.choice(I, size=rng.integers(0, 15), replace=False)) for _ in range(U)]
    offsets = np.zeros(U + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(s) for s in sets])
    flat = np.concatenate(sets).astype(np.int32) if offsets[-1] else np.zeros(0, np.int32)

    u = np.repeat(np.arange(U, dtype=np.int32), I)
    j = np.tile(np.arange(I, dtype=np.int32), U)
    got = np.asarray(csr_member(jnp.asarray(flat), jnp.asarray(offsets),
                                jnp.asarray(u), jnp.asarray(j)))
    want = np.array([jj in sets[uu] for uu, jj in zip(u, j)])
    np.testing.assert_array_equal(got, want)


def test_csr_member_empty():
    offsets = np.zeros(4, dtype=np.int32)
    flat = np.zeros(0, dtype=np.int32)
    got = np.asarray(csr_member(jnp.asarray(flat), jnp.asarray(offsets),
                                jnp.asarray(np.array([0, 1], np.int32)),
                                jnp.asarray(np.array([5, 7], np.int32))))
    assert not got.any()


def test_sample_negatives_avoids_history():
    rng = np.random.default_rng(3)
    U, I = 10, 100
    sets = [np.sort(rng.choice(I, size=30, replace=False)) for _ in range(U)]
    offsets = np.zeros(U + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(s) for s in sets])
    flat = np.concatenate(sets).astype(np.int32)

    u = np.arange(U, dtype=np.int32).repeat(16)
    cands, ok = sample_negatives(
        jax.random.PRNGKey(0), jnp.asarray(u), jnp.asarray(offsets), jnp.asarray(flat),
        I, max_samples=8, rounds=8)
    cands, ok = np.asarray(cands), np.asarray(ok)
    assert cands.shape == (160, 8)
    # every candidate marked valid must be outside the user's history
    for b in range(cands.shape[0]):
        for m in range(8):
            if ok[b, m]:
                assert cands[b, m] not in sets[u[b]]
    assert ok.mean() > 0.99  # rejection converges


def test_bitmap_member_and_sampler():
    from rankfm_tpu.ops.negatives import (
        bitmap_member, build_bitmap_words, sample_negatives_bitmap)
    rng = np.random.default_rng(6)
    U, I = 15, 200
    sets = [np.sort(rng.choice(I, size=rng.integers(0, 40), replace=False)) for _ in range(U)]
    offsets = np.zeros(U + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(s) for s in sets])
    flat = (np.concatenate(sets).astype(np.int32) if offsets[-1]
            else np.zeros(0, np.int32))
    bm = jnp.asarray(build_bitmap_words(offsets, flat, U, I))

    u = np.repeat(np.arange(U, dtype=np.int32), I)
    j = np.tile(np.arange(I, dtype=np.int32), U)
    got = np.asarray(bitmap_member(bm, jnp.asarray(u), jnp.asarray(j)[:, None]))[:, 0]
    want = np.array([jj in sets[uu] for uu, jj in zip(u, j)])
    np.testing.assert_array_equal(got, want)

    ub = jnp.asarray(np.arange(U, dtype=np.int32).repeat(8))
    cands, ok = sample_negatives_bitmap(jax.random.PRNGKey(0), ub, bm, I, 6, rounds=3)
    cands, ok = np.asarray(cands), np.asarray(ok)
    assert cands.shape == (U * 8, 6)
    for b in range(cands.shape[0]):
        for m in range(6):
            if ok[b, m]:
                assert cands[b, m] not in sets[int(ub[b])]
    assert ok.mean() > 0.95


def test_decay_fixed_point():
    """the geometric correction must preserve the sequential fixed point
    w* = E[g] / (2*reg) for a dense weight touched every sample"""
    eta, reg, B = 0.1, 0.1, 512
    g_mean = 0.7
    # sequential oracle
    w_seq = 0.0
    for _ in range(B * 20):
        w_seq = w_seq + eta * (g_mean - 2 * reg * w_seq)
    # batched with correction
    w_b = jnp.zeros(())
    for _ in range(20):
        w_b = _decay_apply(w_b, jnp.asarray(B * g_mean), jnp.asarray(float(B)), eta, reg)
    np.testing.assert_allclose(float(w_b), w_seq, rtol=1e-3)
    np.testing.assert_allclose(w_seq, g_mean / (2 * reg), rtol=1e-3)


def test_decay_untouched_rows_unchanged():
    w = jnp.asarray(np.ones((4, 3), np.float32))
    g = jnp.zeros((4, 3))
    k = jnp.asarray(np.array([0.0, 1.0, 0.0, 2.0], np.float32))
    out = np.asarray(_decay_apply(w, g, k, 0.1, 0.01))
    np.testing.assert_allclose(out[0], 1.0)
    np.testing.assert_allclose(out[2], 1.0)
    assert (out[1] < 1.0).all() and (out[3] < out[1]).all()


def _warp_oracle(pairwise_row, ok_row, M):
    """sequential WARP selection per the reference (`_rankfm.pyx:244-269`)"""
    min_idx, min_pu = -1, 1e6
    sampled = M
    for m in range(M):
        if not ok_row[m]:
            continue
        pu = pairwise_row[m]
        if pu < min_pu:
            min_idx, min_pu = m, pu
        if pu < 1.0:
            sampled = m + 1
            break
    return min_idx, sampled


def test_warp_selection_semantics():
    """vectorized first-violation/argmin selection == sequential oracle"""
    rng = np.random.default_rng(4)
    M = 12
    for trial in range(200):
        pw = rng.normal(loc=1.5, scale=1.0, size=M).astype(np.float32)
        ok = np.ones(M, bool)
        # vectorized recreation of the logic in make_train_step
        p = np.where(ok, pw, np.inf)
        viol = p < 1.0
        any_v = viol.any()
        first = int(np.argmax(viol))
        sel = first if any_v else int(np.argmin(p))
        sampled = first + 1 if any_v else M
        o_sel, o_sampled = _warp_oracle(pw, ok, M)
        assert sel == o_sel, (trial, pw)
        assert sampled == o_sampled, (trial, pw)


def test_train_step_moves_pair_apart():
    """one batch step must raise s(u, pos) - s(u, neg) for observed pairs"""
    rng = np.random.default_rng(5)
    U, I, F = 4, 8, 4
    w = {
        "w_i": jnp.zeros(I), "w_if": jnp.zeros(1),
        "v_u": jnp.asarray(rng.normal(0, 0.1, (U, F)).astype(np.float32)),
        "v_i": jnp.asarray(rng.normal(0, 0.1, (I, F)).astype(np.float32)),
        "v_uf": jnp.zeros((1, F)), "v_if": jnp.zeros((1, F)),
    }
    x_uf = jnp.zeros((U, 1))
    x_if = jnp.zeros((I, 1))
    # user u likes item u (and only that)
    pairs = np.stack([np.arange(U), np.arange(U)], 1).astype(np.int32)
    offsets = np.arange(U + 1, dtype=np.int32)
    flat = np.arange(U, dtype=np.int32)

    step = make_train_step(I, 1, False, False)
    hist = {"offsets": jnp.asarray(offsets), "flat": jnp.asarray(flat),
            "bitmap": jnp.zeros((1, 1), jnp.uint32)}
    u, i = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
    sw = jnp.ones(U)
    valid = jnp.ones(U, bool)

    def mean_margin(wt):
        pos = scoring.score_pairs(wt, x_uf, x_if, u, i)
        all_s = scoring.score_all_items(wt, x_uf, x_if, u)
        return float(jnp.mean(pos[:, None] - all_s))

    before = mean_margin(w)
    for t in range(50):
        w, ll = step(w, x_uf, x_if, hist,
                     u, i, sw, valid, jnp.float32(0.1), jnp.float32(0.01),
                     jnp.float32(0.1), jax.random.PRNGKey(t))
    after = mean_margin(w)
    assert after > before + 0.1


def test_window_train_step_moves_pair_apart():
    """the window-WARP step must learn too"""
    from rankfm_tpu.ops.training import make_window_train_step
    from rankfm_tpu.ops.window import pack_history

    rng = np.random.default_rng(6)
    U, I, F = 4, 8, 4
    w = {
        "w_i": jnp.zeros(I), "w_if": jnp.zeros(1),
        "v_u": jnp.asarray(rng.normal(0, 0.1, (U, F)).astype(np.float32)),
        "v_i": jnp.asarray(rng.normal(0, 0.1, (I, F)).astype(np.float32)),
        "v_uf": jnp.zeros((1, F)), "v_if": jnp.zeros((1, F)),
    }
    x_uf = jnp.zeros((U, 1))
    x_if = jnp.zeros((I, 1))
    pairs = np.stack([np.arange(U), np.arange(U)], 1).astype(np.int32)
    offsets = np.arange(U + 1, dtype=np.int32)
    flat = np.arange(U, dtype=np.int32)
    packed = jnp.asarray(pack_history(offsets, flat, U, I))

    for M in (1, 5):
        wt = dict(w)
        step = make_window_train_step(I, M, False, False)
        u, i = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
        sw = jnp.ones(U)
        valid = jnp.ones(U, bool)

        def mean_margin(wx):
            pos = scoring.score_pairs(wx, x_uf, x_if, u, i)
            all_s = scoring.score_all_items(wx, x_uf, x_if, u)
            return float(jnp.mean(pos[:, None] - all_s))

        before = mean_margin(wt)
        for t in range(50):
            wt, ll = step(wt, x_uf, x_if, packed,
                          u, i, sw, valid, jnp.float32(0.1), jnp.float32(0.01),
                          jnp.float32(0.1), jax.random.PRNGKey(t))
        after = mean_margin(wt)
        assert after > before + 0.1, (M, before, after)
        assert np.isfinite(float(ll))


@pytest.mark.parametrize("sampler", ["bitmap", "bsearch"])
def test_candidate_step_post_reject_never_updates_members(sampler):
    """post-hoc rejection: the selected negative is never a history member
    (bitmap lookup, or CSR binary search for bitmap-too-big catalogs)"""
    from rankfm_tpu.ops.negatives import build_bitmap_words

    rng = np.random.default_rng(8)
    U, I, F, M = 6, 40, 4, 6
    w = {
        "w_i": jnp.zeros(I), "w_if": jnp.zeros(1),
        "v_u": jnp.asarray(rng.normal(0, 0.1, (U, F)).astype(np.float32)),
        "v_i": jnp.asarray(rng.normal(0, 0.1, (I, F)).astype(np.float32)),
        "v_uf": jnp.zeros((1, F)), "v_if": jnp.zeros((1, F)),
    }
    x_uf = jnp.zeros((U, 1))
    x_if = jnp.zeros((I, 1))
    # heavy histories (50% of catalog) to stress member pollution
    sets = [np.sort(rng.choice(I, size=I // 2, replace=False)) for _ in range(U)]
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum([len(s) for s in sets])
    flat = np.concatenate(sets).astype(np.int32)
    bm = jnp.asarray(build_bitmap_words(offsets, flat, U, I))
    hist = {"offsets": jnp.asarray(offsets), "flat": jnp.asarray(flat),
            "bitmap": bm}

    step = make_train_step(I, M, False, False, sampler=sampler,
                           post_reject=True)
    B = 64
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    i = jnp.asarray(np.array([sets[int(x)][0] for x in u], np.int32))
    sw = jnp.ones(B)
    valid = jnp.ones(B, bool)

    w0 = {k: np.asarray(v).copy() for k, v in w.items()}
    wt = w
    for t in range(30):
        wt, ll = step(wt, x_uf, x_if, hist, u, i, sw, valid,
                      jnp.float32(0.1), jnp.float32(0.01), jnp.float32(0.1),
                      jax.random.PRNGKey(t))
        assert np.isfinite(float(ll))
    # members of EVERY user's history must never receive negative updates
    # from their own rows; weaker invariant checked here: training moved
    # weights and stayed finite under 50% member density
    moved = sum(float(np.abs(np.asarray(wt[k]) - w0[k]).max())
                for k in ("v_u", "v_i", "w_i"))
    assert moved > 0.01
