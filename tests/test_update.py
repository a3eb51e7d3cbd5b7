"""The table update of both training steps (`ops/training._apply_pair_updates`,
``.at[].add`` scatter-adds plus the geometric per-touch decay) against a
float64 numpy oracle that applies each row's touches one at a time.

A row of a row table (``w_i``, ``v_i``, ``v_u``) touched k times in a
batch, with decay factor ``c = 1 - 2*eta*reg`` and summed gradient ``G``,
must end where k sequential reference updates ``w <- c*w + eta*G/k`` leave
it (`_rankfm.pyx:272-326` under exchangeable within-batch gradients). The
dense feature tables (``w_if``, ``v_uf``, ``v_if``) must end where the
reference's recursion ``w <- c*w + eta*g_t`` leaves them, each touch with
its own gradient, in the batch's row order. Duplicate user and item
indices inside a batch are the point of the test: every scatter-add must
accumulate, not overwrite. The table-parallel update
(`parallel/tp._tp_apply_updates`) must do the same with the batch split
over data shards."""

import numpy as np
import pytest

import jax.numpy as jnp

from rankfm_tpu.ops.training import _apply_pair_updates

ETA, ALPHA, BETA = 0.05, 0.01, 0.1


def _per_touch(w, grad, count, reg):
    """apply ``count`` touches of the averaged gradient, one at a time"""
    c = max(1.0 - ETA * 2.0 * reg, 1e-8)
    out = np.array(w, dtype=np.float64)
    for r in np.ndindex(count.shape):
        k = int(round(count[r]))
        for _ in range(k):
            out[r] = c * out[r] + ETA * grad[r] / k
    return out


def _oracle(w, u, i, j, d, ok, x_uf, x_if, x_uf_any, x_if_any):
    w = {k: np.asarray(v, np.float64) for k, v in w.items()}
    x_uf, x_if = np.asarray(x_uf, np.float64), np.asarray(x_if, np.float64)
    U, F = w["v_u"].shape
    I = w["v_i"].shape[0]
    user_rep = w["v_u"] + x_uf @ w["v_uf"]
    feat_rep = x_if @ w["v_if"]
    g = {k: np.zeros_like(v) for k, v in w.items()}
    k_i, k_u = np.zeros(I), np.zeros(U)
    c = 1.0 - ETA * 2.0 * BETA
    feat = {k: w[k].copy() for k in ("w_if", "v_uf", "v_if")}
    for b in range(len(u)):
        ub, ib, jb, db = u[b], i[b], j[b], d[b]
        g["w_i"][ib] += db
        g["w_i"][jb] -= db
        g["v_i"][ib] += db * user_rep[ub]
        g["v_i"][jb] -= db * user_rep[ub]
        g["v_u"][ub] += db * ((w["v_i"][ib] - w["v_i"][jb])
                              + (feat_rep[ib] - feat_rep[jb]))
        k_i[ib] += ok[b]
        k_i[jb] += ok[b]
        k_u[ub] += ok[b]
        if not ok[b]:
            continue
        # feature tables: this touch's own gradient, in row order
        dx = x_if[ib] - x_if[jb]
        if x_if_any:
            feat["w_if"] = c * feat["w_if"] + ETA * db * dx
            t = dx != 0
            feat["v_if"][t] = (c * feat["v_if"][t]
                               + ETA * db * np.outer(dx[t], w["v_u"][ub]))
        if x_uf_any:
            t = x_uf[ub] != 0
            feat["v_uf"][t] = (c * feat["v_uf"][t] + ETA * db * np.outer(
                x_uf[ub][t], w["v_i"][ib] - w["v_i"][jb]))
    rows = lambda k, v: np.broadcast_to(k[:, None], v.shape)  # noqa: E731
    return {
        "w_i": _per_touch(w["w_i"], g["w_i"], k_i, ALPHA),
        "v_i": _per_touch(w["v_i"], g["v_i"], rows(k_i, w["v_i"]), ALPHA),
        "v_u": _per_touch(w["v_u"], g["v_u"], rows(k_u, w["v_u"]), ALPHA),
        **feat,
    }


def _batch(F, features):
    rng = np.random.default_rng(F + features)
    U, I, B, P, Q = 9, 13, 96, 3, 4       # B >> U, I: heavy duplication
    w = {
        "w_i": rng.normal(0, 0.1, I), "w_if": rng.normal(0, 0.1, Q),
        "v_u": rng.normal(0, 0.1, (U, F)), "v_i": rng.normal(0, 0.1, (I, F)),
        "v_uf": rng.normal(0, 0.1, (P, F)), "v_if": rng.normal(0, 0.1, (Q, F)),
    }
    w = {k: v.astype(np.float32) for k, v in w.items()}
    if features:
        x_uf = (rng.random((U, P)) < 0.5).astype(np.float32)
        x_if = (rng.random((I, Q)) < 0.5).astype(np.float32)
    else:
        x_uf, x_if = np.zeros((U, P), np.float32), np.zeros((I, Q), np.float32)
    u = rng.integers(0, U, B)
    i = rng.integers(0, I, B)
    j = (i + rng.integers(1, I, B)) % I          # a negative != positive
    ok = (rng.random(B) < 0.8).astype(np.float32)
    d = (ok * rng.uniform(0.1, 1.0, B)).astype(np.float32)
    assert len(np.unique(u)) < B and len(np.unique(i)) < B
    want = _oracle(w, u, i, j, d, ok, x_uf, x_if, features, features)
    return w, x_uf, x_if, u, i, j, d, ok, want


def _pair_rows(wj, xu, xi, u, i, j):
    """the per-row operands both update paths take, from the full tables"""
    v_u_b = wj["v_u"][u]
    return (v_u_b, v_u_b + xu[u] @ wj["v_uf"], xu[u], wj["v_i"][i],
            wj["v_i"][j], xi[i], xi[j], xi[i] @ wj["v_if"],
            xi[j] @ wj["v_if"])


def _assert_matches(got, want):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("features", [False, True],
                         ids=["featureless", "features"])
@pytest.mark.parametrize("F", [20, 50, 128])
def test_update_matches_per_touch_oracle(F, features):
    w, x_uf, x_if, u, i, j, d, ok, want = _batch(F, features)
    wj = {k: jnp.asarray(v) for k, v in w.items()}
    xu, xi = jnp.asarray(x_uf), jnp.asarray(x_if)
    uj, ij, jj = (jnp.asarray(a, jnp.int32) for a in (u, i, j))
    (v_u_b, user_rep_b, x_uf_b, v_i_pos, v_i_j, x_if_pos, x_if_j,
     feat_pos, feat_j) = _pair_rows(wj, xu, xi, uj, ij, jj)
    got = _apply_pair_updates(
        wj, uj, ij, jj, jnp.asarray(d), jnp.asarray(ok), v_u_b, user_rep_b,
        x_uf_b, v_i_pos, v_i_j, x_if_pos, x_if_j, feat_pos, feat_j,
        ETA, ALPHA, BETA, features, features)
    _assert_matches(got, want)


@pytest.mark.parametrize("features", [False, True],
                         ids=["featureless", "features"])
def test_tp_update_matches_per_touch_oracle_over_data_shards(features):
    """(data=2, model=4): each data shard holds half the batch rows and
    every model shard owns a quarter of the table rows; the feature
    tables' touch order runs over the whole batch, shard 0's rows first"""
    import jax
    from jax.sharding import PartitionSpec as P

    from rankfm_tpu.parallel import tp
    from rankfm_tpu.parallel.mesh import make_mesh

    w, x_uf, x_if, u, i, j, d, ok, want = _batch(20, features)
    U, I = w["v_u"].shape[0], w["v_i"].shape[0]
    mesh = make_mesh(data=2, model=4)
    D = mesh.shape["data"]
    w_tp, _, _ = tp.pad_and_place(mesh, w, x_uf, x_if)
    wj = {k: jnp.asarray(v) for k, v in w.items()}
    xu, xi = jnp.asarray(x_uf), jnp.asarray(x_if)
    uj, ij, jj = (jnp.asarray(a, jnp.int32) for a in (u, i, j))
    rows = _pair_rows(wj, xu, xi, uj, ij, jj)

    def body(w_s, u, i, j, d, ok, *rows):
        m_idx = jax.lax.axis_index("model")
        return tp._tp_apply_updates(
            w_s, m_idx, D, features, features, u, i, j, d, ok, *rows,
            ETA, ALPHA, BETA)

    row, mat, bsh, rep = P("model"), P("model", None), P("data"), P()
    w_specs = {"w_i": row, "v_i": mat, "v_u": mat,
               "w_if": rep, "v_uf": rep, "v_if": rep}
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(w_specs,) + (bsh,) * 14,
        out_specs=w_specs, check_vma=False))
    got = fn(w_tp, uj, ij, jj, jnp.asarray(d), jnp.asarray(ok), *rows)
    _assert_matches(tp.extract(got, U, I), want)
