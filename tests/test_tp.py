"""Explicit table-parallel (row-sharded) training path (`parallel/tp.py`):
owner-shard psum-gathers + data-axis payload all-gather must reproduce the
single-device candidate step, train on a (data, model) mesh, and never
touch the shard-padding rows."""

import numpy as np

import jax
import jax.numpy as jnp

from rankfm_tpu.ops.training import make_epoch_fn
from rankfm_tpu.parallel import tp
from rankfm_tpu.parallel.mesh import make_mesh


def _fixture(rng, U=60, I=90, F=8, n=2000):
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    uniq = np.unique(np.stack([u, i], 1), axis=0)
    counts = np.bincount(uniq[:, 0], minlength=U)
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    flat = uniq[:, 1].astype(np.int32)
    w = {
        "w_i": np.zeros(I, np.float32),
        "w_if": np.zeros(2, np.float32),
        "v_u": rng.normal(0, 0.01, (U, F)).astype(np.float32),
        "v_i": rng.normal(0, 0.01, (I, F)).astype(np.float32),
        "v_uf": np.zeros((1, F), np.float32),
        "v_if": np.zeros((2, F), np.float32),
    }
    x_uf = np.zeros((U, 1), np.float32)
    x_if = np.zeros((I, 2), np.float32)
    hist = {"offsets": jnp.asarray(offsets), "flat": jnp.asarray(flat),
            "bitmap": jnp.zeros((1, 1), jnp.uint32)}
    return u, i, w, x_uf, x_if, hist, int(counts.max())


def _padded(u, i, n, bs):
    n_pad = -(-n // bs) * bs
    up = np.zeros(n_pad, np.int32)
    ip = np.zeros(n_pad, np.int32)
    swp = np.zeros(n_pad, np.float32)
    up[:n] = u
    ip[:n] = i
    swp[:n] = 1.0
    return jnp.asarray(up), jnp.asarray(ip), jnp.asarray(swp)


def test_tp_epoch_matches_single_device_candidate_epoch():
    """data=1, model=8: the candidate stream is identical to the
    single-device step (no data fold), so the whole epoch must agree."""
    rng = np.random.default_rng(0)
    U, I, n, bs = 60, 90, 2000, 256
    u, i, w, x_uf, x_if, hist, mrl = _fixture(rng, U=U, I=I, n=n)
    up, ip, swp = _padded(u, i, n, bs)
    args = (up, ip, swp, n, 0.1, 0.01, 0.1, jax.random.PRNGKey(5), 0)

    ref_fn = make_epoch_fn(I, 4, False, False, bs, sample_rounds=8,
                           donate=False, sampler="bsearch",
                           step_kind="candidate", max_row_len=mrl)
    w_ref, ll_ref = ref_fn({k: jnp.asarray(v) for k, v in w.items()},
                           jnp.asarray(x_uf), jnp.asarray(x_if), hist, *args)

    mesh = make_mesh(data=1, model=8)
    w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    fn = tp.tp_epoch_fn(mesh, I, 4, False, False, bs, sample_rounds=8,
                        max_row_len=mrl)
    w_out, ll_out = fn(w_tp, xu_tp, xi_tp, hist, *args)
    w_got = tp.extract(w_out, U, I)

    np.testing.assert_allclose(float(ll_out), float(ll_ref), rtol=2e-2)
    for k in ("v_u", "v_i", "w_i"):
        np.testing.assert_allclose(np.asarray(w_got[k]),
                                   np.asarray(w_ref[k]),
                                   atol=2e-3, rtol=2e-2, err_msg=k)


def test_tp_window_epoch_matches_single_device_window_epoch():
    """data=1, model=8, step_kind='window' (round 3): same PRNG streams as
    the single-device window step, so the whole epoch must agree — giant-
    table meshes no longer pay candidate-step cost on window-sized
    catalogs."""
    from rankfm_tpu.ops import window

    rng = np.random.default_rng(3)
    U, I, n, bs = 60, 90, 2000, 256
    u, i, w, x_uf, x_if, hist, mrl = _fixture(rng, U=U, I=I, n=n)
    up, ip, swp = _padded(u, i, n, bs)
    args = (up, ip, swp, n, 0.1, 0.01, 0.1, jax.random.PRNGKey(5), 0)
    packed = window.pack_history_device(
        np.asarray(hist["offsets"]), np.asarray(hist["flat"]), U, I)

    ref_fn = make_epoch_fn(I, 4, False, False, bs, donate=False,
                           step_kind="window")
    w_ref, ll_ref = ref_fn({k: jnp.asarray(v) for k, v in w.items()},
                           jnp.asarray(x_uf), jnp.asarray(x_if), packed,
                           *args)

    mesh = make_mesh(data=1, model=8)
    w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    hist_tp = {"packed": tp.pad_packed_hist(mesh, packed, U)}
    fn = tp.tp_epoch_fn(mesh, I, 4, False, False, bs, step_kind="window")
    w_out, ll_out = fn(w_tp, xu_tp, xi_tp, hist_tp, *args)
    w_got = tp.extract(w_out, U, I)

    np.testing.assert_allclose(float(ll_out), float(ll_ref), rtol=2e-2)
    for k in ("v_u", "v_i", "w_i"):
        np.testing.assert_allclose(np.asarray(w_got[k]),
                                   np.asarray(w_ref[k]),
                                   atol=2e-3, rtol=2e-2, err_msg=k)


def test_tp_window_epoch_trains_on_data_model_mesh():
    """data=2, model=4, step_kind='window': multi-axis TP window training
    improves the log-likelihood and never writes shard-padding rows."""
    from rankfm_tpu.ops import window

    rng = np.random.default_rng(8)
    U, I, n, bs = 60, 90, 2000, 256
    u, i, w, x_uf, x_if, hist, mrl = _fixture(rng, U=U, I=I, n=n)
    up, ip, swp = _padded(u, i, n, bs)
    packed = window.pack_history_device(
        np.asarray(hist["offsets"]), np.asarray(hist["flat"]), U, I)

    mesh = make_mesh(data=2, model=4)
    w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    hist_tp = {"packed": tp.pad_packed_hist(mesh, packed, U)}
    fn = tp.tp_epoch_fn(mesh, I, 4, False, False, bs, step_kind="window")
    lls = []
    for ep in range(6):
        w_tp, ll = fn(w_tp, xu_tp, xi_tp, hist_tp, up, ip, swp, n,
                      0.1, 0.01, 0.1, jax.random.PRNGKey(5), ep)
        lls.append(float(ll))
    assert all(np.isfinite(v) for v in lls), lls
    assert max(lls[3:]) > lls[0], lls
    if w_tp["v_i"].shape[0] > I:
        assert float(jnp.abs(w_tp["v_i"][I:]).max()) == 0.0
    w_got = tp.extract(w_tp, U, I)
    assert not np.allclose(np.asarray(w_got["v_u"]), w["v_u"])


def test_tp_window_sharded_selection_branch():
    """batch large enough that the window-group count divides the model
    axis (G=8, model=2): the SHARDED-selection branch (per-shard groups +
    all_gather of the per-row outcomes) must train, improve ll, and leave
    shard-padding rows untouched. (The exact-parity test above runs the
    replicated branch — split selection uses per-shard PRNG folds, so its
    draws legitimately differ from the single-device stream.)"""
    from rankfm_tpu.ops import window
    from rankfm_tpu.ops.training import pick_window_groups

    rng = np.random.default_rng(11)
    U, I, n, bs = 300, 600, 8000, 2048
    u, i, w, x_uf, x_if, hist, mrl = _fixture(rng, U=U, I=I, n=n)
    up, ip, swp = _padded(u, i, n, bs)
    packed = window.pack_history_device(
        np.asarray(hist["offsets"]), np.asarray(hist["flat"]), U, I)

    mesh = make_mesh(data=4, model=2)
    B_dev = bs // mesh.shape["data"]
    G = pick_window_groups(B_dev)
    assert G % mesh.shape["model"] == 0 and G > 1  # the branch under test

    w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    hist_tp = {"packed": tp.pad_packed_hist(mesh, packed, U)}
    fn = tp.tp_epoch_fn(mesh, I, 4, False, False, bs, step_kind="window")
    lls = []
    for ep in range(6):
        w_tp, ll = fn(w_tp, xu_tp, xi_tp, hist_tp, up, ip, swp, n,
                      0.1, 0.01, 0.1, jax.random.PRNGKey(5), ep)
        lls.append(float(ll))
    assert all(np.isfinite(v) for v in lls), lls
    assert max(lls[3:]) > lls[0], lls
    if w_tp["v_i"].shape[0] > I:
        assert float(jnp.abs(w_tp["v_i"][I:]).max()) == 0.0
    if w_tp["v_u"].shape[0] > U:
        assert float(jnp.abs(w_tp["v_u"][U:]).max()) == 0.0


def test_model_auto_routes_tp_window_for_giant_tables(monkeypatch):
    """train_step='auto', a 3-8-block catalog, and tables past the DP
    budget must take the TP WINDOW path (round 3), not the candidate
    fallback."""
    import pandas as pd

    import rankfm_tpu.parallel.train as ptrain
    from rankfm_tpu import RankFM

    monkeypatch.setattr(ptrain, "DP_TABLE_BYTES", 0)
    calls = []
    real = tp.tp_epoch_fn

    def spy(*a, **k):
        calls.append(k.get("step_kind", "candidate"))
        return real(*a, **k)

    monkeypatch.setattr(tp, "tp_epoch_fn", spy)
    rng = np.random.default_rng(9)
    # ~5800 observed items -> block_size 1024 -> 6 window blocks (3..8 band)
    df = pd.DataFrame({"u": rng.integers(0, 50, 20000),
                       "i": rng.integers(0, 6000, 20000)})
    mesh = make_mesh(data=2, model=4)
    m = RankFM(factors=8, loss="warp", max_samples=4, batch_size=128,
               mesh=mesh)
    m.fit(df, epochs=2)
    assert m.is_fit and np.isfinite(m.v_i).all()
    assert calls and calls[0] == "window", calls


def test_tp_epoch_trains_on_data_model_mesh():
    """data=2, model=4: multi-axis TP (payload all-gather over data) trains
    and never writes the shard-padding rows."""
    rng = np.random.default_rng(1)
    U, I, n, bs = 60, 90, 2000, 256
    u, i, w, x_uf, x_if, hist, mrl = _fixture(rng, U=U, I=I, n=n)
    up, ip, swp = _padded(u, i, n, bs)

    mesh = make_mesh(data=2, model=4)
    w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    fn = tp.tp_epoch_fn(mesh, I, 4, False, False, bs, max_row_len=mrl)
    lls = []
    for ep in range(6):
        w_tp, ll = fn(w_tp, xu_tp, xi_tp, hist, up, ip, swp, n,
                      0.1, 0.01, 0.1, jax.random.PRNGKey(5), ep)
        lls.append(float(ll))
    assert all(np.isfinite(v) for v in lls), lls
    assert max(lls[3:]) > lls[0], lls
    U_padm = w_tp["v_u"].shape[0]
    I_padm = w_tp["v_i"].shape[0]
    if U_padm > U:
        assert float(jnp.abs(w_tp["v_u"][U:]).max()) == 0.0
    if I_padm > I:
        assert float(jnp.abs(w_tp["v_i"][I:]).max()) == 0.0
        assert float(jnp.abs(w_tp["w_i"][I:]).max()) == 0.0
    w_got = tp.extract(w_tp, U, I)
    assert not np.allclose(np.asarray(w_got["v_u"]), w["v_u"])


def test_tp_epoch_with_features_and_weights():
    """Side features + sample weights through the TP step: feature tables
    move, dense grads psum over data, everything finite."""
    rng = np.random.default_rng(2)
    U, I, F, n, bs = 50, 70, 8, 1500, 256
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    uniq = np.unique(np.stack([u, i], 1), axis=0)
    counts = np.bincount(uniq[:, 0], minlength=U)
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    w = {
        "w_i": np.zeros(I, np.float32),
        "w_if": np.zeros(3, np.float32),
        "v_u": rng.normal(0, 0.05, (U, F)).astype(np.float32),
        "v_i": rng.normal(0, 0.05, (I, F)).astype(np.float32),
        "v_uf": rng.normal(0, 0.01, (2, F)).astype(np.float32),
        "v_if": rng.normal(0, 0.01, (3, F)).astype(np.float32),
    }
    x_uf = rng.normal(0, 1, (U, 2)).astype(np.float32)
    x_if = rng.normal(0, 1, (I, 3)).astype(np.float32)
    hist = {"offsets": jnp.asarray(offsets),
            "flat": jnp.asarray(uniq[:, 1].astype(np.int32)),
            "bitmap": jnp.zeros((1, 1), jnp.uint32)}
    n_pad = -(-n // bs) * bs
    up = np.zeros(n_pad, np.int32)
    ip = np.zeros(n_pad, np.int32)
    swp = np.zeros(n_pad, np.float32)
    up[:n] = u
    ip[:n] = i
    swp[:n] = rng.uniform(0.5, 2.0, n).astype(np.float32)

    mesh = make_mesh(data=2, model=4)
    w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    fn = tp.tp_epoch_fn(mesh, I, 4, True, True, bs,
                        max_row_len=int(counts.max()))
    for ep in range(3):
        w_tp, ll = fn(w_tp, xu_tp, xi_tp, hist, jnp.asarray(up),
                      jnp.asarray(ip), jnp.asarray(swp), n,
                      0.1, 0.01, 0.1, jax.random.PRNGKey(9), ep)
        assert np.isfinite(float(ll))
    w_got = tp.extract(w_tp, U, I)
    for k, v in w_got.items():
        assert np.isfinite(np.asarray(v)).all(), k
    assert not np.allclose(np.asarray(w_got["v_if"]), w["v_if"])
    assert not np.allclose(np.asarray(w_got["v_uf"]), w["v_uf"])


def test_model_routes_to_tp_when_tables_exceed_dp_budget(monkeypatch):
    """RankFM(mesh=..., train_step='candidate') with a weight pytree past
    the DP replication budget must take the explicit TP path end-to-end
    (fit → recommend → evaluation) and learn planted structure."""
    import pandas as pd

    import rankfm_tpu.parallel.train as ptrain
    from rankfm_tpu import RankFM
    from rankfm_tpu.evaluation import hit_rate

    monkeypatch.setattr(ptrain, "DP_TABLE_BYTES", 0)

    rng = np.random.default_rng(4)
    n_users, n_items = 80, 60
    rows = []
    for uu in range(n_users):
        grp = uu % 2
        pool = np.arange(grp * n_items // 2, (grp + 1) * n_items // 2)
        rows.append(np.stack(
            [np.full(12, uu), rng.choice(pool, 12, replace=False)], 1))
    df = pd.DataFrame(np.concatenate(rows), columns=["u", "i"])
    train = df.sample(frac=0.75, random_state=0)
    test = df.drop(train.index)

    mesh = make_mesh(data=2, model=4)
    m = RankFM(factors=8, loss="warp", max_samples=8, learning_rate=0.1,
               batch_size=256, mesh=mesh, train_step="candidate")
    m.fit(train, epochs=12)
    assert m.is_fit and np.isfinite(m.v_i).all() and np.isfinite(m.v_u).all()
    hr = hit_rate(m, test, k=8)
    assert hr > 0.4, hr
    # warm-start continues from TP-trained state
    m.fit_partial(train, epochs=1)
    assert np.isfinite(m.v_i).all()


def test_auto_step_prefers_tp_for_giant_tables_small_catalog(monkeypatch):
    """train_step='auto' with a small catalog resolves 'window' — but when
    the tables exceed the DP budget on a mesh, it must switch to the TP
    candidate path instead of the GSPMD window lowering."""
    import pandas as pd

    import rankfm_tpu.parallel.train as ptrain
    from rankfm_tpu import RankFM

    monkeypatch.setattr(ptrain, "DP_TABLE_BYTES", 0)
    calls = []
    real = tp.tp_epoch_fn

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(tp, "tp_epoch_fn", spy)
    rng = np.random.default_rng(6)
    df = pd.DataFrame({"u": rng.integers(0, 40, 600),
                       "i": rng.integers(0, 50, 600)})
    mesh = make_mesh(data=2, model=4)
    m = RankFM(factors=8, loss="warp", max_samples=4, batch_size=128,
               mesh=mesh)  # train_step='auto', catalog far below 8 blocks
    m.fit(df, epochs=2)
    assert m.is_fit and np.isfinite(m.v_i).all()
    assert calls, "auto routing did not take the TP path"
