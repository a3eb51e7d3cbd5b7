"""Shared data generator + oracle harness for the scaled parity tests.

The dataset is drawn from a TRUE low-rank latent model (users/items get
latent vectors; each user's history is a Gumbel-top-k sample of their score
row, plus a lognormal popularity skew), so both trainers face a learnable
ML-1M-like problem (~2.4k users x 1.2k items x ~120k rows) where ranking
metrics have stable, meaningful levels — random interaction data would make
metric-level parity gates meaningless.

`oracle_metrics` reruns training from the model's exact indexed data and
seeded initial weights through the C++ sequential reference-semantics oracle
(`rankfm_tpu/native/oracle.cpp`, mirroring `_rankfm.pyx:218-336`) and scores
the same five metrics the same way `evaluation.compute` does.
"""

from __future__ import annotations

import numpy as np

from rankfm_tpu import native


def make_latent_dataset(rng, n_users=2400, n_items=1200, f_true=6,
                        per_user=50, train_frac=0.75, sharp=1.0):
    """(train, test) int64 [*, 2] arrays; ids are 0..U-1 / 0..I-1.
    ``sharp`` scales the latent logits — larger catalogs need a sharper
    preference signal for ranking metrics to sit at a learnable level."""
    zu = rng.normal(size=(n_users, f_true))
    zi = rng.normal(size=(n_items, f_true))
    pop = rng.lognormal(0.0, 1.0, n_items)
    logits = sharp * (zu @ zi.T) / np.sqrt(f_true) + np.log(pop)[None, :]
    # Gumbel top-k = sampling per_user DISTINCT items w.p. proportional to
    # softmax(logits), vectorized over users
    gumbel = -np.log(-np.log(rng.random((n_users, n_items))))
    picks = np.argsort(-(logits + gumbel), axis=1)[:, :per_user]
    users = np.repeat(np.arange(n_users), per_user)
    items = picks.reshape(-1)
    arr = np.stack([users, items], axis=1).astype(np.int64)
    mask = rng.random(len(arr)) < train_frac
    return arr[mask], arr[~mask]


def make_features(rng, train, n_uf=4, n_if=8):
    """one-hot user/item feature frames for exactly the ids present in
    ``train`` (the reference requires the feature id set to EQUAL the
    interaction id set, `rankfm.py:194-209`)"""
    import pandas as pd
    users = np.unique(train[:, 0])
    items = np.unique(train[:, 1])
    uf = np.zeros((len(users), n_uf), dtype=np.float32)
    uf[np.arange(len(users)), rng.integers(0, n_uf, len(users))] = 1.0
    itf = np.zeros((len(items), n_if), dtype=np.float32)
    itf[np.arange(len(items)), rng.integers(0, n_if, len(items))] = 1.0
    # keep the id column INTEGER (np.column_stack would upcast ids through
    # float64, colliding ids above 2^53)
    uf_df = pd.DataFrame(uf, columns=[f"uf{k}" for k in range(n_uf)])
    uf_df.insert(0, "user_id", users)
    if_df = pd.DataFrame(itf, columns=[f"if{k}" for k in range(n_if)])
    if_df.insert(0, "item_id", items)
    return uf_df, if_df


def _metrics_from_scores(scores, item_raw_ids, user_raw_ids, test, k=10):
    """THE SAME five metric aggregations as evaluation.compute (imported,
    not re-implemented — definition drift here would turn the parity gate
    into a comparison of two different metrics), from a raw score matrix
    over the training catalog"""
    from rankfm_tpu.evaluation import _AGGREGATORS

    test_sets = {}
    for u, i in test:
        test_sets.setdefault(int(u), set()).add(int(i))
    uidx = {int(u): n for n, u in enumerate(user_raw_ids)}
    rows = [(u, uidx[u]) for u in test_sets if u in uidx]
    top = np.argsort(-scores[[r[1] for r in rows]], axis=1)[:, :k]
    top_raw = item_raw_ids[top]
    comm = np.array([u for u, _ in rows])
    hits = np.array([[it in test_sets[u] for it in top_raw[n]]
                     for n, (u, _) in enumerate(rows)], dtype=bool)
    return {name: agg(comm, hits, test_sets, k)
            for name, agg in _AGGREGATORS.items()}


def oracle_metrics(model, train, test, epochs, k=10, seed=1492,
                   user_features=None, item_features=None,
                   sample_weight=None):
    """Train the C++ reference-semantics oracle from ``model``'s config on
    the SAME indexed data + seeded init, return its five metrics."""
    clone = type(model)(
        factors=model.factors, loss=model.loss, max_samples=model.max_samples,
        alpha=model.alpha, beta=model.beta, sigma=model.sigma,
        learning_rate=model.learning_rate,
        learning_schedule=model.learning_schedule,
        learning_exponent=model.learning_exponent, seed=model.seed)
    clone._init_all(train, user_features, item_features, sample_weight)
    w0 = {key: np.asarray(v) for key, v in clone._weights.items()}
    max_samples = 1 if clone.loss == "bpr" else clone.max_samples

    out = native.oracle_fit(
        clone.interactions, clone.sample_weight,
        clone._ui_offsets, clone._ui_items, clone.x_uf, clone.x_if, w0,
        clone.alpha, clone.beta, clone.learning_rate,
        clone.learning_schedule, clone.learning_exponent,
        max_samples, epochs, seed)
    assert out is not None, "native oracle unavailable"
    w, _ll = out

    # full FM scores over the training catalog (`_rankfm.pyx:48-89`):
    # bias_i + user_rep.v_i + v_u.(x_if v_if)  — NO (x_uf v_uf).(x_if v_if)
    # cross term in the reference's reduced FM
    bias = w["w_i"] + clone.x_if @ w["w_if"]
    user_rep = w["v_u"] + clone.x_uf @ w["v_uf"]
    feat_rep = clone.x_if @ w["v_if"]
    scores = bias[None, :] + user_rep @ w["v_i"].T + w["v_u"] @ feat_rep.T
    return _metrics_from_scores(
        scores, clone.item_id.values, clone.user_id.values, test, k=k)


# ---------------------------------------------------------------------------
# serving reference: the reduced FM in float64 numpy, and the score-based
# top-k comparison that predict / recommend / similar_* are held to
# ---------------------------------------------------------------------------

def reference_weights(model):
    """The model's weights and feature matrices as float64 numpy."""
    w = {k: np.asarray(v, dtype=np.float64) for k, v in model._weights.items()}
    return w, np.asarray(model.x_uf, np.float64), np.asarray(model.x_if,
                                                             np.float64)


def reference_scores(w, x_uf, x_if, users=None):
    """float64 reduced-FM utilities ``[len(users), I]`` (`_rankfm.pyx:48-89`):
    bias_i + user_rep.v_i + v_u.(x_if v_if), with no (x_uf v_uf).(x_if v_if)
    cross term."""
    users = np.arange(w["v_u"].shape[0]) if users is None else users
    bias = w["w_i"] + x_if @ w["w_if"]
    user_rep = w["v_u"][users] + x_uf[users] @ w["v_uf"]
    feat_rep = x_if @ w["v_if"]
    return bias[None, :] + user_rep @ w["v_i"].T + w["v_u"][users] @ feat_rep.T


def reference_pair_scores(w, x_uf, x_if, u, i):
    """float64 utilities of index pairs ``(u[k], i[k])``."""
    bias = w["w_i"][i] + x_if[i] @ w["w_if"]
    user_rep = w["v_u"][u] + x_uf[u] @ w["v_uf"]
    feat_rep = x_if[i] @ w["v_if"]
    return (bias + np.sum(user_rep * w["v_i"][i], axis=1)
            + np.sum(w["v_u"][u] * feat_rep, axis=1))


def reference_similarity(v, feats, v_feat, rows):
    """float64 latent-rep dot products ``[len(rows), N]`` with each query
    row's own entry set to -inf (the `similar_*` contract)."""
    reps = v + feats @ v_feat
    sims = reps[rows] @ reps.T
    sims[np.arange(len(rows)), rows] = -np.inf
    return sims


def topk_score_error(ref, got_idx, excluded=None):
    """Hold a returned top-k list to the reference by SCORE, not by id.

    ``ref [R, N]`` are reference scores, ``got_idx [R, k]`` the returned
    indices (-1 = empty slot), ``excluded [R, N]`` bool marks what must not
    come back (seen items). Returns the largest ``|ref[r, got[r, j]] -
    kth_best_ref[r, j]|`` — zero when the list holds the reference's j-th
    best score at every rank j, so near-ties between ids never count.
    Raises AssertionError when an excluded or missing slot comes back while
    the reference had an allowed item for it."""
    ref = np.array(ref, dtype=np.float64)
    if excluded is not None:
        ref[excluded] = -np.inf
    k = got_idx.shape[1]
    best = -np.sort(-ref, axis=1)[:, :k]
    rows = np.arange(ref.shape[0])[:, None]
    filled = got_idx >= 0
    assert (filled == np.isfinite(best)).all(), "empty slots disagree"
    got = np.where(filled, ref[rows, np.where(filled, got_idx, 0)], -np.inf)
    assert np.isfinite(got[filled]).all(), "an excluded item came back"
    if not filled.any():
        return 0.0
    return float(np.max(np.abs(got[filled] - best[filled])))
