"""Metric-level learning parity: the batched trainer must reach the same
ranking quality as the reference's sequential per-sample SGD.

Since the Cython reference can't run here, its training loop is implemented
twice as independent oracles from the documented semantics (SURVEY.md §2.4 /
`_rankfm.pyx:218-336`):

* a tiny pure-numpy oracle (below) — readable executable spec, and
* the C++ oracle (`rankfm_tpu/native/oracle.cpp`) — fast enough to train
  ML-1M-like configs (2.4k users x 1.2k items x ~120k rows, 10 epochs) so
  parity is checked AT SCALE, with features, sample weights, and both loss
  flavors, across all five ranking metrics.

Parity gates: |build - oracle| <= 0.02 absolute on every metric for the
candidate step (reference-exact sampling); the window step keeps +-0.02 on
precision/recall and +-0.06 on the rank-sensitive metrics. The scaled gates
are ``gpu``-marked: on the XLA CPU backend one config takes minutes.
"""

import numpy as np
import pytest

from rankfm_tpu import RankFM, evaluation, native
from parity_common import make_latent_dataset, make_features, oracle_metrics

METRICS = ("hit_rate", "reciprocal_rank", "discounted_cumulative_gain",
           "precision", "recall")
# reference-exact sampling (candidate step): every metric within +-0.02
TIGHT = {m: 0.02 for m in METRICS}
# window step (windowed negatives): precision/recall at parity, a wider band
# on the rank-sensitive metrics for the windowed-negative gap
WINDOW = {"hit_rate": 0.06, "reciprocal_rank": 0.06,
          "discounted_cumulative_gain": 0.06, "precision": 0.02,
          "recall": 0.02}


def _require_oracle():
    """Body-level skip: evaluating native.get_oracle() in a skipif decorator
    would spawn the g++ compile (and jax.devices() the backend init) at
    COLLECTION time, even for deselected runs."""
    if native.get_oracle() is None:
        pytest.skip("no C++ toolchain")




def _make_data(rng, n_users=120, n_items=60, n_groups=3, per_user=12):
    rows = []
    for u in range(n_users):
        g = u % n_groups
        size = n_items // n_groups
        own = rng.choice(np.arange(g * size, (g + 1) * size), per_user, replace=False)
        for it in own:
            rows.append((u, it))
    arr = np.array(rows, dtype=np.int64)
    mask = rng.random(len(arr)) < 0.75
    return arr[mask], arr[~mask]


def _sequential_oracle_fit(train, n_users, n_items, factors, epochs, lr, rng,
                           max_samples=5, alpha=0.01):
    """numpy reimplementation of the reference's per-sample SGD (no features)"""
    v_u = rng.normal(0, 0.1, (n_users, factors)).astype(np.float32)
    v_i = rng.normal(0, 0.1, (n_items, factors)).astype(np.float32)
    w_i = np.zeros(n_items, dtype=np.float32)
    user_items = {u: set(train[train[:, 0] == u][:, 1]) for u in range(n_users)}
    log_I = np.log(n_items)

    for epoch in range(epochs):
        eta = lr / (epoch + 1) ** 0.25
        order = rng.permutation(len(train))
        for r in order:
            u, i = train[r]
            ut_ui = w_i[i] + v_u[u] @ v_i[i]
            min_j, min_pu = -1, 1e6
            sampled = max_samples
            for s in range(1, max_samples + 1):
                while True:
                    j = rng.integers(0, n_items)
                    if j not in user_items[u]:
                        break
                ut_uj = w_i[j] + v_u[u] @ v_i[j]
                pu = ut_ui - ut_uj
                if pu < min_pu:
                    min_j, min_pu = j, pu
                if pu < 1.0:
                    sampled = s
                    break
            j, pu = min_j, min_pu
            mult = np.log(max((n_items - 1) // sampled, 1)) / log_I
            d = mult / (np.exp(pu) + 1.0)
            ra = 2 * alpha
            w_i[i] += eta * (d - ra * w_i[i])
            w_i[j] += eta * (-d - ra * w_i[j])
            gu = d * (v_i[i] - v_i[j])
            gi = d * v_u[u]
            v_u[u] += eta * (gu - ra * v_u[u])
            v_i[i] += eta * (gi - ra * v_i[i])
            v_i[j] += eta * (-gi - ra * v_i[j])
    return w_i, v_u, v_i


def _oracle_hit_rate(w_i, v_u, v_i, train, test, k=10):
    scores = w_i[None, :] + v_u @ v_i.T
    hits = []
    test_sets = {}
    for u, i in test:
        test_sets.setdefault(u, set()).add(i)
    for u, items in test_sets.items():
        top = np.argsort(-scores[u])[:k]
        hits.append(int(len(set(top) & items) > 0))
    return float(np.mean(hits))


@pytest.mark.slow
def test_batched_trainer_matches_sequential_oracle_quality():
    _require_oracle()
    rng = np.random.default_rng(42)
    train, test = _make_data(rng)
    n_users, n_items = 120, 60
    epochs, factors = 15, 8

    # sequential oracle (reference semantics)
    w_i, v_u, v_i = _sequential_oracle_fit(
        train, n_users, n_items, factors, epochs, lr=0.1,
        rng=np.random.default_rng(7))
    hr_oracle = _oracle_hit_rate(w_i, v_u, v_i, train, test)

    # batched trainer through the public API
    model = RankFM(factors=factors, loss='warp', max_samples=5,
                   learning_rate=0.1, learning_schedule='invscaling',
                   batch_size=256)
    model.fit(train, epochs=epochs)
    hr_batched = evaluation.hit_rate(model, test, k=10)

    # both must beat popularity and be within variance of each other
    assert hr_oracle > 0.3, hr_oracle
    assert hr_batched > hr_oracle - 0.1, (hr_batched, hr_oracle)


def test_cpp_oracle_matches_numpy_oracle():
    """the two independent oracle implementations agree at the metric level"""
    _require_oracle()
    rng = np.random.default_rng(42)
    train, test = _make_data(rng)
    n_users, n_items = 120, 60
    epochs, factors = 15, 8

    w_i, v_u, v_i = _sequential_oracle_fit(
        train, n_users, n_items, factors, epochs, lr=0.1,
        rng=np.random.default_rng(7))
    hr_np = _oracle_hit_rate(w_i, v_u, v_i, train, test)

    model = RankFM(factors=factors, loss='warp', max_samples=5,
                   learning_rate=0.1, learning_schedule='invscaling')
    m = oracle_metrics(model, train, test, epochs=epochs)
    assert abs(m["hit_rate"] - hr_np) < 0.12, (m["hit_rate"], hr_np)
    assert m["hit_rate"] > 0.3


@pytest.mark.slow
@pytest.mark.gpu
@pytest.mark.parametrize("loss,max_samples,features,weights,step,gates", [
    # reference-exact candidate sampling: tight +-0.02 on every metric
    ("warp", 10, False, True, "candidate", TIGHT),   # ML-1M headline shape
    ("warp", 10, True, False, "candidate", TIGHT),   # side features
    ("bpr", 10, False, False, "candidate", TIGHT),
])
def test_scaled_parity_vs_cpp_oracle(loss, max_samples, features, weights,
                                     step, gates):
    """ML-1M-like scale: metric parity vs the sequential reference-semantics
    oracle at identical config/epochs"""
    _require_oracle()
    rng = np.random.default_rng(11)
    train, test = make_latent_dataset(rng)
    uf, itf = make_features(rng, train) if features else (None, None)
    sw = (rng.integers(1, 4, len(train)).astype(np.float32)
          if weights else None)

    model = RankFM(factors=16, loss=loss, max_samples=max_samples,
                   alpha=0.01, beta=0.1, sigma=0.1, learning_rate=0.1,
                   learning_schedule='invscaling', seed=1492,
                   train_step=step)
    model.fit(train, user_features=uf, item_features=itf,
              sample_weight=sw, epochs=10)
    build = evaluation.compute(model, test, k=10)

    oracle = oracle_metrics(model, train, test, epochs=10,
                            user_features=uf, item_features=itf,
                            sample_weight=sw)
    # sanity: the problem is learnable (well above the ~0.2 popularity level)
    assert oracle["hit_rate"] > 0.45, oracle
    deltas = {k: round(build[k] - oracle[k], 4) for k in METRICS}
    for m in METRICS:
        assert abs(build[m] - oracle[m]) <= gates[m], (m, deltas)


@pytest.mark.slow
@pytest.mark.gpu
def test_full_ml1m_scale_parity_headline_config():
    """FULL ML-1M scale (6,040 users x 3,706 items x ~750k rows) at the
    reference's exact headline configuration (README.md:110 /
    movielens.ipynb cells 30-32: f=20, WARP ms=20, alpha=0.01, lr=0.1,
    invscaling, 20 epochs). The window step (auto at 4 window blocks) must
    match the sequential reference-semantics oracle within the WINDOW
    bands (chip_smoke.py phase 2 runs the same gate)."""
    _require_oracle()
    rng = np.random.default_rng(1492)
    # ~748k train rows; sharp=1.2 puts the oracle's metric levels right at
    # the real-ML-1M reference band (oracle: HR 0.84 / MRR 0.376 /
    # DCG 0.797 / P 0.169 vs README.md:110's 0.796/0.339/0.734/0.159)
    train, test = make_latent_dataset(rng, n_users=6040, n_items=3706,
                                      per_user=165, sharp=1.2)
    model = RankFM(factors=20, loss="warp", max_samples=20, alpha=0.01,
                   sigma=0.1, learning_rate=0.1,
                   learning_schedule="invscaling", seed=1492)
    model.fit(train, epochs=20)
    assert model.last_fit_plan_.step_kind == "window"
    build = evaluation.compute(model, test, k=10)
    oracle = oracle_metrics(model, train, test, epochs=20)
    assert 0.75 < oracle["hit_rate"] < 0.95, oracle
    deltas = {k: round(build[k] - oracle[k], 4) for k in METRICS}
    for m in METRICS:
        assert abs(build[m] - oracle[m]) <= WINDOW[m], (m, deltas)
