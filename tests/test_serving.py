"""Serving against the float64 reference FM: `predict`, `recommend` and
`similar_*` of a fitted model must return the scores (and the top-k lists,
compared by score) that the reduced FM of `parity_common.reference_scores`
gives for the model's own weights. `chip_smoke.py` holds the card to the
same comparison at the ML-1M and Instacart shapes."""

import numpy as np
import pandas as pd
import pytest

from rankfm_tpu import RankFM
from parity_common import (
    make_latent_dataset, reference_pair_scores, reference_scores,
    reference_similarity, reference_weights, topk_score_error)

TOL = 1e-4   # f32 serving vs float64 reference, |scores| of order 1


def _raw_to_index(index_map, raw):
    return index_map.reindex(raw).to_numpy(dtype=np.float64)


@pytest.fixture(scope="module", params=[False, True],
                ids=["featureless", "features"])
def fitted(request):
    rng = np.random.default_rng(21)
    train, test = make_latent_dataset(rng, n_users=60, n_items=200,
                                      per_user=20)
    uf = itf = None
    if request.param:
        users, items = np.unique(train[:, 0]), np.unique(train[:, 1])
        uf = pd.DataFrame(rng.normal(size=(len(users), 3)).astype(np.float32))
        uf.insert(0, "user_id", users)
        itf = pd.DataFrame((rng.random((len(items), 4)) < 0.3)
                           .astype(np.float32))
        itf.insert(0, "item_id", items)
    model = RankFM(factors=8, loss="warp", max_samples=5, seed=3,
                   learning_schedule="invscaling")
    model.fit(train, user_features=uf, item_features=itf, epochs=3)
    return model, train, test


@pytest.mark.parametrize("api", ["predict", "recommend",
                                 "recommend_filtered", "similar_items",
                                 "similar_users"])
def test_serving_matches_float64_reference(fitted, api):
    model, train, test = fitted
    w, x_uf, x_if = reference_weights(model)
    if api == "predict":
        pairs = np.concatenate([test, [[10_000, 1], [2, 10_000]]])
        got = model.predict(pairs)
        u = _raw_to_index(model.user_to_index, pairs[:, 0])
        i = _raw_to_index(model.item_to_index, pairs[:, 1])
        known = ~(np.isnan(u) | np.isnan(i))
        assert np.isnan(got[~known]).all() and (~known)[-2:].all()
        ref = reference_pair_scores(w, x_uf, x_if, u[known].astype(int),
                                    i[known].astype(int))
        assert np.max(np.abs(got[known] - ref)) < TOL
    elif api.startswith("recommend"):
        flt = api == "recommend_filtered"
        users = model.user_id.values
        recs = model.recommend(users, n_items=10, filter_previous=flt)
        got = _raw_to_index(model.item_to_index, recs.to_numpy().ravel())
        got = np.where(np.isnan(got), -1, got).astype(int).reshape(recs.shape)
        excluded = None
        if flt:
            excluded = np.zeros((len(users), len(model.item_id)), bool)
            excluded[_raw_to_index(model.user_to_index, train[:, 0]).astype(int),
                     _raw_to_index(model.item_to_index, train[:, 1]).astype(int)] = True
        ref = reference_scores(w, x_uf, x_if)
        assert topk_score_error(ref, got, excluded) < TOL
    else:
        items = api == "similar_items"
        index_map = model.item_to_index if items else model.user_to_index
        ids = (model.item_id if items else model.user_id).values[:10]
        rows = _raw_to_index(index_map, ids).astype(int)
        v, feats, vf = ((w["v_i"], x_if, w["v_if"]) if items
                        else (w["v_u"], x_uf, w["v_uf"]))
        sim = getattr(model, api)
        got = np.stack([_raw_to_index(index_map, sim(x, 5)) for x in ids])
        ref = reference_similarity(v, feats, vf, rows)
        assert topk_score_error(ref, got.astype(int)) < TOL


def test_topk_score_error_ignores_near_ties_but_not_wrong_items():
    ref = np.array([[3.0, 2.0, 2.0, 1.0]])
    # either id of the tie is the right answer at rank 2
    assert topk_score_error(ref, np.array([[0, 2]])) == 0.0
    assert topk_score_error(ref, np.array([[0, 1]])) == 0.0
    # a lower-scored item at rank 2 is off by its score gap
    assert topk_score_error(ref, np.array([[0, 3]])) == pytest.approx(1.0)
    # an excluded item must never come back
    excluded = np.array([[True, False, False, False]])
    with pytest.raises(AssertionError):
        topk_score_error(ref, np.array([[0, 1]]), excluded)
