"""End-to-end example mirroring the reference's Instacart notebook
(`examples/instacart.ipynb` in etlundquist/rankfm), runnable without the
dataset: generates an Instacart-shaped synthetic reorder log (10k users x
~33k products, department-structured baskets, log2 order-count sample
weights), trains WARP with side features, and evaluates filtered and
unfiltered ranking metrics against a popularity baseline.

Run: python examples/instacart_style.py
"""

import time

import numpy as np
import pandas as pd

from rankfm_tpu import RankFM, evaluation

N_USERS, N_ITEMS, N_DEPTS = 10_000, 33_362, 21


def make_instacart_like(rng):
    """synthetic (user, product, n_orders) log with department structure"""
    item_dept = rng.integers(0, N_DEPTS, N_ITEMS)
    item_pop = 1.0 / np.arange(1, N_ITEMS + 1) ** 0.8
    rows_u, rows_i, rows_c = [], [], []
    dept_p = item_pop.copy()
    for u in range(N_USERS):
        taste = rng.dirichlet(np.ones(N_DEPTS) * 0.2)
        p = dept_p * taste[item_dept]
        p /= p.sum()
        n_products = int(np.clip(rng.lognormal(3.6, 0.8), 5, 400))
        items = rng.choice(N_ITEMS, size=n_products, replace=False, p=p)
        counts = rng.geometric(0.35, size=n_products)
        rows_u.append(np.full(n_products, u))
        rows_i.append(items)
        rows_c.append(counts)
    df = pd.DataFrame({
        "user_id": np.concatenate(rows_u),
        "product_id": np.concatenate(rows_i),
        "n_orders": np.concatenate(rows_c),
    })
    item_features = pd.get_dummies(
        pd.DataFrame({"product_id": np.arange(N_ITEMS), "dept": item_dept}),
        columns=["dept"], dtype=np.float32)
    return df, item_features


def main():
    rng = np.random.default_rng(1492)
    print("generating Instacart-shaped synthetic data...")
    df, item_features = make_instacart_like(rng)
    train = df.sample(frac=0.68, random_state=1492)
    valid = df.drop(train.index)
    print(f"train={len(train)} valid={len(valid)} items={df.product_id.nunique()}")

    # the reference's headline config: f=50 WARP ms=50, log2(orders+1) weights
    # (instacart.ipynb cells 64-70); side features exercised like cells 96-105
    model = RankFM(factors=50, loss="warp", max_samples=50, alpha=0.01,
                   learning_rate=0.1, learning_schedule="invscaling")
    sw = np.log2(train["n_orders"].values + 1).astype(np.float32)
    t0 = time.time()
    model.fit(train[["user_id", "product_id"]], sample_weight=sw, epochs=30)
    print(f"fit 30 epochs: {time.time() - t0:.1f}s "
          f"(reference: 84 s on a 2.3 GHz i5)")

    t0 = time.time()
    k = 10
    metrics = {
        # one shared retrieval for the four reported metrics
        **evaluation.compute(model, valid[["user_id", "product_id"]],
                             ("hit_rate", "reciprocal_rank", "precision",
                              "recall"), k=k),
    }
    print(f"unfiltered metrics @ {k}: "
          + " ".join(f"{m}={v:.3f}" for m, v in metrics.items())
          + f"  ({time.time() - t0:.1f}s; reference eval: 201 s)")

    t0 = time.time()
    hr_f = evaluation.hit_rate(model, valid[["user_id", "product_id"]], k=k,
                               filter_previous=True)
    rc_f = evaluation.recall(model, valid[["user_id", "product_id"]], k=k,
                             filter_previous=True)
    print(f"filtered (novel-item) metrics @ {k}: hit_rate={hr_f:.3f} "
          f"recall={rc_f:.3f}  ({time.time() - t0:.1f}s)")

    # popularity baseline (instacart.ipynb cell 83)
    top_pop = train["product_id"].value_counts().index.values[:k]
    vsets = valid.groupby("user_id")["product_id"].apply(set)
    hr_pop = np.mean([len(set(top_pop) & s) > 0 for s in vsets])
    print(f"popularity baseline hit_rate@{k}: {hr_pop:.3f}")

    # warm-start with department side features (reference cells 96-105)
    model_f = RankFM(factors=50, loss="warp", max_samples=50, alpha=0.01,
                     beta=0.1, learning_rate=0.1,
                     learning_schedule="invscaling")
    # the feature id set must exactly match the interaction id set
    # (`rankfm.py:194-209` raises KeyError otherwise)
    feats = item_features[item_features.product_id.isin(
        train.product_id.unique())]
    model_f.fit(train[["user_id", "product_id"]],
                item_features=feats, sample_weight=sw, epochs=10)
    hr_feat = evaluation.hit_rate(model_f, valid[["user_id", "product_id"]], k=k)
    print(f"with item side features: hit_rate@{k}={hr_feat:.3f}")

    # cross-model comparison vs implicit-feedback ALS — the reference
    # notebook benchmarks implicit.als on the same data (instacart.ipynb
    # cells 130-137: rankfm HR 0.787 vs ALS 0.264); the in-repo
    # ALS (`rankfm_tpu.baselines.ImplicitALS`) restores that comparison
    from rankfm_tpu.baselines import ImplicitALS

    t0 = time.time()
    als = ImplicitALS(factors=50, regularization=0.05, alpha=20.0,
                      iterations=12)
    als.fit(train[["user_id", "product_id"]])
    als_fit = time.time() - t0
    hr_als = evaluation.hit_rate(als, valid[["user_id", "product_id"]], k=k)
    hr_als_f = evaluation.hit_rate(als, valid[["user_id", "product_id"]],
                                   k=k, filter_previous=True)
    print(f"implicit-ALS baseline: fit={als_fit:.1f}s hit_rate@{k}={hr_als:.3f} "
          f"filtered={hr_als_f:.3f} (rankfm above: {metrics['hit_rate']:.3f}/"
          f"{hr_f:.3f})")


if __name__ == "__main__":
    main()
