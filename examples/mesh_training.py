"""Multi-device training example: the same model code on a
``(data, model)`` mesh, in both sharding regimes.

The reference is single-process single-thread (SURVEY.md §2.6: no
parallelism of any kind); `rankfm_tpu` distributes over a
`jax.sharding.Mesh`:

* **DP** (tables fit per device — the common case): tables replicate, the
  batch shards over every mesh axis, one weight-delta psum per batch.
* **TP** (tables beyond the per-device budget,
  `rankfm_tpu.parallel.train.dp_table_budget`): tables row-shard over ``model``,
  lookups ride owner-masked gathers + one psum per lookup group, update
  payloads all-gather over ``data``.

Runnable anywhere — by default this script forces 8 virtual CPU devices,
so it doubles as a smoke test of the sharded paths without a multi-GPU
host.

Run: python examples/mesh_training.py
"""

import os
import time

import numpy as np

import jax

# default to the 8-virtual-CPU mesh; set RANKFM_EXAMPLE_ACCEL=1 to run on
# the host's accelerators instead
if not os.environ.get("RANKFM_EXAMPLE_ACCEL"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import pandas as pd  # noqa: E402

from rankfm_tpu import RankFM, evaluation  # noqa: E402
from rankfm_tpu.parallel.mesh import make_mesh  # noqa: E402


def make_log(rng, n_users=2000, n_items=1200, per_user=40):
    """implicit log with two planted taste groups"""
    rows = []
    for u in range(n_users):
        grp = u % 2
        pool = np.arange(grp * n_items // 2, (grp + 1) * n_items // 2)
        items = rng.choice(pool, per_user, replace=False)
        rows.extend((u, it) for it in items)
    return pd.DataFrame(rows, columns=["user_id", "item_id"])


def main():
    rng = np.random.default_rng(1492)
    df = make_log(rng)
    train = df.sample(frac=0.75, random_state=0)
    test = df.drop(train.index)
    print(f"devices: {len(jax.devices())}  "
          f"train={len(train)} test={len(test)}")

    n_dev = len(jax.devices())
    mesh = make_mesh(data=max(1, n_dev // 2), model=min(2, n_dev))

    # ---- DP regime (default: these tables easily fit per chip) ----
    m = RankFM(factors=16, loss="warp", max_samples=10, learning_rate=0.1,
               learning_schedule="invscaling", mesh=mesh)
    t0 = time.time()
    m.fit(train, epochs=10)
    print(f"DP mesh fit: {time.time() - t0:.1f}s  "
          f"hit_rate@10={evaluation.hit_rate(m, test, k=10):.3f}")

    # ---- TP regime (forced here; auto-selected when the weight pytree
    # exceeds parallel.train.dp_table_budget) ----
    import rankfm_tpu.parallel.train as ptrain
    saved = ptrain.dp_table_budget
    ptrain.dp_table_budget = lambda mesh: 0
    try:
        m2 = RankFM(factors=16, loss="warp", max_samples=10,
                    learning_rate=0.1, learning_schedule="invscaling",
                    mesh=mesh, train_step="candidate")
        t0 = time.time()
        m2.fit(train, epochs=10)
        print(f"TP mesh fit: {time.time() - t0:.1f}s  "
              f"hit_rate@10={evaluation.hit_rate(m2, test, k=10):.3f}")
    finally:
        ptrain.dp_table_budget = saved

    # sharded retrieval rides the same mesh
    recs = m.recommend(train["user_id"].unique()[:5], n_items=5,
                       filter_previous=True)
    print("sample recommendations:")
    print(recs)


if __name__ == "__main__":
    main()
