"""Benchmark: WARP training throughput on a MovieLens-1M-shaped workload.

Reference baseline (BASELINE.md): the Cython single-core `_fit` processes
749,724 interactions x 20 epochs in 29.7 s on the author's laptop =
~504,900 interaction-updates/s with `factors=20, loss='warp',
max_samples=20, learning_schedule='invscaling'`.

This bench generates a synthetic implicit-feedback log with ML-1M's exact
shape (6,040 users x 3,706 items, 749,724 interactions, power-law item
popularity), fits the same model configuration through the public API, and
reports steady-state interaction-updates/s on the local GPU (it refuses to
run on another backend). The card's name and power limit go to stderr.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import sys
import time

import numpy as np

BASELINE_EXAMPLES_PER_S = 504_900.0

N_USERS, N_ITEMS, N_INTER = 6040, 3706, 749_724
EPOCHS = 20


def make_synthetic(rng):
    """ML-1M-shaped implicit log: user activity and item popularity both
    power-law, truncated to distinct (u, i) pairs like a ratings log."""
    # item popularity ~ Zipf over a shuffled catalog
    item_p = 1.0 / np.arange(1, N_ITEMS + 1) ** 0.9
    item_p /= item_p.sum()
    # user activity: lognormal, min 20 (ML-1M min is 20 ratings/user)
    act = np.minimum(np.maximum(
        rng.lognormal(mean=4.0, sigma=0.9, size=N_USERS), 20), 1500)
    # cumulative rounding hits N_INTER exactly (per-user truncation lost
    # ~0.5 rows/user, leaving the log ~3k rows short of the advertised count)
    target = np.round(np.cumsum(act * (N_INTER / act.sum()))).astype(np.int64)
    act = np.maximum(np.diff(np.concatenate([[0], target])), 5)
    users = np.repeat(np.arange(N_USERS), act)[:N_INTER]
    items = rng.choice(N_ITEMS, size=len(users), p=item_p)
    # NOTE: pairs may repeat, exactly like a raw ratings log — the reference
    # trains on the raw rows too (only the per-user history SET is deduped)
    return np.stack([users, items], 1).astype(np.int64)


def main():
    import subprocess

    import jax

    from rankfm_tpu import RankFM

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX's default device is {dev.platform}); "
                 "no benchmark result")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"# card: {card}", file=sys.stderr)

    rng = np.random.default_rng(1492)
    inter = make_synthetic(rng)
    n = len(inter)

    model = RankFM(factors=20, loss="warp", max_samples=20, alpha=0.01,
                   sigma=0.1, learning_rate=0.1, learning_schedule="invscaling")

    # warmup: compile + first epoch (persistent compile cache permitting)
    t0 = time.time()
    model.fit(inter, epochs=1)
    warm = time.time() - t0

    # steady state: EPOCHS epochs through the public API, best of five
    elapsed = float("inf")
    for _ in range(5):
        t0 = time.time()
        model.fit_partial(inter, epochs=EPOCHS)
        elapsed = min(elapsed, time.time() - t0)

    examples_per_s = n * EPOCHS / elapsed
    print(json.dumps({
        "metric": "warp_training_interactions_per_s_ml1m_shape_1gpu",
        "value": round(examples_per_s, 1),
        "unit": "interactions/s",
        "vs_baseline": round(examples_per_s / BASELINE_EXAMPLES_PER_S, 2),
        "warmup_s": round(warm, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    print(f"# n={n} epochs={EPOCHS} elapsed={elapsed:.2f}s "
          f"warmup(fit+compile)={warm:.1f}s card={card}", file=sys.stderr)


if __name__ == "__main__":
    main()
