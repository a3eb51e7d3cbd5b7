#!/usr/bin/env python3
"""Drive rankfm_tpu's main path once on one NVIDIA GPU and check it.

    python chip_smoke.py               # one GPU: phases 1-5 below
    python chip_smoke.py --four-cards  # four GPUs of one host: mesh paths

Phases on one GPU, all through the public API (`RankFM.fit / predict /
recommend / similar_items`, `evaluation.compute`):

1. device: the default JAX device must be a GPU (no CPU fallback); prints
   the card's name and power limit, the JAX version, XLA_FLAGS and the
   compile-cache directory;
2. the ML-1M-shaped headline fit (6,040 x 3,706, ~748k rows, f=20, WARP
   max_samples=20, invscaling, 20 epochs) on the window step, gated
   against the C++ sequential reference-semantics oracle;
3. the candidate step at reference-exact sampling (the scaled parity
   configs of tests/test_parity.py, seed 1492) at +-0.02 on every metric;
4. serving of the phase-2 model against the float64 numpy FM: predict,
   recommend(all users, filter_previous=True), similar_items, compared by
   score; also the serving matmul's error at default and full precision;
5. an Instacart-shaped fit (10,000 x 33,362, ~518k weighted rows, f=50,
   WARP max_samples=50, 21 department features) on the candidate step,
   3 epochs, plus recommend for 1,000 users against the reference.

``--four-cards`` runs only the multi-device paths and what they are
compared with: the phase-2 fit on a 4-way data-parallel mesh (oracle bands
and a one-device fit of the same seed), one explicit table-parallel epoch
of each step kind on a (1, 4) mesh against one-device epochs from the
same weights and key (tightly where both sides draw the same streams with
the same arithmetic), and sharded recommend against one-device top-k
scores.

Any failed check raises, so the script exits non-zero without printing its
last line. On success the last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

``--rehearse`` runs the same control flow at tiny shapes on any backend
(CPU included) without enforcing the quality gates; it never prints the
result line and exits with code 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

METRICS = ("hit_rate", "reciprocal_rank", "discounted_cumulative_gain",
           "precision", "recall")
# reference-exact sampling (candidate step)
TIGHT = {m: 0.02 for m in METRICS}
# window step: precision/recall at parity, the rank-sensitive metrics in the
# wider windowed-negative band
WINDOW = {"hit_rate": 0.06, "reciprocal_rank": 0.06,
          "discounted_cumulative_gain": 0.06, "precision": 0.02,
          "recall": 0.02}
# Serving runs in full f32 (rankfm_tpu.ops.scoring.SERVING_PRECISION):
# against the float64 reference its error is a few f32 roundings of scores
# of order 1-10, far below this bound. The card's default f32 matmul
# precision (TF32, 10-bit mantissa) is measured and printed beside it in
# phase 4; it misses this bound, which is why serving pins full precision.
SERVING_TOL = 1e-3

REHEARSE = False


def log(*parts):
    print(*parts, flush=True)


def gate(name, ok, detail=""):
    """A check: raise on failure (reported, not raised, in a rehearsal)."""
    if ok:
        log(f"  pass  {name} {detail}")
    elif REHEARSE:
        log(f"  MISS  {name} {detail} (rehearsal: not enforced)")
    else:
        raise AssertionError(f"{name} failed: {detail}")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: done in {time.perf_counter() - self.t0:.2f} s")
        return False


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_phase(count):
    import jax

    import rankfm_tpu

    with Phase("phase 1: device"):
        devs = jax.devices()
        if not REHEARSE:
            if devs[0].platform != "gpu":
                raise SystemExit(
                    f"chip_smoke: no GPU (JAX's default device is "
                    f"{devs[0].platform}); refusing to run on it")
            if len(devs) < count:
                raise SystemExit(f"chip_smoke: {count} GPUs needed, "
                                 f"{len(devs)} visible")
            for line in card_line().splitlines():
                log(f"card: {line}")
        log(f"jax {jax.__version__}; devices {len(devs)} x "
            f"{devs[0].device_kind} ({devs[0].platform})")
        log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS')}")
        log(f"compile cache: {rankfm_tpu.compile_cache_dir()} "
            f"(JAX_COMPILATION_CACHE_DIR="
            f"{os.environ.get('JAX_COMPILATION_CACHE_DIR')})")
        return devs[0]


# --------------------------------------------------------------------------
# shapes (full, or tiny for --rehearse)
# --------------------------------------------------------------------------

def ml1m_data():
    from parity_common import make_latent_dataset
    rng = np.random.default_rng(1492)
    if REHEARSE:
        return make_latent_dataset(rng, n_users=200, n_items=2500,
                                   per_user=30, sharp=1.2)
    return make_latent_dataset(rng, n_users=6040, n_items=3706,
                               per_user=165, sharp=1.2)


def ml1m_model(**kw):
    from rankfm_tpu import RankFM
    return RankFM(factors=20, loss="warp", max_samples=20, alpha=0.01,
                  sigma=0.1, learning_rate=0.1,
                  learning_schedule="invscaling", seed=1492, **kw)


def ml1m_epochs():
    return 3 if REHEARSE else 20


class Oracle(threading.Thread):
    """The C++ sequential oracle on a host thread (ctypes releases the
    interpreter lock), so it overlaps the device fit it is compared with."""

    def __init__(self, model, train, test, epochs, **kw):
        super().__init__(daemon=True)
        self.args = (model, train, test, epochs)
        self.kw = kw
        self.result = self.error = None

    def run(self):
        from parity_common import oracle_metrics
        try:
            t0 = time.perf_counter()
            self.result = oracle_metrics(*self.args, **self.kw)
            self.seconds = time.perf_counter() - t0
        except BaseException as e:  # re-raised by get()
            self.error = e

    def get(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.result


def require_oracle():
    from rankfm_tpu import native
    if native.get_oracle() is None:
        raise RuntimeError("the C++ oracle did not build: g++ is required")


def compare_metrics(name, build, ref, gates):
    deltas = {m: build[m] - ref[m] for m in METRICS}
    log(f"  {name}: " + "  ".join(
        f"{m}={build[m]:.4f} (ref {ref[m]:.4f}, {deltas[m]:+.4f})"
        for m in METRICS))
    for m in METRICS:
        gate(f"{name} {m}", abs(deltas[m]) <= gates[m],
             f"delta {deltas[m]:+.4f} vs +-{gates[m]}")
    return deltas


def check_lls(model, epochs):
    lls = [r["log_likelihood"] for r in model.training_log_]
    gate("epoch log-likelihoods finite",
         len(lls) == epochs and bool(np.all(np.isfinite(lls))),
         f"{len(lls)} epochs, first {lls[:1]}, last {lls[-1:]}")


# --------------------------------------------------------------------------
# phases on one GPU
# --------------------------------------------------------------------------

def headline_phase():
    from rankfm_tpu import evaluation

    with Phase("phase 2: ML-1M headline fit, window step"):
        require_oracle()
        train, test = ml1m_data()
        epochs = ml1m_epochs()
        model = ml1m_model()
        oracle = Oracle(model, train, test, epochs)
        oracle.start()
        t0 = time.perf_counter()
        model.fit(train, epochs=epochs)
        fit_s = time.perf_counter() - t0
        plan = model.last_fit_plan_
        log(f"  rows={len(train)} first fit (compile included) "
            f"{fit_s:.2f} s; plan {plan}")
        gate("plan is the window step, single placement",
             plan.step_kind == "window" and plan.placement == "single",
             f"{plan.step_kind}/{plan.placement}")
        check_lls(model, epochs)
        build = evaluation.compute(model, test, k=10)
        ref = oracle.get()
        log(f"  oracle took {oracle.seconds:.1f} s on the host")
        compare_metrics("window vs oracle", build, ref, WINDOW)
        return model, train, test, build


def candidate_phase():
    from parity_common import make_features, make_latent_dataset
    from rankfm_tpu import RankFM, evaluation

    with Phase("phase 3: candidate step at reference-exact sampling"):
        for features, weights in ((False, True), (True, False)):
            rng = np.random.default_rng(11)
            if REHEARSE:
                train, test = make_latent_dataset(rng, n_users=200,
                                                  n_items=300, per_user=20)
            else:
                train, test = make_latent_dataset(rng)
            uf, itf = make_features(rng, train) if features else (None, None)
            sw = (rng.integers(1, 4, len(train)).astype(np.float32)
                  if weights else None)
            epochs = 2 if REHEARSE else 10
            model = RankFM(factors=16, loss="warp", max_samples=10,
                           alpha=0.01, beta=0.1, sigma=0.1, learning_rate=0.1,
                           learning_schedule="invscaling", seed=1492,
                           train_step="candidate")
            oracle = Oracle(model, train, test, epochs, user_features=uf,
                            item_features=itf, sample_weight=sw)
            oracle.start()
            model.fit(train, user_features=uf, item_features=itf,
                      sample_weight=sw, epochs=epochs)
            gate("plan is the candidate step",
                 model.last_fit_plan_.step_kind == "candidate")
            check_lls(model, epochs)
            build = evaluation.compute(model, test, k=10)
            compare_metrics(f"candidate features={features} weights={weights}",
                            build, oracle.get(), TIGHT)


def _indices(index_map, raw):
    idx = index_map.reindex(np.asarray(raw).ravel()).to_numpy(np.float64)
    return np.where(np.isnan(idx), -1, idx).astype(np.int64)


def _seen_mask(model, train):
    mask = np.zeros((len(model.user_id), len(model.item_id)), dtype=bool)
    mask[_indices(model.user_to_index, train[:, 0]),
         _indices(model.item_to_index, train[:, 1])] = True
    return mask


def check_recommend(model, train, users, label):
    """recommend(users, 10, filter_previous=True) held to the float64
    reference by score; returns the largest score error."""
    from parity_common import reference_scores, reference_weights, \
        topk_score_error
    w, x_uf, x_if = reference_weights(model)
    t0 = time.perf_counter()
    recs = model.recommend(users, n_items=10, filter_previous=True)
    rec_s = time.perf_counter() - t0
    got = _indices(model.item_to_index, recs.to_numpy()).reshape(recs.shape)
    rows = _indices(model.user_to_index, users)
    ref = reference_scores(w, x_uf, x_if, rows)
    err = topk_score_error(ref, got, _seen_mask(model, train)[rows])
    gate(f"{label}: recommend({len(users)} users) top-10 scores",
         err <= SERVING_TOL, f"max |err| {err:.3g} (tol {SERVING_TOL}); "
         f"call {rec_s:.3f} s")
    return err


def serving_phase(model, train, test):
    import jax
    import jax.numpy as jnp

    from parity_common import (reference_pair_scores, reference_scores,
                               reference_similarity, reference_weights,
                               topk_score_error)
    from rankfm_tpu.ops import scoring

    with Phase("phase 4: serving against the float64 FM"):
        w, x_uf, x_if = reference_weights(model)
        # predict on the held-out pairs
        got = model.predict(test)
        u = _indices(model.user_to_index, test[:, 0])
        i = _indices(model.item_to_index, test[:, 1])
        known = (u >= 0) & (i >= 0)
        gate("predict: cold-start pairs are NaN",
             bool(np.isnan(got[~known]).all()
                  and np.isfinite(got[known]).all()),
             f"{int((~known).sum())} cold pairs")
        ref = reference_pair_scores(w, x_uf, x_if, u[known], i[known])
        err = float(np.max(np.abs(got[known] - ref)))
        gate(f"predict({int(known.sum())} pairs)", err <= SERVING_TOL,
             f"max |err| {err:.3g}")
        # recommend for every user, previously seen items filtered
        check_recommend(model, train, model.user_id.values, "phase-2 model")
        # similar_items on 100 items
        ids = model.item_id.values[np.linspace(
            0, len(model.item_id) - 1, 100).astype(int)]
        got = np.stack([_indices(model.item_to_index,
                                 model.similar_items(x, 10)) for x in ids])
        ref = reference_similarity(w["v_i"], x_if, w["v_if"],
                                   _indices(model.item_to_index, ids))
        err = topk_score_error(ref, got)
        gate("similar_items(100 items) top-10 scores", err <= SERVING_TOL,
             f"max |err| {err:.3g}")
        # the serving matmul at the card's default precision vs full f32:
        # one [U, 2F] x [2F, I] product of the featureless phase-2 model
        u_mat = jnp.asarray(model._weights["v_u"])
        i_mat = jnp.asarray(model._weights["v_i"])
        bias = jnp.asarray(model._weights["w_i"])
        ref = reference_scores(w, x_uf, x_if)
        for name, prec in (("default", jax.lax.Precision.DEFAULT),
                           ("highest", scoring.SERVING_PRECISION)):
            fn = jax.jit(lambda a, b, c, p=prec: jnp.dot(
                a, b.T, precision=p,
                preferred_element_type=jnp.float32) + c[None, :])
            jax.block_until_ready(fn(u_mat, i_mat, bias))
            t0 = time.perf_counter()
            s = jax.block_until_ready(fn(u_mat, i_mat, bias))
            dt = time.perf_counter() - t0
            err = float(np.max(np.abs(np.asarray(s, np.float64) - ref)))
            log(f"  serving matmul precision={name}: max |err| vs float64 "
                f"{err:.3g} over {ref.size} scores; {dt * 1e3:.2f} ms")


def make_instacart_like(rng):
    """Instacart-shaped weighted log (BASELINE config 3): 10,000 users x
    33,362 products in 21 departments, ~518k distinct (user, product) rows
    weighted log2(orders + 1). Users draw a department from a sparse
    taste, then a product from the department by Zipf popularity; repeated
    draws of a pair count as reorders. Every product appears at least once,
    so the catalog is complete."""
    if REHEARSE:
        n_users, n_items, draws = 300, 9000, 9000
    else:
        n_users, n_items, draws = 10_000, 33_362, 540_000
    n_depts = 21
    item_dept = rng.integers(0, n_depts, n_items)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    taste = rng.dirichlet(np.full(n_depts, 0.2), n_users)       # [U, D]
    act = rng.lognormal(0.0, 0.8, n_users)
    users = rng.choice(n_users, draws, p=act / act.sum())
    dept = (rng.random(draws)[:, None]
            > np.cumsum(taste, axis=1)[users]).sum(axis=1)
    dept = np.minimum(dept, n_depts - 1)
    order = np.argsort(item_dept, kind="stable")
    starts = np.searchsorted(item_dept[order], np.arange(n_depts + 1))
    items = np.empty(draws, np.int64)
    for d in range(n_depts):
        sel = np.flatnonzero(dept == d)
        members = order[starts[d]:starts[d + 1]]
        cdf = np.cumsum(pop[members])
        items[sel] = members[np.minimum(np.searchsorted(
            cdf, rng.random(len(sel)) * cdf[-1]), len(members) - 1)]
    users = np.concatenate([users, rng.integers(0, n_users, n_items)])
    items = np.concatenate([items, np.arange(n_items)])
    pairs, orders = np.unique(np.stack([users, items], 1), axis=0,
                              return_counts=True)
    sw = np.log2(orders + 1).astype(np.float32)
    import pandas as pd
    feats = np.zeros((n_items, n_depts), np.float32)
    feats[np.arange(n_items), item_dept] = 1.0
    item_features = pd.DataFrame(feats,
                                 columns=[f"dept{d}" for d in range(n_depts)])
    item_features.insert(0, "item_id", np.arange(n_items))
    return pairs, sw, item_features


def instacart_phase():
    import jax

    from rankfm_tpu import RankFM
    from rankfm_tpu.models.rankfm import padded_columns

    with Phase("phase 5: Instacart-shaped fit, candidate step"):
        rng = np.random.default_rng(1492)
        pairs, sw, item_features = make_instacart_like(rng)
        log(f"  users={len(np.unique(pairs[:, 0]))} "
            f"items={len(np.unique(pairs[:, 1]))} rows={len(pairs)} "
            f"departments={item_features.shape[1] - 1}")
        model = RankFM(factors=50, loss="warp", max_samples=50, alpha=0.01,
                       learning_rate=0.1, learning_schedule="invscaling",
                       seed=1492)
        t0 = time.perf_counter()
        model.fit(pairs, item_features=item_features, sample_weight=sw,
                  epochs=3)
        log(f"  3-epoch fit (compile included) {time.perf_counter() - t0:.2f} s;"
            f" plan {model.last_fit_plan_}")
        plan = model.last_fit_plan_
        gate("plan is the candidate step", plan.step_kind == "candidate",
             f"{plan.step_kind} at {plan.nblk} window blocks")
        check_lls(model, 3)
        users = model.user_id.values[:1000]
        check_recommend(model, pairs, users, "Instacart model")
        # memory of the compiled epoch program
        u, i, s = padded_columns(model.interactions, model.sample_weight,
                                 plan.batch_size)
        hist = {"offsets": model._offsets_dev, "flat": model._flat_items_dev,
                "bitmap": model._ensure_bitmap()}
        compiled = model._epoch_fn.lower(
            model._weights, model._x_uf_dev, model._x_if_dev, hist, u, i, s,
            len(model.interactions), 0.1, model.alpha, model.beta,
            jax.random.PRNGKey(model.seed), 0).compile()
        log(f"  epoch program memory_analysis: {compiled.memory_analysis()}")


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def _update_error(w0, got, ref):
    """relative Frobenius distance of two epochs' updates to the tables"""
    out = {}
    for k in ("v_u", "v_i", "w_i"):
        d_ref = np.asarray(ref[k]) - np.asarray(w0[k])
        d_got = np.asarray(got[k]) - np.asarray(w0[k])
        out[k] = float(np.linalg.norm(d_got - d_ref)
                       / max(np.linalg.norm(d_ref), 1e-12))
    return out


def _update_norm_ratio(w0, got, ref):
    """norm of one epoch's update over another's, per table"""
    return {k: float(np.linalg.norm(np.asarray(got[k]) - np.asarray(w0[k]))
                     / max(np.linalg.norm(np.asarray(ref[k])
                                          - np.asarray(w0[k])), 1e-12))
            for k in ("v_u", "v_i", "w_i")}


def four_card_phases():
    import jax
    import jax.numpy as jnp

    from rankfm_tpu import evaluation
    from rankfm_tpu.ops.training import make_epoch_fn
    from rankfm_tpu.ops.window import pack_history_device
    from rankfm_tpu.parallel import tp
    from rankfm_tpu.parallel.mesh import make_mesh
    from rankfm_tpu.models.rankfm import padded_columns

    devs = jax.devices()[:4]
    train, test = ml1m_data()
    epochs = ml1m_epochs()

    with Phase("four cards: data-parallel headline fit"):
        require_oracle()
        dp_mesh = make_mesh(data=4, model=1, devices=devs)
        m_dp = ml1m_model(mesh=dp_mesh)
        oracle = Oracle(m_dp, train, test, epochs)
        oracle.start()
        t0 = time.perf_counter()
        m_dp.fit(train, epochs=epochs)
        log(f"  DP fit (compile included) {time.perf_counter() - t0:.2f} s; "
            f"plan {m_dp.last_fit_plan_}")
        gate("plan is data-parallel",
             m_dp.last_fit_plan_.placement == "dp"
             and m_dp.last_fit_plan_.n_dev == 4)
        check_lls(m_dp, epochs)
        b_dp = evaluation.compute(m_dp, test, k=10)
        m_1 = ml1m_model()
        t0 = time.perf_counter()
        m_1.fit(train, epochs=epochs)
        log(f"  one-device fit {time.perf_counter() - t0:.2f} s")
        b_1 = evaluation.compute(m_1, test, k=10)
        ref = oracle.get()
        compare_metrics("DP vs oracle", b_dp, ref, WINDOW)
        compare_metrics("one device vs oracle", b_1, ref, WINDOW)
        compare_metrics("DP vs one device", b_dp, b_1, WINDOW)

    with Phase("four cards: table-parallel epochs on a (1, 4) mesh"):
        tp_meshes = {m: make_mesh(data=1, model=m, devices=devs[:m])
                     for m in (1, 4)}
        clone = ml1m_model()
        clone._init_all(train)
        w0 = {k: np.asarray(v) for k, v in clone._weights.items()}
        U, I = len(clone.user_id), len(clone.item_id)
        plan_bs = m_1.last_fit_plan_.batch_size
        n = len(clone.interactions)
        x_uf, x_if = np.asarray(clone.x_uf), np.asarray(clone.x_if)
        offsets, flat = clone._ui_offsets, clone._ui_items
        mrl = int(np.diff(offsets).max())
        rounds = m_1.last_fit_plan_.rounds
        packed = pack_history_device(offsets, flat, U, I)
        csr = {"offsets": jnp.asarray(offsets), "flat": jnp.asarray(flat),
               "bitmap": jnp.zeros((1, 1), jnp.uint32)}

        def args(bs):
            u, i, s = padded_columns(clone.interactions, clone.sample_weight,
                                     bs)
            return (jnp.asarray(u), jnp.asarray(i), jnp.asarray(s), n, 0.1,
                    0.01, 0.1, jax.random.PRNGKey(5), 0)

        def one_device(kind, bs):
            if kind == "window":
                fn = make_epoch_fn(I, 20, False, False, bs, donate=False,
                                   step_kind="window")
                hist = packed
            else:
                fn = make_epoch_fn(I, 20, False, False, bs,
                                   sample_rounds=rounds, donate=False,
                                   sampler="bsearch", step_kind="candidate",
                                   max_row_len=mrl)
                hist = csr
            w, ll = fn({k: jnp.asarray(v) for k, v in w0.items()},
                       jnp.asarray(x_uf), jnp.asarray(x_if), hist, *args(bs))
            return {k: np.asarray(v) for k, v in w.items()}, float(ll)

        def table_parallel(m, kind, bs):
            mesh = tp_meshes[m]
            if kind == "window":
                hist = {"packed": tp.pad_packed_hist(mesh, packed, U)}
                fn = tp.tp_epoch_fn(mesh, I, 20, False, False, bs,
                                    step_kind="window")
            else:
                hist = csr
                fn = tp.tp_epoch_fn(mesh, I, 20, False, False, bs,
                                    sample_rounds=rounds, max_row_len=mrl)
            w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w0, x_uf, x_if)
            w, ll = fn(w_tp, xu_tp, xi_tp, hist, *args(bs))
            return ({k: np.asarray(v) for k, v in tp.extract(w, U, I).items()},
                    float(ll))

        tp_devices = {"TP on one device": 1, "TP on four": 4}
        runs = {}

        def run(where, kind, bs):
            key = (where, kind, bs)
            if key not in runs:
                runs[key] = (one_device(kind, bs) if where == "one device"
                             else table_parallel(tp_devices[where], kind, bs))
            return runs[key]

        # (step kind, batch, reference, check). "same": the reference draws
        # the same PRNG streams with the same arithmetic, so the epochs
        # differ only by the order of atomic scatter-adds. "distribution":
        # they agree in distribution only.
        #  - window at 256 rows: one window group per batch, so the TP step
        #    draws the one-device step's streams;
        #  - window at the production batch: groups split over the model
        #    axis with a per-shard PRNG fold, so the negatives differ;
        #  - candidate: the one-device step scores all items in one bf16
        #    matmul, the TP step gathered rows in f32, so near-tied WARP
        #    selections flip; the TP step on one device is the same
        #    arithmetic as on four.
        checks = (("window", 256, "one device", "same"),
                  ("window", plan_bs, "one device", "distribution"),
                  ("candidate", plan_bs, "TP on one device", "same"),
                  ("candidate", plan_bs, "one device", "distribution"))
        for kind, bs, where, check in checks:
            got, ll = run("TP on four", kind, bs)
            ref, ll_ref = run(where, kind, bs)
            rel_ll = abs(ll - ll_ref) / abs(ll_ref)
            errs = _update_error(w0, got, ref)
            ratio = _update_norm_ratio(w0, got, ref)
            name = f"TP {kind} epoch (batch {bs}) vs {where}"
            detail = (f"ll rel {rel_ll:.2e}; update rel err {errs}; "
                      f"update norm ratio {ratio}")
            if check == "same":
                gate(name, rel_ll <= 1e-3 and max(errs.values()) <= 1e-3,
                     detail)
            else:
                gate(name, rel_ll <= 0.02 and all(
                    0.9 <= r <= 1.1 for r in ratio.values()), detail)

    with Phase("four cards: sharded recommend on a (1, 4) mesh"):
        err_1 = check_recommend(m_1, train, m_1.user_id.values, "one device")
        m_1.mesh = make_mesh(data=1, model=4, devices=devs)
        m_1._topk_fns = {}
        err_4 = check_recommend(m_1, train, m_1.user_id.values,
                                "sharded over 4")
        log(f"  top-10 score error: one device {err_1:.3g}, "
            f"sharded {err_4:.3g}")


# --------------------------------------------------------------------------

def main(argv=None):
    global REHEARSE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh paths")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny shapes on any backend; no result line")
    args = ap.parse_args(argv)
    REHEARSE = args.rehearse
    count = 4 if args.four_cards else 1
    t0 = time.perf_counter()
    dev = device_phase(count)
    if args.four_cards:
        four_card_phases()
    else:
        model, train, test, _ = headline_phase()
        candidate_phase()
        serving_phase(model, train, test)
        instacart_phase()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    if REHEARSE:
        log("rehearsal finished; no result line")
        return 3
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
