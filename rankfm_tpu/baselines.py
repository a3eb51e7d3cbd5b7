"""Cross-model baselines for quality comparisons.

The reference's Instacart notebook benchmarks rankfm against LightFM and
implicit-ALS (`/root/reference/examples/instacart.ipynb` cells 112-137).
Those libraries cannot be installed in this environment, so this module
provides an implicit-feedback ALS (Hu/Koren/Volinsky 2008) — the
same model class as `implicit.als.AlternatingLeastSquares` — implemented
with batched JAX linear algebra:

* the per-row normal equations ``(YtY + Y_u^T (C_u - I) Y_u + reg I) x_u =
  Y_u^T c_u`` are assembled per 512-row user chunk as ONE einsum over the
  chunk's padded histories and solved as a batched [B, F, F] system
  (`jnp.linalg.solve` batches over the chunk);
* user and item sides alternate with swapped roles on the transposed CSR.

`ImplicitALS.recommend` follows the RankFM recommend contract (DataFrame
indexed by user id, `filter_previous`, `cold_start`), so the whole
`rankfm_tpu.evaluation` module works on it unchanged — the examples use
this for same-data model comparisons (`examples/instacart_style.py`).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

import jax
import jax.numpy as jnp

from rankfm_tpu.utils.data import (
    build_index, build_user_items_csr, get_data, map_ids_float,
    map_interactions)


def _csr_transpose(offsets, items, counts_vals, num_cols):
    """(row->cols CSR with per-nnz values) -> col->rows CSR."""
    rows = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32),
                     np.diff(offsets))
    order = np.argsort(items, kind="stable")
    new_items = rows[order]
    new_vals = counts_vals[order]
    new_counts = np.bincount(items, minlength=num_cols)
    new_offsets = np.zeros(num_cols + 1, dtype=np.int64)
    new_offsets[1:] = np.cumsum(new_counts)
    return new_offsets, new_items, new_vals


def _pad_chunks(offsets, items, conf, n_rows, B=512):
    """Vectorized once-per-fit chunking of a CSR side into padded
    ``(idx [b, L], conf [b, L])`` device arrays; ``L`` rounds to the next
    power of two so each distinct solve shape compiles once (unbucketed
    Instacart chunks compiled ~60 distinct programs, ~2 min of warmup)."""
    lens = np.diff(offsets).astype(np.int64)
    chunks = []
    for s in range(0, n_rows, B):
        e = min(s + B, n_rows)
        l = lens[s:e]
        lmax = max(int(l.max()) if e > s else 1, 1)
        L = 1 << (lmax - 1).bit_length()
        idx = np.zeros((e - s, L), dtype=np.int32)
        cf = np.zeros((e - s, L), dtype=np.float32)
        if l.sum():
            rows = np.repeat(np.arange(e - s), l)
            cols = np.arange(l.sum()) - np.repeat(np.cumsum(l) - l, l)
            span = slice(int(offsets[s]), int(offsets[e]))
            idx[rows, cols] = items[span]
            cf[rows, cols] = conf[span]
        chunks.append((jnp.asarray(idx), jnp.asarray(cf)))
    return chunks


@jax.jit
def _solve_chunk(Y, YtY_reg, hist_idx, conf):
    """One ALS half-step for a chunk of rows.

    ``hist_idx [B, L]`` padded history columns (pad = 0 with conf 0),
    ``conf [B, L]`` confidences c=1+alpha*count (0 for pads). Solves the
    Hu-Koren normal equations with the classic (C-1) decomposition so the
    dense YtY term is shared across the chunk."""
    Yh = Y[hist_idx]                                    # [B, L, F]
    s = jnp.maximum(conf - 1.0, 0.0) * (conf > 0)       # (c-1), 0 on pads
    A = YtY_reg[None] + jnp.einsum("ble,blf,bl->bef", Yh, Yh, s)
    b = jnp.einsum("blf,bl->bf", Yh, conf)
    return jnp.linalg.solve(A, b[..., None])[..., 0]


class ImplicitALS:
    """Implicit-feedback ALS baseline (same model family the reference
    benchmarks against, `instacart.ipynb` cells 130-137).

    :param factors: latent dimensionality
    :param regularization: L2 term added to every normal-equation diagonal
    :param alpha: confidence scale, ``c = 1 + alpha * interaction_count``
    :param iterations: alternating sweeps (each = one user + one item solve)
    :param seed: init PRNG seed
    """

    def __init__(self, factors=50, regularization=0.01, alpha=40.0,
                 iterations=15, seed=1492):
        self.factors = factors
        self.regularization = regularization
        self.alpha = alpha
        self.iterations = iterations
        self.seed = seed
        self.is_fit = False

    def fit(self, interactions, epochs=None, verbose=False):
        """Index ids like RankFM, dedupe (user, item) to counts, then
        alternate chunked batched solves. ``epochs`` overrides
        ``iterations`` when given (keeps example call sites uniform)."""
        arr = get_data(interactions)
        self.user_id, self.user_to_index = build_index(arr[:, 0])
        self.item_id, self.item_to_index = build_index(arr[:, 1])
        pairs, _ = map_interactions(
            pd.DataFrame(arr), self.user_to_index, self.item_to_index)
        U, I = len(self.user_id), len(self.item_id)

        uniq, counts = np.unique(pairs, axis=0, return_counts=True)
        conf_vals = (1.0 + self.alpha * counts).astype(np.float32)
        u_off, u_items = build_user_items_csr(uniq, U)
        # per-nnz confidences aligned with the user CSR's item order
        order = np.lexsort((uniq[:, 1], uniq[:, 0]))
        u_conf = conf_vals[order]
        i_off, i_rows, i_conf = _csr_transpose(
            u_off, u_items, u_conf, I)
        self._ui_offsets, self._ui_items = u_off, u_items

        rng = np.random.default_rng(self.seed)
        F = self.factors
        X = jnp.asarray(rng.normal(0, 0.01, (U, F)).astype(np.float32))
        Y = jnp.asarray(rng.normal(0, 0.01, (I, F)).astype(np.float32))
        sweeps = epochs if epochs is not None else self.iterations
        eye = self.regularization * jnp.eye(F, dtype=jnp.float32)
        # padded history chunks are sweep-invariant: build them ONCE per
        # side (vectorized) instead of a per-row Python loop per sweep
        u_chunks = _pad_chunks(u_off, u_items, u_conf, U)
        i_chunks = _pad_chunks(i_off, i_rows, i_conf, I)
        for _ in range(sweeps):
            X = self._half_step(Y, u_chunks, U, eye)
            Y = self._half_step(X, i_chunks, I, eye)
        self.user_factors = np.asarray(X)
        self.item_factors = np.asarray(Y)
        self.is_fit = True
        return self

    def _half_step(self, Y, chunks, n_rows, eye):
        YtY = jnp.dot(Y.T, Y, preferred_element_type=jnp.float32) + eye
        outs = [_solve_chunk(Y, YtY, idx, cf) for idx, cf in chunks]
        return jnp.concatenate(outs, axis=0)[:n_rows]

    def recommend(self, users, n_items=10, filter_previous=False,
                  cold_start="nan"):
        """RankFM-compatible top-N (DataFrame indexed by user id) so
        `rankfm_tpu.evaluation` scores this baseline unchanged."""
        assert self.is_fit, "fit the model first"
        users_arr = pd.Series(users).values
        uidx = map_ids_float(users_arr, self.user_to_index)
        known = ~np.isnan(uidx)
        kidx = uidx[known].astype(np.int32)
        n_items = min(int(n_items), len(self.item_id))
        out = np.full((len(users_arr), n_items), np.nan, dtype=np.float64)
        if len(kidx):
            scores = self.user_factors[kidx] @ self.item_factors.T
            if filter_previous:
                for r, u in enumerate(kidx):
                    a, b = self._ui_offsets[u], self._ui_offsets[u + 1]
                    scores[r, self._ui_items[a:b]] = -np.inf
            top = np.argsort(-scores, axis=1)[:, :n_items].astype(np.float64)
            top[np.take_along_axis(
                scores, top.astype(np.int64), axis=1) == -np.inf] = np.nan
            out[known] = top
        vals = np.full(out.shape, np.nan, dtype=object)
        ok = ~np.isnan(out)
        vals[ok] = self.item_id.values[out[ok].astype(np.int64)]
        recs = pd.DataFrame(vals, index=pd.Index(users_arr))
        if cold_start == "nan":
            return recs
        elif cold_start == "drop":
            return recs.dropna(how="any")
        raise ValueError(
            "param [cold_start] must be set to either 'nan' or 'drop'")
