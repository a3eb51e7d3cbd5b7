"""Batched FM scoring — the accelerator replacement for the reference's
per-pair scalar loop ``compute_ui_utility`` (`/root/reference/rankfm/_rankfm.pyx:48-89`).

The reference's reduced FM is

    s(u, i) = w_i[i] + x_if[i]·w_if + v_u[u]·v_i[i]
              + x_uf[u]·(v_uf @ v_i[i]) + x_if[i]·(v_if @ v_u[u])

Define  user_rep[u] = v_u[u] + v_ufᵀ x_uf[u]
        item_rep[i] = v_i[i] + v_ifᵀ x_if[i]
        item_bias[i] = w_i[i] + x_if[i]·w_if

then the whole model collapses to a single 2F-dimensional inner product:

    s(u, i) = item_bias[i] + [user_rep[u] ; v_u[u]] · [v_i[i] ; item_rep[i] − v_i[i]]

so pointwise scoring is one batched dot and full-catalog retrieval is ONE
[B, 2F] x [2F, I] matmul.

Weights are a plain dict pytree with keys
``w_i [I], w_if [Q], v_u [U,F], v_i [I,F], v_uf [P,F], v_if [Q,F]``
(shapes/init per `rankfm.py:214-244`), and the constant feature matrices
``x_uf [U,P], x_if [I,Q]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Serving (predict / recommend / similar_*) scores in full f32. XLA's
# default precision for an f32 matmul on a GPU is TF32 (10-bit mantissa),
# whose rounding reorders near-tied candidates against an f32 reference;
# the serving contractions are only 2F deep, so full precision costs little
# next to writing the [B, I] score matrix. Training keeps its own bf16
# scoring dots (`ops/training.py`).
SERVING_PRECISION = jax.lax.Precision.HIGHEST


def _dot(a, b):
    return jnp.dot(a, b, precision=SERVING_PRECISION,
                   preferred_element_type=jnp.float32)


def user_reps(w, x_uf):
    """``user_rep [U,F]`` = v_u + x_uf @ v_uf."""
    return w["v_u"] + _dot(x_uf, w["v_uf"])


def item_reps(w, x_if):
    """``item_rep [I,F]`` = v_i + x_if @ v_if."""
    return w["v_i"] + _dot(x_if, w["v_if"])


def item_biases(w, x_if):
    """``item_bias [I]`` = w_i + x_if @ w_if."""
    return w["w_i"] + _dot(x_if, w["w_if"])


def score_pairs_from_reps(user_rep_b, v_u_b, v_i_b, item_rep_b, item_bias_b):
    """Score already-gathered rows: each arg is ``[..., F]`` (bias ``[...]``)."""
    return (
        item_bias_b
        + jnp.sum(user_rep_b * v_i_b, axis=-1)
        + jnp.sum(v_u_b * (item_rep_b - v_i_b), axis=-1)
    )


def score_pairs(w, x_uf, x_if, u_idx, i_idx):
    """Pointwise utilities for index pairs ``(u_idx, i_idx)`` of any shape.

    Equivalent to looping `compute_ui_utility` over the pairs
    (`_rankfm.pyx:345-390`) but fully batched.
    """
    # gather FIRST: reps are row-wise linear, so rep[idx] == gathered-row
    # math — computing full [U,F]/[I,F] tables to keep B rows would cost
    # O(U+I) memory traffic per call on million-row catalogs
    v_u_b = w["v_u"][u_idx]
    v_i_b = w["v_i"][i_idx]
    ur_b = v_u_b + _dot(x_uf[u_idx], w["v_uf"])
    x_if_b = x_if[i_idx]
    ir_b = v_i_b + _dot(x_if_b, w["v_if"])
    ib_b = w["w_i"][i_idx] + _dot(x_if_b, w["w_if"])
    return score_pairs_from_reps(ur_b, v_u_b, v_i_b, ir_b, ib_b)


def score_all_items(w, x_uf, x_if, u_idx):
    """Utilities of ALL items for each user in ``u_idx`` -> ``[B, I]``.

    The matmul behind `recommend` — replaces the reference's per-user,
    per-item scalar loop (`_rankfm.pyx:432-441`).
    """
    v_u_b = w["v_u"][u_idx]          # gather-first on the user side: only
    ur_b = v_u_b + _dot(             # the item side legitimately needs the
        x_uf[u_idx], w["v_uf"])      # full table
    ir = item_reps(w, x_if)                                              # [I, F]
    ib = item_biases(w, x_if)                                            # [I]
    u_mat = jnp.concatenate([ur_b, v_u_b], axis=-1)                      # [B, 2F]
    i_mat = jnp.concatenate([w["v_i"], ir - w["v_i"]], axis=-1)          # [I, 2F]
    return _dot(u_mat, i_mat.T) + ib[None, :]
