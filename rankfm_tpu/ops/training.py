"""Batched pairwise BPR/WARP training step — the accelerator replacement for
the reference's per-sample Cython SGD loop (`rankfm/_rankfm.pyx:122-342`).

Two step flavors, both with zero data-dependent control flow (the reference
draws negatives sequentially with a margin early-stop, `_rankfm.pyx:244-270`):

* **Window step** (`make_window_train_step`, the default from 3 through 8
  window blocks): negatives come from G random contiguous item blocks per
  batch (`rankfm_tpu.ops.window`), scored by batched matmuls; the draw
  count is sampled in closed form (1 + Geometric of the window's violator
  rate), a uniform window violator is picked by masked argmax, and the
  no-violation fallback takes the hardest member of a Bernoulli subset
  that emulates "hardest of max_samples uniform draws" exactly.

* **Candidate step** (`make_train_step`, every other catalog size): the
  reference's own shape — a fixed-width [B, max_samples] candidate
  matrix; because every pre-stop draw has pairwise >= MARGIN, the first
  violator IS the running min, so ``(j, sampled)`` falls out of a masked
  argmax/argmin. Membership rejection is pre-draw (bitmap/bsearch samplers)
  or post-hoc on the selected negative only (`post_reject`). BPR is WARP
  with ``max_samples = 1`` (`rankfm.py:294-297`).

* **Rank multiplier** matches the reference including its C integer division:
  ``multiplier = log((I-1) // sampled) / log(I)`` (`_rankfm.pyx:269`,
  compiled with ``cdivision=True``).

* **Gradients are hand-written** (the model is 5 einsums) and accumulated
  across the minibatch with ``.at[].add`` scatter-adds, exactly mirroring
  the per-weight update expressions at `_rankfm.pyx:272-326`, including the
  detail that feature-factor rows are only touched when the corresponding
  feature value (or positive/negative feature *difference*) is nonzero.

* **Per-touch L2 decay with geometric correction.** The reference applies
  ``w -= eta * 2 * reg * w`` once per *touch*, interleaved with gradient
  terms. A row touched k times in a batch follows the recursion
  ``w <- c*w + eta*g_t`` with ``c = 1 - 2*reg*eta``; under exchangeable
  within-batch gradients this telescopes to

      w_new = c^k * w + eta * (1 - c^k) / (k * (1 - c)) * sum_t g_t

  which preserves both the reference's decay rate and its fixed point
  ``w* = E[g] / (2*reg)`` for dense weights touched every sample. Plain
  summed scatter-add with linearized decay would diverge for the dense
  feature weights (``eta * 2*beta * batch_size >> 1``).

  The dense feature tables (``w_if``, ``v_uf``, ``v_if``) are touched by a
  large share of a batch's rows, so ``c^k`` is near zero and the order of
  touches decides where they end: the reference leaves them at a moving
  average of the last ~``1 / (1 - c)`` touches, not at the batch mean. For
  these tables the recursion is unrolled exactly in the batch's (shuffled)
  row order, ``w_new = c^k * w + eta * sum_t c^(k - r_t) * g_t`` with
  ``r_t`` the row's touch rank (`_ordered_feature_grads`). The row tables
  (``w_i``, ``v_i``, ``v_u``) see a few touches per batch, where
  ``c^k ~ 1`` and order does not matter.

Parity target is metric parity (hit-rate/recall@k within run variance), not
bitwise weight parity — per SURVEY.md §2.4 the reference's same-epoch update
visibility cannot (and should not) be reproduced on a batched accelerator.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp

from rankfm_tpu.ops.negatives import (
    bitmap_member, csr_member, sample_negatives, sample_negatives_bitmap)
from rankfm_tpu.ops.window import (
    BITS_PER_LANE, block_size, draw_window_blocks, item_pad, window_block_cdf)

MARGIN = 1.0


def _decay_factor(eta, reg):
    """``c = 1 - 2*reg*eta``, the per-touch L2 decay factor"""
    return jnp.maximum(1.0 - eta * 2.0 * reg, 1e-8)


def _decay_apply(wt, grad, counts, eta, reg):
    """Apply the geometric-corrected per-touch decay + accumulated gradient.

    ``counts`` is the per-row touch count (float), broadcast over trailing dims.
    """
    c = _decay_factor(eta, reg)
    if wt.ndim > counts.ndim:
        counts = counts[..., None]
    ck = jnp.exp(counts * jnp.log(c))
    denom = counts * (1.0 - c)
    f = jnp.where(denom > 1e-12, (1.0 - ck) / jnp.maximum(denom, 1e-12), 1.0)
    return ck * wt + eta * f * grad


def _touch_order_weights(touch, c, offset=0.0, total=None):
    """``c^(k - r)`` for the ``r``-th of ``k`` touches of each column, in
    row order; 0 where a row does not touch the column.

    ``touch [B, K]`` is 0/1. ``offset [K]`` counts touches by rows that come
    before this block of rows and ``total [K]`` all touches of the batch
    (defaults: this block alone), so a batch split over devices gets the
    ranks of the whole batch."""
    rank = offset + jnp.cumsum(touch, axis=0)
    total = rank[-1] if total is None else total
    return touch * jnp.exp((total - rank) * jnp.log(c))


def _ordered_feature_grads(d, row_ok, x_uf_b, dx_if, dv_i, v_u_b, c,
                           ranks=None):
    """Gradients of the dense feature tables with each touch weighted by
    ``c^(k - r_t)`` (see the module docstring), plus their touch counts.

    ``dx_if = x_if[i] - x_if[j]``, ``dv_i = v_i[i] - v_i[j]``. ``ranks``
    (optional) maps each table's touch matrix to its ``(offset, total)``
    for a batch split over devices. Returns ``(g_w_if, g_v_uf, g_v_if,
    k_w_if, k_v_uf, k_v_if)``; the counts are of this block's rows."""
    ranks = ranks or (lambda t: (0.0, None))
    t_w_if = jnp.broadcast_to(row_ok[:, None], dx_if.shape)
    t_v_if = row_ok[:, None] * (dx_if != 0).astype(jnp.float32)
    t_v_uf = row_ok[:, None] * (x_uf_b != 0).astype(jnp.float32)
    o_w_if = _touch_order_weights(t_w_if, c, *ranks(t_w_if))
    o_v_if = _touch_order_weights(t_v_if, c, *ranks(t_v_if))
    o_v_uf = _touch_order_weights(t_v_uf, c, *ranks(t_v_uf))
    f32 = jnp.float32
    g_w_if = jnp.einsum("b,bq->q", d, dx_if * o_w_if,
                        preferred_element_type=f32)
    g_v_uf = jnp.einsum("b,bp,bf->pf", d, x_uf_b * o_v_uf, dv_i,
                        preferred_element_type=f32)
    g_v_if = jnp.einsum("b,bq,bf->qf", d, dx_if * o_v_if, v_u_b,
                        preferred_element_type=f32)
    return (g_w_if, g_v_uf, g_v_if, jnp.sum(t_w_if, axis=0),
            jnp.sum(t_v_uf, axis=0), jnp.sum(t_v_if, axis=0))


def _ordered_decay_apply(wt, grad, counts, eta, c):
    """``c^k * w + eta * grad`` for a gradient already weighted by touch
    order (`_ordered_feature_grads`)."""
    if wt.ndim > counts.ndim:
        counts = counts[..., None]
    return jnp.exp(counts * jnp.log(c)) * wt + eta * grad


def window_warp_select(pw, nonmem, kcand, kgeo, M):
    """Shared window-WARP selection: given pairwise
    utilities ``pw [G, Bg, W]`` over each group's negative window and window
    non-membership ``nonmem``, draw the WARP outcome with zero data-dependent
    control flow — the draw count is 1 + Geometric of the window's violator
    rate, a uniform window violator is picked by masked argmax, and the
    no-violation fallback takes the hardest member of a Bernoulli subset that
    emulates "hardest of ``M`` uniform draws" exactly (`_rankfm.pyx:244-270`).

    Returns ``(jloc [G, Bg], sampled [G*Bg] int32, has_j [G*Bg] bool)``.
    Shared by the single-device window step and the explicit-TP window step
    (`rankfm_tpu/parallel/tp.py`) so their selection semantics can never
    drift."""
    G, Bg, W = pw.shape
    B = G * Bg
    u01 = jax.random.uniform(kcand, (G, Bg, W), minval=1e-7, maxval=1.0)
    if M == 1:
        key_m = jnp.where(nonmem, u01, -jnp.inf)
        sampled = jnp.ones((B,), jnp.int32)
    else:
        viol = (pw < MARGIN) & nonmem
        nv = jnp.sum(viol.astype(jnp.float32), axis=2)            # [G, Bg]
        n_nonmem = jnp.sum(nonmem.astype(jnp.float32), axis=2)
        r1 = jax.random.uniform(kgeo, (G, Bg), minval=1e-7, maxval=1.0)
        p_c = jnp.clip(nv / jnp.maximum(n_nonmem, 1.0), 1e-9, 1.0 - 1e-7)
        geo = jnp.floor(jnp.log(r1) / jnp.log(1.0 - p_c)) + 1.0
        geo = jnp.where(nv > 0, geo, jnp.float32(M))
        found = (nv > 0) & (geo <= M)
        sampled = jnp.minimum(geo, jnp.float32(M)).astype(jnp.int32).reshape(B)
        # fallback = the reference's "hardest of max_samples uniform
        # draws" (`_rankfm.pyx:259-268`): Bernoulli-subsample the window
        # non-members at rate M/n_nonmem (= M uniform draws in
        # expectation) and take the hardest inside the subset; items
        # outside the subset ride 1e6 lower so the global hardest still
        # backstops an empty subset
        pthr = (M / jnp.maximum(n_nonmem, 1.0))[:, :, None]
        off_subset = (u01 >= pthr).astype(jnp.float32) * 1e6
        key_m = jnp.where(
            found[:, :, None],
            jnp.where(viol, u01, -jnp.inf),
            jnp.where(nonmem & ~viol, -pw - off_subset, -jnp.inf),
        )
    jloc = jnp.argmax(key_m, axis=2)                              # [G, Bg]
    has_j = (jnp.max(key_m, axis=2) > -jnp.inf).reshape(B)
    return jloc, sampled, has_j


def pick_window_groups(B):
    """Number of independent negative windows per batch: double until each
    group lands in [128, 256) rows — negatives drawn from a single shared
    window over-correlate the j choices within a batch and cluster stale
    pushes on one block. Shared by the window step and its TP twin."""
    G = 1
    while G < 64 and B % (2 * G) == 0 and B // (2 * G) >= 128:
        G *= 2
    return G


def _apply_pair_updates(w, u, i, j, d, row_ok, v_u_b, user_rep_b, x_uf_b,
                        v_i_pos, v_i_j, x_if_pos, x_if_j, feat_rep_pos,
                        feat_rep_j, eta, alpha, beta, x_uf_any, x_if_any):
    """Gradient accumulation + per-touch decayed table update for a batch of
    selected (u, i, j) pairs — the update expressions of the reference's
    per-sample loop (`_rankfm.pyx:272-326`), batched. Shared by the
    candidate and window steps so their training semantics can never drift.

    ``d`` is the per-row outer derivative (already masked by ``row_ok`` and
    scaled by sample weight and the WARP multiplier)."""
    d_col = d[:, None]
    # w_if is touched by every row when item features exist, v_if[q] when
    # x_if[i,q] != x_if[j,q], v_uf[p] when x_uf[u,p] != 0
    # (`_rankfm.pyx:297-326`)
    c_f = _decay_factor(eta, beta)
    g_w_if, g_v_uf, g_v_if, k_w_if, k_v_uf, k_v_if = _ordered_feature_grads(
        d, row_ok, x_uf_b, x_if_pos - x_if_j, v_i_pos - v_i_j, v_u_b, c_f)
    if not x_if_any:
        k_w_if, k_v_if = jnp.zeros_like(k_w_if), jnp.zeros_like(k_v_if)
    if not x_uf_any:
        k_v_uf = jnp.zeros_like(k_v_uf)

    # d_v_u = (v_i[i] - v_i[j]) + v_ifᵀ(x_if[i] - x_if[j])  (`_rankfm.pyx:292,305`)
    g_u_rows = d_col * ((v_i_pos - v_i_j) + (feat_rep_pos - feat_rep_j))
    g_w_i = jnp.zeros_like(w["w_i"]).at[i].add(d).at[j].add(-d)
    g_v_i = (
        jnp.zeros_like(w["v_i"])
        .at[i].add(d_col * user_rep_b)
        .at[j].add(-d_col * user_rep_b)
    )
    g_v_u = jnp.zeros_like(w["v_u"]).at[u].add(g_u_rows)
    k_i = jnp.zeros_like(w["w_i"]).at[i].add(row_ok).at[j].add(row_ok)
    k_u = jnp.zeros(w["v_u"].shape[0], dtype=jnp.float32).at[u].add(row_ok)
    w_i_new = _decay_apply(w["w_i"], g_w_i, k_i, eta, alpha)
    v_i_new = _decay_apply(w["v_i"], g_v_i, k_i, eta, alpha)
    v_u_new = _decay_apply(w["v_u"], g_v_u, k_u, eta, alpha)

    return {
        "w_i": w_i_new,
        "v_i": v_i_new,
        "v_u": v_u_new,
        "w_if": _ordered_decay_apply(w["w_if"], g_w_if, k_w_if, eta, c_f),
        "v_uf": _ordered_decay_apply(w["v_uf"], g_v_uf, k_v_uf, eta, c_f),
        "v_if": _ordered_decay_apply(w["v_if"], g_v_if, k_v_if, eta, c_f),
    }


def make_train_step(num_items, max_samples, x_uf_any, x_if_any, sample_rounds=8,
                    sampler="bsearch", post_reject=False, max_row_len=None):
    """Build the jittable single-batch training step.

    Static configuration: catalog size, WARP width, whether user/item features
    are present (drives the decay-count bookkeeping, mirroring the
    ``x_uf_any``/``x_if_any`` fast paths at `_rankfm.pyx:192-194`), and the
    membership strategy for negative rejection: ``'bitmap'`` (one packed-row
    gather; fastest when U*I/8 bytes fits in HBM) or ``'bsearch'`` (CSR binary
    search; scales to arbitrarily large catalogs).

    The step takes ``hist = {'offsets', 'flat', 'bitmap'}``; only the arrays
    the chosen sampler needs are read (pass 1-element dummies for the rest).
    """
    M = max_samples
    log_I = math.log(num_items) if num_items > 1 else 1.0

    # pre-rejection membership tests are [B, M] in-row gathers. With ``post_reject`` (single-device large
    # catalogs, member-hit rate h/I << 1%) we instead test ONLY the SELECTED
    # negative post-hoc ([B]-element bitmap lookup, or a CSR binary search
    # when the catalog is too large for a bitmap) and re-select once when it
    # was a member: the reference's in-place redraw (`_rankfm.pyx:249-252`)
    # at ~0.4% slot-pollution fidelity, without any [B, M] gather. Kept off
    # for the mesh path: element gathers against a row-sharded bitmap would
    # force per-step all-gathers.
    post_reject = post_reject and M > 1

    def step(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta, key):
        B = u.shape[0]

        if post_reject:
            cands = jax.random.randint(key, (B, M), 0, num_items,
                                       dtype=jnp.int32)
            cand_ok = jnp.ones((B, M), bool)
        elif sampler == "bitmap":
            # honor the configured rounds: this pre-filtering branch runs
            # exactly when histories are DENSE (sparse configs take the
            # post_reject path with no rounds at all), so clamping rounds
            # would leave (h/I)^rounds residual member slots at the density
            # where it hurts
            cands, cand_ok = sample_negatives_bitmap(
                key, u, hist["bitmap"], num_items, M,
                rounds=max(1, sample_rounds),
            )
        else:
            cands, cand_ok = sample_negatives(
                key, u, hist["offsets"], hist["flat"], num_items, M,
                rounds=sample_rounds, max_row_len=max_row_len,
            )  # [B, M]

        # ---- gather user-side rows; score positives + candidates ----
        v_u_b = w["v_u"][u]                                   # [B, F]
        x_uf_b = x_uf[u]                                      # [B, P]
        user_rep_b = v_u_b + jnp.dot(x_uf_b, w["v_uf"], preferred_element_type=jnp.float32)

        if x_uf_any or x_if_any:
            item_rep = w["v_i"] + jnp.dot(x_if, w["v_if"], preferred_element_type=jnp.float32)
            item_bias = w["w_i"] + jnp.dot(x_if, w["w_if"], preferred_element_type=jnp.float32)
            u_mat = jnp.concatenate([user_rep_b, v_u_b], axis=-1)            # [B, 2F]
            i_mat = jnp.concatenate([w["v_i"], item_rep - w["v_i"]], axis=-1)  # [I, 2F]
        else:
            # featureless: the FM is bias + v_u.v_i — skip the zero feature
            # half (at web scale the [I, 2F] concat alone is GBs of traffic)
            item_bias = w["w_i"]
            u_mat = v_u_b
            i_mat = w["v_i"]
        # bf16 operands for the scoring matmuls (f32 accumulate): SGD is
        # robust to bf16-grade scoring noise, and bf16 tensor-core products
        # run at several times the f32 rate
        if B * num_items <= 2**28:
            # small catalog: ONE [B,2F]x[2F,I] matmul scores everything;
            # in-row take_along_axis beats [B,M,F] 3-D gathers here
            scores_all = (
                jnp.dot(u_mat.astype(jnp.bfloat16), i_mat.T.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
                + item_bias[None, :]
            )                                                 # [B, I]
            ut_ui = jnp.take_along_axis(scores_all, i[:, None], axis=1)[:, 0]
            ut_uj = jnp.take_along_axis(scores_all, cands, axis=1)        # [B, M]
        else:
            # large catalog: a [B, I] score matrix costs GBs of HBM traffic
            # per elementwise pass — gather only the M candidate rows.
            # The bias rides as an extra bf16 column so candidate scoring is
            # ONE row gather (bf16: half the random-read bytes) + one einsum
            i_ext16 = jnp.concatenate(
                [i_mat, item_bias[:, None]], axis=-1).astype(jnp.bfloat16)
            u_ext16 = jnp.concatenate(
                [u_mat, jnp.ones((B, 1), u_mat.dtype)], axis=-1
            ).astype(jnp.bfloat16)
            # stay 2-D throughout: a [B, M, F+1] view forces a lane relayout
            # (trailing dim < 128) that costs more than the gather itself
            cand_flat = i_ext16[cands.reshape(-1)]                 # [B*M, 2F+1]
            u_rep = jnp.repeat(u_ext16, M, axis=0)                 # [B*M, 2F+1]
            ut_uj = jnp.sum(
                (cand_flat * u_rep).astype(jnp.float32), axis=-1
            ).reshape(B, M)
            pos_rows = i_mat[i]                                           # [B, 2F]
            ut_ui = (
                jnp.sum(u_mat * pos_rows, axis=-1) + item_bias[i]
            )

        # ---- WARP selection: first margin violator, else hardest negative ----
        pairwise = ut_ui[:, None] - ut_uj                     # [B, M]
        pairwise = jnp.where(cand_ok, pairwise, jnp.inf)

        def select(pw_mat, ok_mat):
            viol = pw_mat < MARGIN
            any_viol = jnp.any(viol, axis=-1)
            first_viol = jnp.argmax(viol, axis=-1)
            sel = jnp.where(any_viol, first_viol, jnp.argmin(pw_mat, axis=-1))
            sampled = jnp.where(any_viol, first_viol + 1, M).astype(jnp.int32)
            take = lambda a: jnp.take_along_axis(a, sel[:, None], axis=1)[:, 0]
            return sel, sampled, take(cands), take(pw_mat), take(ok_mat)

        sel, sampled, j, pw, ok_sel = select(pairwise, cand_ok)
        if post_reject:
            if sampler == "bitmap":
                def member_of_j(jj):
                    return bitmap_member(
                        hist["bitmap"], u, jj[:, None])[:, 0]
            else:
                def member_of_j(jj):
                    return csr_member(hist["flat"], hist["offsets"], u, jj,
                                      max_row_len)
            # membership of the selected negative only; mask a member slot
            # and re-select (second members are ~(h/I)^2-rare: drop the row)
            for _ in range(2):
                is_mem = member_of_j(j)
                pairwise = jnp.where(
                    is_mem[:, None]
                    & (jnp.arange(M)[None, :] == sel[:, None]),
                    jnp.inf, pairwise)
                sel, sampled, j, pw, ok_sel = select(pairwise, cand_ok)
            ok_sel = ok_sel & ~member_of_j(j)
        row_ok = (valid & ok_sel & jnp.isfinite(pw)).astype(jnp.float32)

        # multiplier = log((I-1) // sampled) / log(I)   (C int division)
        ratio = jnp.maximum((num_items - 1) // sampled, 1).astype(jnp.float32)
        multiplier = jnp.log(ratio) / log_I

        pw_safe = jnp.where(jnp.isfinite(pw), pw, 0.0)
        d_outer = jax.nn.sigmoid(-pw_safe)                    # 1 / (exp(pw) + 1)
        d = row_ok * sw * multiplier * d_outer                # [B]
        ll = jnp.sum(row_ok * jax.nn.log_sigmoid(pw_safe))

        # ---- selected-pair gathers for gradient terms (all 2-D [B, *]) ----
        v_i_pos = w["v_i"][i]                                 # [B, F]
        x_if_pos = x_if[i]                                    # [B, Q]
        feat_rep_pos = jnp.dot(x_if_pos, w["v_if"], preferred_element_type=jnp.float32)
        v_i_j = w["v_i"][j]                                   # [B, F]
        x_if_j = x_if[j]                                      # [B, Q]
        feat_rep_j = jnp.dot(x_if_j, w["v_if"], preferred_element_type=jnp.float32)

        # ---- gradients + decayed table updates (shared helper) ----
        new_w = _apply_pair_updates(
            w, u, i, j, d, row_ok, v_u_b, user_rep_b, x_uf_b,
            v_i_pos, v_i_j, x_if_pos, x_if_j, feat_rep_pos, feat_rep_j,
            eta, alpha, beta, x_uf_any, x_if_any)
        return new_w, ll

    return step


def make_window_train_step(num_items, max_samples, x_uf_any, x_if_any):
    """Window-WARP training step.

    Negatives for each row group come from ONE random contiguous block of
    ``BLK`` items (the `rankfm_tpu.ops.window` bit-pack and block draw),
    with the geometric-draw-count / uniform-violator / soft-hardest-fallback
    selection of `window_warp_select`. Scoring the window is one batched
    matmul and every selection pass is O(B * BLK) elementwise — no
    per-candidate row gathers and no rejection-sampling gathers.

    Signature: ``step(w, x_uf, x_if, packed_hist, u, i, sw, valid, eta,
    alpha, beta, key) -> (w, ll)``.
    """
    M = max_samples
    log_I = math.log(num_items) if num_items > 1 else 1.0
    BLK = block_size(num_items)
    I_pad = item_pad(num_items)
    LW = BLK // BITS_PER_LANE
    lg_lw = LW.bit_length() - 1
    real_cum = window_block_cdf(num_items)

    def step(w, x_uf, x_if, packed_hist, u, i, sw, valid, eta, alpha, beta, key):
        B = u.shape[0]
        G = pick_window_groups(B)
        Bg = B // G
        kblk, kcand, kgeo = jax.random.split(key, 3)
        blkg = draw_window_blocks(kblk, (G,), num_items, real_cum)

        # ---- window membership bits (blocked 16-bit pack, tile layout).
        # Gather the batch's USER ROWS first ([B, W] — batch-sized), THEN
        # slice each group's window lanes: slicing packed_hist before the
        # row gather would materialize a [G, num_users, LW] intermediate
        # (user-count-scaled HBM traffic per scan step). ----
        u3 = u.reshape(G, Bg)
        rows_full = packed_hist[u3]                           # [G, Bg, W]
        rows = jax.vmap(lambda rf, b: jax.lax.dynamic_slice_in_dim(
            rf, b * LW, LW, axis=1))(rows_full, blkg)         # [G, Bg, LW]
        col = jnp.arange(BLK, dtype=jnp.int32)[None, None, :]
        bits = jnp.tile(rows, (1, 1, BITS_PER_LANE))          # [G, Bg, BLK]
        nonmem = ((bits >> (col >> lg_lw)) & 1) == 0          # pad items = member

        # ---- score each group's window with one batched matmul ----
        v_u_b = w["v_u"][u]                                   # [B, F]
        x_uf_b = x_uf[u]                                      # [B, P]
        user_rep_b = v_u_b + jnp.dot(x_uf_b, w["v_uf"], preferred_element_type=jnp.float32)
        if x_uf_any or x_if_any:
            item_rep = w["v_i"] + jnp.dot(x_if, w["v_if"], preferred_element_type=jnp.float32)
            item_bias = w["w_i"] + jnp.dot(x_if, w["w_if"], preferred_element_type=jnp.float32)
            u_mat = jnp.concatenate([user_rep_b, v_u_b], axis=-1)             # [B, 2F]
            i_mat = jnp.concatenate([w["v_i"], item_rep - w["v_i"]], axis=-1)  # [I, 2F]
        else:
            item_bias = w["w_i"]
            u_mat = v_u_b
            i_mat = w["v_i"]
        i_pad_mat = jnp.pad(i_mat, ((0, I_pad - i_mat.shape[0]), (0, 0)))
        bias_pad = jnp.pad(item_bias, (0, I_pad - item_bias.shape[0]))
        i_win = jax.vmap(lambda b: jax.lax.dynamic_slice_in_dim(
            i_pad_mat, b * BLK, BLK, axis=0))(blkg)           # [G, BLK, 2F]
        b_win = jax.vmap(lambda b: jax.lax.dynamic_slice_in_dim(
            bias_pad, b * BLK, BLK, axis=0))(blkg)            # [G, BLK]
        scores_win = (
            jnp.einsum("gbf,gwf->gbw",
                       u_mat.reshape(G, Bg, -1).astype(jnp.bfloat16),
                       i_win.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
            + b_win[:, None, :]
        )                                                     # [G, Bg, BLK]
        v_i_pos = w["v_i"][i]                                 # [B, F]
        x_if_pos = x_if[i]                                    # [B, Q]
        feat_rep_pos = jnp.dot(x_if_pos, w["v_if"], preferred_element_type=jnp.float32)
        if x_uf_any or x_if_any:
            i_rows = jnp.concatenate(
                [v_i_pos, feat_rep_pos], axis=-1)             # i_mat rows of i
        else:
            i_rows = v_i_pos
        ut_ui = jnp.sum(u_mat * i_rows, axis=-1) + item_bias[i]
        pw = ut_ui.reshape(G, Bg)[:, :, None] - scores_win    # [G, Bg, BLK]

        # ---- WARP selection (shared helper) ----
        jloc, sampled, has_j = window_warp_select(pw, nonmem, kcand, kgeo, M)
        j = (blkg[:, None] * BLK + jloc).reshape(B).astype(jnp.int32)
        j = jnp.minimum(j, num_items - 1)  # only reachable when has_j=False
        row_ok = (valid & has_j).astype(jnp.float32)

        # exact pointwise recompute at the selected j (f32)
        v_i_j = w["v_i"][j]                                   # [B, F]
        x_if_j = x_if[j]                                      # [B, Q]
        feat_rep_j = jnp.dot(x_if_j, w["v_if"], preferred_element_type=jnp.float32)
        if x_uf_any or x_if_any:
            j_rows = jnp.concatenate([v_i_j, feat_rep_j], axis=-1)
        else:
            j_rows = v_i_j
        ut_uj = jnp.sum(u_mat * j_rows, axis=-1) + item_bias[j]
        pw_sel = ut_ui - ut_uj

        # multiplier = log((I-1) // sampled) / log(I)   (C int division)
        ratio = jnp.maximum((num_items - 1) // sampled, 1).astype(jnp.float32)
        multiplier = jnp.log(ratio) / log_I
        d = row_ok * sw * multiplier * jax.nn.sigmoid(-pw_sel)
        ll = jnp.sum(row_ok * jax.nn.log_sigmoid(pw_sel))

        # ---- gradients + decayed table updates (shared helper; identical
        # update expressions to make_train_step by construction) ----
        new_w = _apply_pair_updates(
            w, u, i, j, d, row_ok, v_u_b, user_rep_b, x_uf_b,
            v_i_pos, v_i_j, x_if_pos, x_if_j, feat_rep_pos, feat_rep_j,
            eta, alpha, beta, x_uf_any, x_if_any)
        return new_w, ll

    return step


@lru_cache(maxsize=32)
def make_epoch_fn(num_items, max_samples, x_uf_any, x_if_any, batch_size,
                  sample_rounds=8, donate=True, sampler="bsearch",
                  step_kind="window", post_reject=False, max_row_len=None):
    """Build the jitted whole-epoch function.

    One epoch = device-side shuffle + `lax.scan` over minibatches of the
    padded interaction arrays. Replaces the reference's per-epoch
    ``np.random.shuffle`` + N sequential sample updates (`_rankfm.pyx:218-336`).

    ``step_kind`` selects the training step:

    * ``'window'`` — `make_window_train_step`; ``hist`` is the blocked
      16-bit pack from `rankfm_tpu.ops.window.pack_history_device`. Fastest;
      validated at metric parity up to ~8 window blocks.
    * ``'candidate'`` — `make_train_step` (reference-style per-row candidate
      draws); ``hist`` is the ``{'offsets','flat','bitmap'}`` dict. Slower
      but catalog-size-independent sampling fidelity — used for very large
      catalogs where windowed negatives measurably lag it.

    The returned function signature is
    ``epoch_fn(w, x_uf, x_if, hist, u, i, sw, n_real, eta, alpha, beta, key,
    epoch) -> (w, log_likelihood)``
    where ``u/i/sw`` are the *padded* interaction columns (pad rows carry
    ``sw = 0`` and index ``>= n_real``) and ``n_real`` is baked in statically.
    The per-epoch PRNG stream is ``fold_in(key, epoch)`` computed on device so
    callers pass the same base key every epoch.
    """
    if step_kind == "window":
        step = make_window_train_step(num_items, max_samples, x_uf_any,
                                      x_if_any)
    else:
        step = make_train_step(num_items, max_samples, x_uf_any, x_if_any,
                               sample_rounds, sampler,
                               post_reject=post_reject,
                               max_row_len=max_row_len)

    epoch_fn = make_epoch_body(step, batch_size)
    donate_argnums = (0,) if donate else ()
    return jax.jit(epoch_fn, static_argnums=(7,), donate_argnums=donate_argnums)


def make_epoch_body(step, batch_size):
    """Un-jitted epoch driver around a single-batch ``step``: device-side
    shuffle, per-batch PRNG streams (``fold_in(fold_in(key, epoch), t)``),
    validity masking of pad rows, and a `lax.scan` over minibatches.

    Shared by the single-device path (`make_epoch_fn`) and the GSPMD
    sharded path (`rankfm_tpu/parallel/train.py`) so the two can never
    drift in shuffle/PRNG/validity conventions — the documented guarantee
    that mesh and single-chip runs train identically rests on this."""

    def epoch_fn(w, x_uf, x_if, hist, u, i, sw, n_real, eta, alpha, beta,
                 key, epoch):
        n_pad = u.shape[0]
        nb = n_pad // batch_size
        kperm, ksamp = jax.random.split(jax.random.fold_in(key, epoch))
        perm = jax.random.permutation(kperm, n_pad)
        valid = perm < n_real
        ub = u[perm].reshape(nb, batch_size)
        ib = i[perm].reshape(nb, batch_size)
        swb = sw[perm].reshape(nb, batch_size)
        vb = valid.reshape(nb, batch_size)

        def body(carry, xs):
            wc = carry
            ub_, ib_, swb_, vb_, t = xs
            wc, ll = step(
                wc, x_uf, x_if, hist,
                ub_, ib_, swb_, vb_, eta, alpha, beta,
                jax.random.fold_in(ksamp, t),
            )
            return wc, ll

        w, lls = jax.lax.scan(body, w, (ub, ib, swb, vb, jnp.arange(nb)))
        return w, jnp.sum(lls)

    return epoch_fn
