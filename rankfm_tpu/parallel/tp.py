"""Explicit table-parallel (TP) training: row-sharded embedding tables with
owner-shard gather/scatter exchange — the EP-style "embedding parallelism"
of SURVEY.md §2.6 for weight pytrees too large to replicate per chip.

The GSPMD lowering of the candidate step against row-sharded tables picks
pathological schedules (measured +995% partition overhead on the CPU mesh —
per-gather exchanges, serialized scatters). This module expresses the same
step with explicit collectives instead:

* **tables** (``v_u``/``v_i``/``w_i`` and the feature matrices) are
  row-sharded over the ``model`` axis, padded to even shards; the small
  dense feature weights replicate;
* **batch** shards over ``data`` and replicates over ``model``;
* **lookups** are owner-masked local gathers + ONE ``psum`` over ``model``
  per lookup group (the all-to-all exchange, in its all-reduce form: a
  non-owner contributes zeros). One [Bd, F] exchange for user rows, one
  [Bd*(M+1), ...] exchange for the positive + candidate item rows;
* **selection and update math** run replicated across ``model`` (identical
  inputs after the gathers → identical results, zero communication; the
  per-row FLOPs are negligible next to table bandwidth in this regime);
* **updates**: the selected-pair payloads ride ONE ``all_gather`` over
  ``data`` (O(B*F), never table-sized), then every shard applies the
  global updates to the rows it owns with the same geometric per-touch
  decay as the single-chip step (`ops/training._decay_apply`); dense
  feature-weight gradients, weighted by touch order over the whole batch
  (`ops/training._ordered_feature_grads`), are psum-reduced over ``data``.

Negative sampling uses the CSR sampler (offsets/flat replicate — they are
interaction-sized, not catalog-sized); the PRNG folds in the data-shard
index so shards draw independent candidates while ``model`` replicas stay
bit-identical.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from rankfm_tpu.ops.negatives import csr_member, sample_negatives
from rankfm_tpu.ops.training import (
    MARGIN, _decay_apply, _decay_factor, _ordered_decay_apply,
    _ordered_feature_grads)
from rankfm_tpu.parallel.train import _MeshKey

ROW_SHARDED = ("w_i", "v_i", "v_u")


def _pad_rows(n, shards):
    return -(-n // shards) * shards


def pad_and_place(mesh, w, x_uf, x_if):
    """Pad the row tables to even ``model`` shards and device_put with the
    TP layout. Returns ``(w_tp, x_uf_tp, x_if_tp)``; pad rows are zeros (a
    zero row scores 0 and receives no updates — indices never point at it).
    """
    m = mesh.shape["model"]
    row_sh = NamedSharding(mesh, P("model"))
    mat_sh = NamedSharding(mesh, P("model", None))
    rep = NamedSharding(mesh, P())

    def pad(a, rows):
        a = np.asarray(a)
        return np.pad(a, ((0, rows - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))

    U_pad = _pad_rows(w["v_u"].shape[0], m)
    I_pad = _pad_rows(w["v_i"].shape[0], m)
    w_tp = {
        "w_i": jax.device_put(pad(w["w_i"], I_pad), row_sh),
        "v_i": jax.device_put(pad(w["v_i"], I_pad), mat_sh),
        "v_u": jax.device_put(pad(w["v_u"], U_pad), mat_sh),
        "w_if": jax.device_put(np.asarray(w["w_if"]), rep),
        "v_uf": jax.device_put(np.asarray(w["v_uf"]), rep),
        "v_if": jax.device_put(np.asarray(w["v_if"]), rep),
    }
    x_uf_tp = jax.device_put(pad(x_uf, U_pad), mat_sh)
    x_if_tp = jax.device_put(pad(x_if, I_pad), mat_sh)
    return w_tp, x_uf_tp, x_if_tp


def extract(w_tp, num_users, num_items):
    """Slice the padding back off (global views of the sharded tables)."""
    return {
        "w_i": w_tp["w_i"][:num_items],
        "v_i": w_tp["v_i"][:num_items],
        "v_u": w_tp["v_u"][:num_users],
        "w_if": w_tp["w_if"],
        "v_uf": w_tp["v_uf"],
        "v_if": w_tp["v_if"],
    }


def _tp_apply_updates(w, m_idx, D, x_uf_any, x_if_any, u, i, j, d, row_ok,
                      v_u_b, user_rep_b, x_uf_b, v_i_pos, v_i_j, x_if_pos,
                      x_if_j, feat_rep_pos, feat_rep_j, eta, alpha, beta):
    """Shared TP update block (candidate AND window steps): dense
    feature-weight grads are local einsums psum-reduced over ``data``; the
    selected-pair payloads ride ONE ``all_gather`` over ``data`` (O(B*F),
    never table-sized) and every shard applies the rows it owns with the
    same geometric per-touch decay as the single-chip step."""
    d_col = d[:, None]

    def ranks(touch):
        """touches by the rows of earlier data shards, and by the whole
        batch: the batch's row order is the shards' rows in turn"""
        if D == 1:
            return 0.0, None
        counts = jax.lax.all_gather(jnp.sum(touch, axis=0), "data")
        before = jnp.arange(D)[:, None] < jax.lax.axis_index("data")
        return (jnp.sum(jnp.where(before, counts, 0.0), axis=0),
                jnp.sum(counts, axis=0))

    c_f = _decay_factor(eta, beta)
    g_w_if, g_v_uf, g_v_if, k_w_if, k_v_uf, k_v_if = _ordered_feature_grads(
        d, row_ok, x_uf_b, x_if_pos - x_if_j, v_i_pos - v_i_j, v_u_b, c_f,
        ranks)
    if D > 1:
        g_w_if, g_v_uf, g_v_if, k_w_if, k_v_if, k_v_uf = jax.lax.psum(
            (g_w_if, g_v_uf, g_v_if, k_w_if, k_v_if, k_v_uf), "data")
    if not x_if_any:
        k_w_if, k_v_if = jnp.zeros_like(k_w_if), jnp.zeros_like(k_v_if)
    if not x_uf_any:
        k_v_uf = jnp.zeros_like(k_v_uf)

    g_u_rows = d_col * ((v_i_pos - v_i_j) + (feat_rep_pos - feat_rep_j))
    gi_rows = d_col * user_rep_b
    if D > 1:
        ag = lambda a: jax.lax.all_gather(a, "data", tiled=True)
        u_g, i_g, j_g, d_g, ok_g = map(ag, (u, i, j, d, row_ok))
        g_u_rows_g, gi_rows_g = ag(g_u_rows), ag(gi_rows)
    else:
        u_g, i_g, j_g, d_g, ok_g = u, i, j, d, row_ok
        g_u_rows_g, gi_rows_g = g_u_rows, gi_rows

    def local_scatter(rows, idx, vals):
        local = idx - m_idx * rows.shape[0]
        ok = (local >= 0) & (local < rows.shape[0])
        safe = jnp.where(ok, local, 0)
        mask = ok[..., None] if vals.ndim > idx.ndim else ok
        return rows.at[safe].add(jnp.where(mask, vals, 0))

    zero_i = jnp.zeros_like(w["w_i"])
    g_w_i = local_scatter(local_scatter(zero_i, i_g, d_g), j_g, -d_g)
    k_i = local_scatter(local_scatter(zero_i, i_g, ok_g), j_g, ok_g)
    g_v_i = local_scatter(
        local_scatter(jnp.zeros_like(w["v_i"]), i_g, gi_rows_g),
        j_g, -gi_rows_g)
    g_v_u = local_scatter(jnp.zeros_like(w["v_u"]), u_g, g_u_rows_g)
    k_u = local_scatter(jnp.zeros(w["v_u"].shape[0], jnp.float32),
                        u_g, ok_g)

    return {
        "w_i": _decay_apply(w["w_i"], g_w_i, k_i, eta, alpha),
        "v_i": _decay_apply(w["v_i"], g_v_i, k_i, eta, alpha),
        "v_u": _decay_apply(w["v_u"], g_v_u, k_u, eta, alpha),
        "w_if": _ordered_decay_apply(w["w_if"], g_w_if, k_w_if, eta, c_f),
        "v_uf": _ordered_decay_apply(w["v_uf"], g_v_uf, k_v_uf, eta, c_f),
        "v_if": _ordered_decay_apply(w["v_if"], g_v_if, k_v_if, eta, c_f),
    }


def _make_tp_step(mesh, num_items, max_samples, x_uf_any, x_if_any,
                  sample_rounds, max_row_len, post_reject):
    """Per-device body (run under shard_map) for one TP training batch."""
    M = max_samples
    log_I = math.log(num_items) if num_items > 1 else 1.0
    D = mesh.shape["data"]

    def step(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta, key):
        m_idx = jax.lax.axis_index("model")
        if D > 1:
            # independent candidate streams per data shard; model replicas
            # of the same data shard stay bit-identical (no model fold)
            key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        B = u.shape[0]
        RU = w["v_u"].shape[0]
        RI = w["v_i"].shape[0]

        def owner_gather(shard, idx, rows):
            """rows this shard owns, zeros elsewhere; psum = the exchange"""
            local = idx - m_idx * rows
            ok = (local >= 0) & (local < rows)
            safe = jnp.where(ok, local, 0)
            v = shard[safe]
            mask = ok[..., None] if v.ndim > idx.ndim else ok
            return jax.lax.psum(jnp.where(mask, v, 0), "model")

        # ---- candidates (CSR sampler on replicated offsets/flat) ----
        if post_reject and M > 1:
            cands = jax.random.randint(key, (B, M), 0, num_items, jnp.int32)
            cand_ok = jnp.ones((B, M), bool)
        else:
            cands, cand_ok = sample_negatives(
                key, u, hist["offsets"], hist["flat"], num_items, M,
                rounds=sample_rounds, max_row_len=max_row_len)

        # ---- owner-gathers: user rows, then positive+candidate item rows
        # (one exchange per table touch group) ----
        v_u_b = owner_gather(w["v_u"], u, RU)                  # [B, F]
        x_uf_b = owner_gather(x_uf, u, RU) if x_uf_any \
            else jnp.zeros((B, x_uf.shape[1]), x_uf.dtype)
        user_rep_b = v_u_b + jnp.dot(x_uf_b, w["v_uf"],
                                     preferred_element_type=jnp.float32)

        idx_items = jnp.concatenate([i[:, None], cands], axis=1).reshape(-1)
        v_i_rows = owner_gather(w["v_i"], idx_items, RI)       # [B*(M+1), F]
        w_i_rows = owner_gather(w["w_i"], idx_items, RI)       # [B*(M+1)]
        if x_if_any:
            x_if_rows = owner_gather(x_if, idx_items, RI)      # [B*(M+1), Q]
            feat_rows = jnp.dot(x_if_rows, w["v_if"],
                                preferred_element_type=jnp.float32)
            bias_rows = w_i_rows + jnp.dot(
                x_if_rows, w["w_if"], preferred_element_type=jnp.float32)
        else:
            x_if_rows = jnp.zeros((idx_items.shape[0], x_if.shape[1]),
                                  x_if.dtype)
            feat_rows = jnp.zeros_like(v_i_rows)
            bias_rows = w_i_rows

        if x_uf_any or x_if_any:
            u_mat = jnp.concatenate([user_rep_b, v_u_b], axis=-1)
            i_rows_mat = jnp.concatenate([v_i_rows, feat_rows], axis=-1)
        else:
            u_mat = v_u_b
            i_rows_mat = v_i_rows
        scores = (jnp.sum(
            jnp.repeat(u_mat, M + 1, axis=0) * i_rows_mat, axis=-1)
            + bias_rows).reshape(B, M + 1)
        ut_ui = scores[:, 0]
        ut_uj = scores[:, 1:]

        # ---- WARP selection (same closed form as make_train_step) ----
        pairwise = ut_ui[:, None] - ut_uj
        pairwise = jnp.where(cand_ok, pairwise, jnp.inf)

        def select(pw_mat, ok_mat):
            viol = pw_mat < MARGIN
            any_viol = jnp.any(viol, axis=-1)
            first_viol = jnp.argmax(viol, axis=-1)
            sel = jnp.where(any_viol, first_viol,
                            jnp.argmin(pw_mat, axis=-1))
            sampled = jnp.where(any_viol, first_viol + 1, M).astype(jnp.int32)
            take = lambda a: jnp.take_along_axis(a, sel[:, None], axis=1)[:, 0]
            return sel, sampled, take(cands), take(pw_mat), take(ok_mat)

        sel, sampled, j, pw, ok_sel = select(pairwise, cand_ok)
        if post_reject and M > 1:
            for _ in range(2):
                is_mem = csr_member(hist["flat"], hist["offsets"], u, j,
                                    max_row_len)
                pairwise = jnp.where(
                    is_mem[:, None]
                    & (jnp.arange(M)[None, :] == sel[:, None]),
                    jnp.inf, pairwise)
                sel, sampled, j, pw, ok_sel = select(pairwise, cand_ok)
            ok_sel = ok_sel & ~csr_member(hist["flat"], hist["offsets"], u, j,
                                          max_row_len)
        row_ok = (valid & ok_sel & jnp.isfinite(pw)).astype(jnp.float32)

        ratio = jnp.maximum((num_items - 1) // sampled, 1).astype(jnp.float32)
        multiplier = jnp.log(ratio) / log_I
        pw_safe = jnp.where(jnp.isfinite(pw), pw, 0.0)
        d = row_ok * sw * multiplier * jax.nn.sigmoid(-pw_safe)
        ll = jax.lax.psum(
            jnp.sum(row_ok * jax.nn.log_sigmoid(pw_safe)),
            "data") if D > 1 else jnp.sum(row_ok * jax.nn.log_sigmoid(pw_safe))

        # ---- selected-pair rows (already gathered: slice them back out) --
        grid = jnp.arange(B) * (M + 1)
        v_i_pos = v_i_rows[grid]
        feat_rep_pos = feat_rows[grid]
        x_if_pos = x_if_rows[grid]
        sel_flat = grid + 1 + sel
        v_i_j = v_i_rows[sel_flat]
        feat_rep_j = feat_rows[sel_flat]
        x_if_j = x_if_rows[sel_flat]

        # ---- gradients + decayed owner-shard updates (shared helper) ----
        new_w = _tp_apply_updates(
            w, m_idx, D, x_uf_any, x_if_any, u, i, j, d, row_ok,
            v_u_b, user_rep_b, x_uf_b, v_i_pos, v_i_j, x_if_pos, x_if_j,
            feat_rep_pos, feat_rep_j, eta, alpha, beta)
        return new_w, ll

    return step


def _make_tp_window_step(mesh, num_items, max_samples, x_uf_any, x_if_any):
    """Window-WARP training step over row-sharded tables — the TP twin of
    `ops.training.make_window_train_step` (same `window_warp_select`
    semantics), so giant-table meshes no longer pay the candidate step's
    per-row gather cost on window-sized catalogs.

    Exchanges per batch (all O(batch)- or O(window)-sized, never
    table-sized): one psum-gather of the batch's user rows + packed history
    rows, one psum-gather of G window row-blocks ([G*BLK, F]), one
    psum-gather of the positive rows, then the shared payload all_gather
    over ``data`` for the owner-shard updates. ``hist`` is
    ``{'packed': [RU, W] int32}`` row-sharded over ``model``
    (`pad_packed_hist`)."""
    from rankfm_tpu.ops.window import (
        BITS_PER_LANE, block_size, draw_window_blocks, window_block_cdf)
    from rankfm_tpu.ops.training import pick_window_groups, window_warp_select

    M = max_samples
    log_I = math.log(num_items) if num_items > 1 else 1.0
    BLK = block_size(num_items)
    LW = BLK // BITS_PER_LANE
    lg_lw = LW.bit_length() - 1
    real_cum = window_block_cdf(num_items)
    D = mesh.shape["data"]

    def step(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta, key):
        m_idx = jax.lax.axis_index("model")
        if D > 1:
            key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        B = u.shape[0]
        RU = w["v_u"].shape[0]
        RI = w["v_i"].shape[0]
        G = pick_window_groups(B)
        Bg = B // G
        kblk, kcand, kgeo = jax.random.split(key, 3)
        blkg = draw_window_blocks(kblk, (G,), num_items, real_cum)

        def owner_gather(shard, idx, rows):
            local = idx - m_idx * rows
            ok = (local >= 0) & (local < rows)
            safe = jnp.where(ok, local, 0)
            v = shard[safe]
            mask = ok[..., None] if v.ndim > idx.ndim else ok
            return jax.lax.psum(jnp.where(mask, v, 0), "model")

        # ---- batch user rows + their packed history rows (ONE exchange
        # each; the history words are int32 — psum adds exact zeros) ----
        v_u_b = owner_gather(w["v_u"], u, RU)                   # [B, F]
        rows_full = owner_gather(hist["packed"], u, RU)         # [B, W]
        x_uf_b = owner_gather(x_uf, u, RU) if x_uf_any \
            else jnp.zeros((B, x_uf.shape[1]), x_uf.dtype)
        user_rep_b = v_u_b + jnp.dot(x_uf_b, w["v_uf"],
                                     preferred_element_type=jnp.float32)

        # ---- selection SHARDS over the model axis whenever the group
        # count allows: every [*, BLK]-wide quantity (membership bits,
        # window scores, WARP selection) is computed for this shard's
        # contiguous 1/m of the groups only, and the per-row outcomes
        # (jloc/sampled/has_j — O(B) ints) ride ONE all_gather back.
        # Replicating that math across model would repeat the same
        # [*, BLK]-wide work on every model shard.
        msz = mesh.shape["model"]
        split = msz > 1 and G % msz == 0
        Gs = G // msz if split else G

        def shard_rows(a):
            return jax.lax.dynamic_slice_in_dim(
                a, m_idx * (Gs * Bg), Gs * Bg, 0) if split else a

        def shard_groups(a):
            return jax.lax.dynamic_slice_in_dim(
                a, m_idx * Gs, Gs, 0) if split else a

        blkg_s = shard_groups(blkg)
        rf3 = shard_rows(rows_full).reshape(Gs, Bg, -1)
        rows = jax.vmap(lambda rf, b: jax.lax.dynamic_slice_in_dim(
            rf, b * LW, LW, axis=1))(rf3, blkg_s)               # [Gs, Bg, LW]
        col = jnp.arange(BLK, dtype=jnp.int32)[None, None, :]
        bits = jnp.tile(rows, (1, 1, BITS_PER_LANE))            # [Gs, Bg, BLK]
        nonmem = ((bits >> (col >> lg_lw)) & 1) == 0

        # ---- window item rows: ONE [G*BLK]-row exchange (indices past the
        # catalog resolve to zero rows owned by nobody; the history pack
        # marks pad items as members so they are never selected) ----
        win_idx = (blkg[:, None] * BLK
                   + jnp.arange(BLK, dtype=jnp.int32)[None, :]).reshape(-1)
        v_i_win = owner_gather(w["v_i"], win_idx, RI)           # [G*BLK, F]
        w_i_win = owner_gather(w["w_i"], win_idx, RI)           # [G*BLK]
        if x_if_any:
            x_if_win = owner_gather(x_if, win_idx, RI)          # [G*BLK, Q]
            feat_win = jnp.dot(x_if_win, w["v_if"],
                               preferred_element_type=jnp.float32)
            bias_win = w_i_win + jnp.dot(x_if_win, w["w_if"],
                                         preferred_element_type=jnp.float32)
        else:
            x_if_win = jnp.zeros((win_idx.shape[0], x_if.shape[1]),
                                 x_if.dtype)
            feat_win = jnp.zeros_like(v_i_win)
            bias_win = w_i_win

        # ---- positive rows (one [B]-row exchange) + scoring ----
        v_i_pos = owner_gather(w["v_i"], i, RI)                 # [B, F]
        w_i_pos = owner_gather(w["w_i"], i, RI)
        if x_if_any:
            x_if_pos = owner_gather(x_if, i, RI)
            feat_rep_pos = jnp.dot(x_if_pos, w["v_if"],
                                   preferred_element_type=jnp.float32)
            bias_pos = w_i_pos + jnp.dot(x_if_pos, w["w_if"],
                                         preferred_element_type=jnp.float32)
        else:
            x_if_pos = jnp.zeros((B, x_if.shape[1]), x_if.dtype)
            feat_rep_pos = jnp.zeros_like(v_i_pos)
            bias_pos = w_i_pos

        if x_uf_any or x_if_any:
            u_mat = jnp.concatenate([user_rep_b, v_u_b], axis=-1)
            i_pos_mat = jnp.concatenate([v_i_pos, feat_rep_pos], axis=-1)
            i_win_mat = jnp.concatenate([v_i_win, feat_win], axis=-1)
        else:
            u_mat = v_u_b
            i_pos_mat = v_i_pos
            i_win_mat = v_i_win
        ut_ui = jnp.sum(u_mat * i_pos_mat, axis=-1) + bias_pos  # [B]
        scores_win = (
            jnp.einsum("gbf,gwf->gbw",
                       shard_rows(u_mat).reshape(Gs, Bg, -1)
                       .astype(jnp.bfloat16),
                       shard_groups(i_win_mat.reshape(G, BLK, -1))
                       .astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
            + shard_groups(bias_win.reshape(G, 1, BLK))
        )                                                       # [Gs, Bg, BLK]
        pw = shard_rows(ut_ui).reshape(Gs, Bg)[:, :, None] - scores_win

        # ---- WARP selection (shared helper).
        # Per-shard PRNG fold so two shards' groups never share the same
        # uniforms; the per-row outcomes all_gather back in group order
        # (each shard owns a CONTIGUOUS group range, and rows are laid out
        # group-major, so tiled concatenation restores batch order). ----
        if split:
            kc = jax.random.fold_in(kcand, m_idx)
            kg = jax.random.fold_in(kgeo, m_idx)
        else:
            kc, kg = kcand, kgeo
        jloc, sampled, has_j = window_warp_select(pw, nonmem, kc, kg, M)
        if split:
            jloc = jax.lax.all_gather(jloc, "model", tiled=True)
            sampled = jax.lax.all_gather(sampled, "model", tiled=True)
            has_j = jax.lax.all_gather(has_j, "model", tiled=True)
        j = (blkg[:, None] * BLK + jloc).reshape(B).astype(jnp.int32)
        j = jnp.minimum(j, num_items - 1)  # only reachable when has_j=False
        row_ok = (valid & has_j).astype(jnp.float32)

        # selected-j rows: slice back out of the gathered window rows
        # (no second table exchange)
        flat_sel = (jnp.arange(G, dtype=jnp.int32)[:, None] * BLK
                    + jloc).reshape(B)
        v_i_j = v_i_win[flat_sel]
        x_if_j = x_if_win[flat_sel]
        feat_rep_j = feat_win[flat_sel]
        bias_j = bias_win[flat_sel]
        if x_uf_any or x_if_any:
            j_mat = jnp.concatenate([v_i_j, feat_rep_j], axis=-1)
        else:
            j_mat = v_i_j
        # exact pointwise recompute at the selected j (f32)
        ut_uj = jnp.sum(u_mat * j_mat, axis=-1) + bias_j
        pw_sel = ut_ui - ut_uj

        ratio = jnp.maximum((num_items - 1) // sampled, 1).astype(jnp.float32)
        multiplier = jnp.log(ratio) / log_I
        d = row_ok * sw * multiplier * jax.nn.sigmoid(-pw_sel)
        ll_loc = jnp.sum(row_ok * jax.nn.log_sigmoid(pw_sel))
        ll = jax.lax.psum(ll_loc, "data") if D > 1 else ll_loc

        new_w = _tp_apply_updates(
            w, m_idx, D, x_uf_any, x_if_any, u, i, j, d, row_ok,
            v_u_b, user_rep_b, x_uf_b, v_i_pos, v_i_j, x_if_pos, x_if_j,
            feat_rep_pos, feat_rep_j, eta, alpha, beta)
        return new_w, ll

    return step


def pad_packed_hist(mesh, packed, num_users):
    """Row-shard the blocked history pack over ``model`` (pad rows are
    zeros — pad users never appear in a batch)."""
    m = mesh.shape["model"]
    arr = np.asarray(packed)
    RU = _pad_rows(num_users, m)
    arr = np.pad(arr, ((0, RU - arr.shape[0]), (0, 0)))
    return jax.device_put(arr, NamedSharding(mesh, P("model", None)))


@lru_cache(maxsize=16)
def make_tp_epoch_fn(mesh_key, num_items, max_samples, x_uf_any, x_if_any,
                     batch_size, sample_rounds=8, max_row_len=None,
                     post_reject=False, step_kind="candidate"):
    """Whole-epoch TP training compiled over the mesh.

    Same signature as `rankfm_tpu.ops.training.make_epoch_fn`'s product,
    except ``w``/``x_uf``/``x_if`` must be the padded row-sharded pytree
    from `pad_and_place`. ``hist`` is the replicated CSR dict for the
    candidate step, or ``{'packed': pad_packed_hist(...)}`` (row-sharded
    over ``model``) for the window step. Pass a `_MeshKey`-wrapped mesh
    (hashable) or use `tp_epoch_fn`."""
    mesh = mesh_key.mesh
    D = mesh.shape["data"]
    assert batch_size % D == 0, (batch_size, D)
    if step_kind == "window":
        step = _make_tp_window_step(mesh, num_items, max_samples,
                                    x_uf_any, x_if_any)
    else:
        step = _make_tp_step(mesh, num_items, max_samples, x_uf_any,
                             x_if_any, sample_rounds, max_row_len,
                             post_reject)

    rep = P()
    row = P("model")
    mat = P("model", None)
    bsh = P("data")
    w_specs = {"w_i": row, "v_i": mat, "v_u": mat,
               "w_if": rep, "v_uf": rep, "v_if": rep}
    if step_kind == "window":
        hist_specs = {"packed": mat}
    else:
        hist_specs = {"offsets": rep, "flat": rep, "bitmap": rep}
    sharded_step = jax.shard_map(
        step, mesh=mesh,
        in_specs=(w_specs, mat, mat, hist_specs,
                  bsh, bsh, bsh, bsh, rep, rep, rep, rep),
        out_specs=(w_specs, rep),
        check_vma=False)

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
            wc, ll = sharded_step(wc, x_uf, x_if, hist, ub_, ib_, swb_, vb_,
                                  eta, alpha, beta,
                                  jax.random.fold_in(ksamp, t))
            return wc, ll

        w, lls = jax.lax.scan(body, w, (ub, ib, swb, vb, jnp.arange(nb)))
        return w, jnp.sum(lls)

    ws_sh = {k: NamedSharding(mesh, v) for k, v in w_specs.items()}
    mat_sh = NamedSharding(mesh, P("model", None))
    rep_sh = NamedSharding(mesh, P())
    hist_sh = {k: (mat_sh if v == mat else rep_sh)
               for k, v in hist_specs.items()}
    # dynamic args (n_real is static): w, x_uf, x_if, hist, u, i, sw,
    # eta, alpha, beta, key, epoch
    in_sh = (ws_sh, mat_sh, mat_sh, hist_sh,
             rep_sh, rep_sh, rep_sh,
             rep_sh, rep_sh, rep_sh, rep_sh, rep_sh)
    return jax.jit(epoch_fn, static_argnums=(7,), donate_argnums=(0,),
                   in_shardings=in_sh, out_shardings=(ws_sh, rep_sh))


def tp_epoch_fn(mesh, num_items, max_samples, x_uf_any, x_if_any, batch_size,
                sample_rounds=8, max_row_len=None, post_reject=False,
                step_kind="candidate"):
    """Cached accessor (meshes aren't hashable; `_MeshKey` wraps them)."""
    return make_tp_epoch_fn(_MeshKey(mesh), num_items, max_samples,
                            bool(x_uf_any), bool(x_if_any), batch_size,
                            sample_rounds, max_row_len, bool(post_reject),
                            step_kind)
