"""Training-dispatch planner: every fit-time regime decision as ONE pure
function over plain scalars, directly unit-testable.

`plan_fit` maps a `FitSpec` to a `FitPlan` with no side effects and no
device access; `tests/test_planner.py` enumerates the regime matrix against
it. The decision rules:

* windowed negatives (`ops/training.make_window_train_step`) from 3 through
  8 window blocks, reference-style candidate draws outside that band;
* data-parallel placement (replicated tables, one delta-psum per sync
  group) whenever the weight pytree fits the per-device budget the caller
  passes in (`FitSpec.dp_budget`), explicit table-parallel otherwise
  (`parallel/train.uses_dp`);
* batch size capped for synchronous-update stability;
* candidate-step sampling fidelity (post-hoc rejection, redraw rounds) from
  the history density.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from rankfm_tpu.ops.window import num_blocks
from rankfm_tpu.parallel.train import DP_TABLE_BYTES, uses_dp


def _next_pow2(n):
    return 1 << max(0, (int(n) - 1).bit_length())


@dataclass(frozen=True)
class FitSpec:
    """Everything `plan_fit` is allowed to look at: data shapes, history
    density and the constructor knobs. All plain scalars (plus the optional
    mesh, of which only the shape is read)."""

    n: int                    # interaction rows in THIS fit call
    num_users: int
    num_items: int
    factors: int
    loss: str                 # 'bpr' | 'warp'
    max_samples: int
    epochs: int
    x_uf_any: bool = False
    x_if_any: bool = False
    num_uf: int = 1           # feature matrix column counts
    num_if: int = 1
    nnz_hist: int = 0         # total distinct (u, i) history pairs
    mean_sample_weight: float = 1.0
    mesh: object = None       # jax.sharding.Mesh | None
    table_bytes: int = 0      # weight pytree bytes (DP-vs-TP input)
    # bytes a replicated pytree may take per device: `fit` passes
    # `parallel/train.dp_table_budget(mesh)`
    dp_budget: int = DP_TABLE_BYTES
    # knobs (RankFM constructor extras)
    batch_size: Optional[int] = None
    train_step: str = "auto"
    sample_rounds: object = "auto"


@dataclass(frozen=True)
class FitPlan:
    """The resolved dispatch: which step runs the epochs, at what batch,
    placed how. Consumed by `RankFM.fit_partial`."""

    max_samples: int          # 1 for BPR (`rankfm.py:294-297`)
    n_dev: int                # devices on the mesh (1 when mesh is None)
    nblk: int                 # catalog window blocks (regime selector)
    batch_size: int
    step_kind: str            # 'window' | 'candidate'
    placement: str            # 'single' | 'dp' | 'tp'
    rounds: int               # candidate-step rejection redraw rounds
    post_reject: bool         # post-hoc membership testing (sparse regime)


# candidate-step sampling strategy switch: below this history density the
# step tests membership of only the SELECTED negative post-hoc (with
# re-select rounds) instead of pre-filtering every draw — the reference's
# in-place redraw (`_rankfm.pyx:249-252`) at ~density^rounds residual-
# pollution fidelity, without any [B, M] membership gather.
POST_REJECT_DENSITY = 0.02


def _mesh_devices(mesh):
    n = 1
    if mesh is not None:
        for v in mesh.shape.values():
            n *= v
    return n


def _auto_batch_size(spec):
    """Auto minibatch size.

    Synchronous batches lose the sequential SGD's self-stabilizing
    feedback: if an item row is touched k times in one batch, the k
    correlated gradients apply at the SAME weights and can overshoot
    (k ~ 2B/I for uniform negatives; sample weights scale the step).
    Cap expected touches-per-item at ~4 / mean_sw^2 — empirically the
    stability boundary on small catalogs, while leaving large-catalog
    configs (e.g. ML-1M at B=8192) untouched."""
    if spec.batch_size is not None:
        return spec.batch_size
    num_items = max(spec.num_items, 1)
    mean_sw = max(float(spec.mean_sample_weight), 0.0)
    stable_cap = max(256, _next_pow2(int(2 * num_items / max(mean_sw, 1.0) ** 2)))
    return min(8192, _next_pow2(max(spec.n, 1)), stable_cap)


def plan_fit(spec: FitSpec) -> FitPlan:
    """Resolve the full training dispatch for one `fit_partial` call."""
    # BPR = WARP with max_samples=1 (`rankfm.py:294-297`)
    if spec.loss == "bpr":
        max_samples = 1
    elif spec.loss == "warp":
        max_samples = spec.max_samples
    else:
        raise ValueError("[loss] function not recognized")

    U, I = spec.num_users, spec.num_items
    n_dev = _mesh_devices(spec.mesh)
    nblk = num_blocks(I)

    bs = _auto_batch_size(spec)
    if spec.mesh is not None:
        # every sharded batch axis (DP shard_map AND the GSPMD path's
        # in_shardings) needs the padded row count to divide the device
        # count — round the batch up so n_pad inherits the property
        bs = ((bs + n_dev - 1) // n_dev) * n_dev

    # windowed negatives are at metric parity with reference-style
    # candidate draws from 3 through ~8 window blocks; beyond that the
    # candidate step's catalog-wide sampling wins, and at <= 2 blocks the
    # candidate step's full [B, I] score matmul costs the same as a window
    # while the window path shows a fat left quality tail
    if spec.train_step == "auto":
        step_kind = "window" if 2 < nblk <= 8 else "candidate"
    else:
        step_kind = spec.train_step

    density = spec.nnz_hist / max(U * I, 1)
    post_reject = density < POST_REJECT_DENSITY
    if spec.sample_rounds == "auto":
        # smallest R with residual member-slot probability density^R < 1e-6
        # (residual slots are MASKED out of the loss, so this is a coverage
        # knob, not a correctness one); each round costs a [B, M]
        # membership pass
        rounds = int(np.clip(np.ceil(
            -6.0 / np.log10(np.clip(density, 1e-12, 0.99))), 2, 8))
    else:
        rounds = int(spec.sample_rounds)

    placement = "single"
    if spec.mesh is not None:
        placement = "dp" if uses_dp(spec.mesh, bs, spec.table_bytes,
                                    spec.dp_budget) else "tp"

    return FitPlan(
        max_samples=max_samples, n_dev=n_dev, nblk=nblk, batch_size=bs,
        step_kind=step_kind, placement=placement, rounds=rounds,
        post_reject=post_reject,
    )
