"""Direct unit tests of the training-dispatch planner: the regime matrix —
catalog size band x loss x mesh placement x knobs — pinned against
`plan_fit` as a pure function, no devices, no fitting.

Regime bands (window blocks of the catalog, `ops/window.num_blocks`):
  <= 2 blocks  : tiny catalogs (candidate step)
  3..8 blocks  : ML-1M class (window step)
  9..64 blocks : Instacart class (candidate step)
  > 64 blocks  : web-scale (candidate step)
"""

import types

import numpy as np
import pytest

from rankfm_tpu.models.planner import FitSpec, FitPlan, plan_fit
from rankfm_tpu.ops.window import num_blocks


def spec(num_items=3706, num_users=6040, n=749_724, factors=20,
         loss="warp", max_samples=20, epochs=20, **kw):
    return FitSpec(n=n, num_users=num_users, num_items=num_items,
                   factors=factors, loss=loss, max_samples=max_samples,
                   epochs=epochs, **kw)


# ---- catalog-band x loss matrix (single device) ----

BANDS = {
    # name: (users, items, rows, factors, max_samples, blocks, step)
    "tiny": (2400, 1200, 90_000, 16, 10, (1, 2), "candidate"),
    "ml1m": (6040, 3706, 749_724, 20, 20, (3, 8), "window"),
    "instacart": (10_000, 33_362, 518_000, 50, 50, (9, 64), "candidate"),
    "webscale": (100_000, 1_000_000, 5_000_000, 64, 10, (65, 10**6),
                 "candidate"),
}


@pytest.mark.parametrize("loss", ["bpr", "warp"])
@pytest.mark.parametrize("band", sorted(BANDS))
def test_regime_matrix(band, loss):
    U, I, n, F, ms, (lo, hi), step = BANDS[band]
    p = plan_fit(spec(num_items=I, num_users=U, n=n, factors=F,
                      max_samples=ms, loss=loss,
                      nnz_hist=int(0.9 * n)))
    assert lo <= p.nblk <= hi and p.nblk == num_blocks(I)
    assert p.step_kind == step
    assert p.max_samples == (1 if loss == "bpr" else ms)
    assert p.placement == "single" and p.n_dev == 1
    # auto batch: a power of two, at most 8192, and 2*I/mean_sw^2-capped
    assert p.batch_size & (p.batch_size - 1) == 0
    assert 256 <= p.batch_size <= 8192
    assert 2 <= p.rounds <= 8


def test_webscale_band_falls_back_to_candidate_step():
    s = spec(num_items=1_000_000, num_users=100_000, n=5_000_000,
             factors=64, max_samples=10)
    assert num_blocks(1_000_000) > 64
    p = plan_fit(s)
    assert p.step_kind == "candidate"
    assert p.batch_size == 8192


# ---- knob forcing ----

def test_train_step_forcing():
    assert plan_fit(spec(train_step="candidate")).step_kind == "candidate"
    assert plan_fit(spec(num_items=33_362,
                         train_step="window")).step_kind == "window"
    assert plan_fit(spec(train_step="auto")).step_kind == "window"


def test_bpr_resolves_max_samples_to_one_and_bad_loss_raises():
    assert plan_fit(spec(loss="bpr")).max_samples == 1
    assert plan_fit(spec(loss="warp")).max_samples == 20
    with pytest.raises(ValueError):
        plan_fit(spec(loss="hinge"))


def test_user_batch_size_respected():
    assert plan_fit(spec(batch_size=4096)).batch_size == 4096
    assert plan_fit(spec(batch_size=1000)).batch_size == 1000


def test_xla_batch_stability_cap_small_catalog():
    # 100-item catalog: expected touches-per-item cap binds (2*I -> 256)
    p = plan_fit(spec(num_items=100, num_users=500, n=100_000))
    assert p.batch_size == 256
    # heavy sample weights shrink the cap's numerator
    p2 = plan_fit(spec(num_items=4000, num_users=500, n=100_000,
                       mean_sample_weight=4.0))
    assert p2.batch_size <= 512


def test_sampling_fidelity_from_history_density():
    U, I = 6040, 3706
    sparse = plan_fit(spec(nnz_hist=int(0.005 * U * I)))
    assert sparse.post_reject and 2 <= sparse.rounds <= 3
    dense = plan_fit(spec(nnz_hist=int(0.5 * U * I)))
    assert not dense.post_reject and dense.rounds == 8
    forced = plan_fit(spec(nnz_hist=int(0.5 * U * I), sample_rounds=5))
    assert forced.rounds == 5


# ---- mesh placement (uses the 8-virtual-CPU-device conftest mesh) ----

def _mesh(shape, names):
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def test_mesh_small_tables_place_dp():
    mesh = _mesh((2, 4), ("data", "model"))
    p = plan_fit(spec(mesh=mesh, table_bytes=50 * 2**20))
    assert p.n_dev == 8 and p.placement == "dp"
    assert p.batch_size % 8 == 0


def test_mesh_giant_tables_place_tp():
    mesh = _mesh((2, 4), ("data", "model"))
    p = plan_fit(spec(mesh=mesh, table_bytes=300 * 2**20))
    assert p.placement == "tp"
    assert p.step_kind == "window"             # window-band catalog keeps it


# ---- the DP budget follows the device's memory ----

class _Dev:
    def __init__(self, limit):
        self._limit = limit

    def memory_stats(self):
        return None if self._limit is None else {"bytes_limit": self._limit}


def _fake_mesh(limits):
    devs = np.array([_Dev(x) for x in limits], dtype=object)
    return types.SimpleNamespace(devices=devs,
                                 shape={"data": len(limits), "model": 1})


@pytest.mark.parametrize("limits,budget", [
    # a card reporting 60 GB to the allocator: 1/8 of it
    ([60 * 2**30] * 4, 60 * 2**30 // 8),
    # the smallest device bounds the replicated pytree
    ([60 * 2**30, 20 * 2**30], 20 * 2**30 // 8),
    # no device reports memory (the CPU backend): the fixed fallback
    ([None, None], 256 * 2**20),
])
def test_uses_dp_follows_device_memory(limits, budget):
    from rankfm_tpu.parallel import train as ptrain
    mesh = _fake_mesh(limits)
    assert ptrain.dp_table_budget(mesh) == budget
    n = len(limits)
    assert ptrain.uses_dp(mesh, 8192, budget, budget)
    assert not ptrain.uses_dp(mesh, 8192, budget + 1, budget)
    # the batch must also deal evenly to the devices
    assert not ptrain.uses_dp(mesh, 8192 * n + 1, 0, budget)


@pytest.mark.parametrize("over", [0, 1], ids=["fits", "over"])
def test_plan_places_by_the_budget_it_is_given(over):
    """plan_fit reads the DP budget from its spec and no device: a mesh
    whose devices would refuse to report memory plans all the same"""
    class _NoStats:
        def memory_stats(self):
            raise AssertionError("plan_fit must not read device memory")

    mesh = types.SimpleNamespace(devices=np.array([_NoStats()] * 4),
                                 shape={"data": 4, "model": 1})
    budget = 3 * 2**30
    p = plan_fit(spec(mesh=mesh, table_bytes=budget + over,
                      dp_budget=budget))
    assert p.placement == ("tp" if over else "dp")


# ---- the plan is what fit_partial actually executes ----

def test_fit_exposes_plan_and_runs_it():
    from rankfm_tpu import RankFM
    rng = np.random.default_rng(0)
    inter = np.stack([rng.integers(0, 30, 400), rng.integers(0, 50, 400)], 1)
    m = RankFM(factors=4, loss="warp", max_samples=3, batch_size=128)
    m.fit(inter, epochs=2)
    p = m.last_fit_plan_
    assert isinstance(p, FitPlan)
    assert p.step_kind == "candidate"          # 50 items -> 1 block
    assert p.batch_size == 128 and p.placement == "single"
