"""The port's measured cost model (``topo/fit.py``) against the JAX
package's, in this process, pure Python.

The same seeded observations, fed to both packages' observation cells
(``record_observation``), give the same cells (``observed_cells``) and
bitwise-equal ``fit_link_params`` over a grid of topologies (one domain
and several; with latency-only, bandwidth-only and mixed ground truths
and seeded noise), the same refusals (underdetermined, non-physical),
the same ``refresh`` gating (``HVD_TPU_TOPO_FIT_MIN_OBS``,
``HVD_TPU_TOPO_FIT_REFIT_EVERY``), ``topo.fitted_*`` gauges and fit
epochs, and, once fitted, the same prices from ``Topology.estimate_cost``
and lowering choices from ``choose_lowering``; ``HVD_TPU_TOPO_FIT=off``
restores the static prices on both sides.  Both registries are saved and
restored around each test, and both packages' fits and topology
overrides reset.
"""

import copy
import random

import pytest

from horovod_tpu import metrics as jmetrics
from horovod_tpu.topo import fit as jfit
from horovod_tpu.topo import model as jmodel
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.topo import fit as tfit
from horovod_tpu_torch.topo import model as tmodel


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Both registries empty for the test (other tests of the worker may
    have recorded into them) and restored after it."""
    saved = []
    for m in (jmetrics, tmetrics):
        lock = getattr(m, "_counter_lock", None) or m._lock
        with lock:
            saved.append((dict(m._counters), dict(m._gauges),
                          copy.deepcopy(m._histograms)))
            m._counters.clear()
            m._gauges.clear()
            m._histograms.clear()
    for k in ("HVD_TPU_TOPO", "HVD_TPU_TOPO_FIT", "HVD_TPU_TOPO_FIT_MIN_OBS",
              "HVD_TPU_TOPO_FIT_REFIT_EVERY", "HVD_TPU_TOPO_LOWER"):
        monkeypatch.delenv(k, raising=False)
    jmodel.reset()
    tmodel.reset()
    yield
    jmodel.reset()
    tmodel.reset()
    for m, (c, g, h) in zip((jmetrics, tmetrics), saved):
        lock = getattr(m, "_counter_lock", None) or m._lock
        with lock:
            m._counters.clear()
            m._counters.update(c)
            m._gauges.clear()
            m._gauges.update(g)
            m._histograms.clear()
            m._histograms.update(h)


def _topos(shape, **kw):
    jt, tt = jmodel.Topology(*shape, **kw), tmodel.Topology(*shape, **kw)
    jmodel.set_topology_override(jt)
    tmodel.set_topology_override(tt)
    return jt, tt


# Ground truths in the fit's units: (overhead s, ici lat s, dcn lat s,
# ici GB/s, dcn GB/s).
TRUTHS = {
    "mixed": (30e-6, 2e-6, 40e-6, 300.0, 25.0),
    "latency": (80e-6, 5e-6, 90e-6, 1e4, 1e4),
    "bandwidth": (1e-6, 1e-7, 1e-7, 50.0, 5.0),
}
SHAPES = [(1, 8), (2, 4), (4, 2), (2, 2)]


def _observations(jt, truth, seed, lowerings):
    """Seeded (collective, lowering, nbytes, axis, seconds) records: the
    ground truth's ring-model price with multiplicative noise."""
    rng = random.Random(seed)
    truth_topo = jmodel.Topology(
        jt.num_slices, jt.slice_size, phase_overhead_s=truth[0],
        ici_latency_s=truth[1], dcn_latency_s=truth[2], ici_gbps=truth[3],
        dcn_gbps=truth[4])
    out = []
    for collective in ("all_reduce", "reduce_scatter", "all_gather"):
        for lowering in lowerings:
            for b in range(12, 27, 2):
                nbytes = 1 << b
                for _ in range(5):
                    n = rng.randint(0, nbytes // 2)
                    coeff = jmodel.cost_coefficients(collective, nbytes + n, lowering,
                                                     jt.world, truth_topo)
                    params = (truth[0], truth[1], truth[2], 1 / (truth[3] * 1e9),
                              1 / (truth[4] * 1e9))
                    s = sum(c * p for c, p in zip(coeff, params))
                    out.append((collective, lowering, nbytes + n, jt.world,
                                s * rng.uniform(0.9, 1.1)))
    return out


def _feed(records):
    for rec in records:
        jfit.record_observation(*rec[:3], axis_size=rec[3], seconds=rec[4])
        tfit.record_observation(*rec[:3], axis_size=rec[3], seconds=rec[4])


def _same_fit(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    for f in ("phase_overhead_s", "ici_latency_s", "dcn_latency_s", "ici_gbps",
              "dcn_gbps", "topo_key", "n_cells", "n_observations", "fitted_fields"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("truth", list(TRUTHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_fit_link_params_match_jax(shape, truth, seed):
    jt, tt = _topos(shape)
    lowerings = ("flat",) if shape[0] == 1 else ("flat", "hier")
    _feed(_observations(jt, TRUTHS[truth], seed, lowerings))
    jcells, tcells = jfit.observed_cells(), tfit.observed_cells()
    assert [tuple(vars(c).values()) for c in tcells] == \
        [tuple(vars(c).values()) for c in jcells]
    _same_fit(tfit.fit_link_params(tt), jfit.fit_link_params(jt))


def test_too_few_cells_and_bad_inputs_match_jax():
    jt, tt = _topos((2, 4))
    _feed([("all_reduce", "flat", 1 << 20, 8, 1e-3)] * 4)
    _same_fit(tfit.fit_link_params(tt), jfit.fit_link_params(jt))
    for rec in (("all_to_all", "flat", 100, 8, 1.0), ("all_reduce", "ring", 100, 8, 1.0),
                ("all_reduce", "flat", 100, 1, 1.0), ("all_reduce", "flat", 0, 8, 1.0),
                ("all_reduce", "flat", 100, 8, -1.0)):
        _feed([rec])
    assert tmetrics.snapshot() == jmetrics.snapshot()
    assert (tfit.cell_name("all_gather", "hier", 8, 3 << 20)
            == jfit.cell_name("all_gather", "hier", 8, 3 << 20))


def test_refresh_gauges_and_pricing_match_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_TOPO_FIT_MIN_OBS", "40")
    monkeypatch.setenv("HVD_TPU_TOPO_FIT_REFIT_EVERY", "8")
    jt, tt = _topos((2, 4))
    epochs = tfit.fit_epoch(), jfit.fit_epoch()

    def advanced():  # each package's epoch counts from its own history
        return tfit.fit_epoch() - epochs[0], jfit.fit_epoch() - epochs[1]

    records = _observations(jt, TRUTHS["mixed"], 3, ("flat", "hier"))
    for i in range(0, len(records), 10):
        _feed(records[i:i + 10])
        _same_fit(tfit.refresh(), jfit.refresh())
        got, want = advanced()
        assert got == want
    assert tfit.fitted_params(tt) is not None
    gauges = [g for g in tmetrics.gauges_by_prefix("topo.") if g["name"] != "topo.fit.epoch"]
    assert gauges == [g for g in jmetrics.gauges_by_prefix("topo.")
                      if g["name"] != "topo.fit.epoch"]
    assert tmetrics.get_counters("topo.fit") == jmetrics.get_counters("topo.fit")
    _same_fit(tfit.fitted_params(tmodel.Topology(1, 8)), None)  # another shape
    for collective in ("all_reduce", "reduce_scatter", "all_gather"):
        for nbytes in (1 << 12, 1 << 20, 1 << 28):
            for lowering in ("flat", "hier"):
                assert (tt.estimate_cost(collective, nbytes, lowering)
                        == jt.estimate_cost(collective, nbytes, lowering))
            assert (tt.rail_times(collective, nbytes, "hier")
                    == jt.rail_times(collective, nbytes, "hier"))
            assert tt.choose_lowering(collective, nbytes) == \
                jt.choose_lowering(collective, nbytes)
    assert tfit.effective_params(tt) == jfit.effective_params(jt)
    monkeypatch.setenv("HVD_TPU_TOPO_FIT", "off")
    assert tfit.effective_params(tt) == jfit.effective_params(jt) == (
        tt.phase_overhead_s, tt.ici_latency_s, tt.dcn_latency_s,
        tt.ici_gbps * 1e9, tt.dcn_gbps * 1e9)
    tmodel.reset()
    jmodel.reset()
    got, want = advanced()
    assert got == want
    assert not tmetrics.histograms_by_prefix(tfit.OBS_PREFIX)


def test_nccl_prices_statically_and_a_world_prices_with_rank_0s_fit(monkeypatch):
    monkeypatch.setenv("HVD_TPU_TOPO_FIT_MIN_OBS", "1")
    _, tt = _topos((2, 4))
    _feed(_observations(tt, TRUTHS["mixed"], 3, ("flat", "hier")))
    static = (tt.phase_overhead_s, tt.ici_latency_s, tt.dcn_latency_s,
              tt.ici_gbps * 1e9, tt.dcn_gbps * 1e9)
    fp = tfit.refresh(force=True)
    assert fp is not None and tfit.effective_params(tt) != static
    # Unset, the fit prices nothing on NCCL (its cells hold enqueue times).
    monkeypatch.setattr(tfit, "_backend", lambda: "nccl")
    assert not tfit.enabled() and tfit.effective_params(tt) == static
    monkeypatch.setenv("HVD_TPU_TOPO_FIT", "1")
    assert tfit.enabled() and tfit.fitted_params(tt) == fp
    # Several ranks price with the fit rank 0 shared, none before it.
    monkeypatch.setattr(tfit, "_several_ranks", lambda: True)
    assert tfit.local_params() == fp and tfit.effective_params(tt) == static
    epoch = tfit.fit_epoch()
    tfit.share(fp)
    assert tfit.fitted_params(tt) == fp and tfit.fit_epoch() == epoch + 1
    tmodel.reset()
    assert tfit.effective_params(tt) == static
