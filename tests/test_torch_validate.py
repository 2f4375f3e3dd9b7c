"""The port's validation (``repro_torch.validate``) against the JAX
package's, on the CPU, from the same seeded numpy inputs.

* ``RasterAccumulator``: the carry of a random raster, fed whole or in
  chunks of any length, bitwise the reference's; and bitwise the carry the
  in-loop ``update_carry`` builds step by step from the same raster.
* ``pool_carries`` and ``finalize`` on those carries: every field bitwise
  (the statistics are float64 numpy in the reference's order; nan where
  the reference has nan).
* ``sample_ids``: the same ids.
* ``validate()`` from each source (the ``spike_stats`` stream under its own
  name or another, a ``spikes`` raster, ``pop_counts`` alone) and with a
  tightened spec: the reports' ``to_dict``, ``table`` and ``to_json`` equal.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import validate as JV
from repro.api.results import RunResult as JaxRunResult
from repro.core.connectivity import build_connectome as jax_build_connectome
from repro.validate import stats as JVS
from repro_torch import validate as V
from repro_torch.api.results import BatchResult, RunResult
from repro_torch.core.connectivity import build_connectome
from repro_torch.validate import stats as VS

SCALE = 0.02


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    return (build_connectome(scale=SCALE, seed=55),
            jax_build_connectome(scale=SCALE, seed=55))


def _raster(t: int, n: int, seed: int, rate: float = 0.02) -> np.ndarray:
    """A seeded ``[t, n]`` raster; every 7th neuron silent, every 11th
    spiking at every third step (regular: CV 0)."""
    rng = np.random.default_rng(seed)
    r = rng.random((t, n)) < rate
    r[:, ::7] = False
    r[::3, 5::11] = True
    return r


def _assert_carry_equal(a, b):
    a, b = VS._host(a), VS._host(b)
    for name, x, y in zip(VS.SpikeStatsCarry._fields, a, b):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _assert_stats_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("chunks", [(400,), (1, 399), (37, 63, 300),
                                    (200, 200)])
@pytest.mark.parametrize("bin_steps", [1, 5, 20])
def test_raster_accumulator_bitwise_and_chunking_invariant(chunks,
                                                           bin_steps):
    raster = _raster(sum(chunks), 60, seed=bin_steps)
    whole = JVS.RasterAccumulator(60, bin_steps=bin_steps)
    whole.update(raster)
    ported = VS.RasterAccumulator(60, bin_steps=bin_steps)
    start = 0
    for n in chunks:
        ported.update(raster[start:start + n])
        start += n
    _assert_carry_equal(ported.carry, whole.carry)


def test_raster_accumulator_equals_the_in_loop_carry():
    """The host mirror against ``update_carry`` step by step (the
    ``spike_stats`` probe's), from the same raster."""
    raster = _raster(250, 40, seed=3, rate=0.05)
    acc = VS.RasterAccumulator(40, bin_steps=5)
    acc.update(raster)
    carry = VS.init_carry(40)
    for row in raster:
        carry = VS.update_carry(carry, torch.from_numpy(row), bin_steps=5)
    _assert_carry_equal(carry, acc.carry)


def test_raster_accumulator_without_correlation():
    raster = _raster(100, 30, seed=4)
    want = JVS.RasterAccumulator(30, bin_steps=10, correlation=False)
    got = VS.RasterAccumulator(30, bin_steps=10, correlation=False)
    want.update(raster)
    got.update(raster)
    _assert_carry_equal(got.carry, want.carry)
    assert got.carry.bin_outer.shape == (0, 0)
    with pytest.raises(ValueError, match="raster must be"):
        got.update(raster[:, :5])


def _carries(n_trials: int, n: int, bin_steps: int):
    """Trials' carries, one per seeded raster, from both packages."""
    out = []
    for i in range(n_trials):
        r = _raster(300 + 17 * i, n, seed=10 + i)
        a, b = VS.RasterAccumulator(n, bin_steps), \
            JVS.RasterAccumulator(n, bin_steps)
        a.update(r)
        b.update(r)
        out.append((a.carry, b.carry))
    return out


def test_pool_carries_bitwise():
    pairs = _carries(3, 50, bin_steps=20)
    got = VS.pool_carries([a for a, _ in pairs])
    want = JVS.pool_carries([b for _, b in pairs])
    _assert_carry_equal(got, want)
    assert int(got.steps) == 300 + 317 + 334
    np.testing.assert_array_equal(got.last_spike, -1)
    with pytest.raises(ValueError, match="no carries"):
        VS.pool_carries([])
    with pytest.raises(ValueError, match="different neuron counts"):
        VS.pool_carries([pairs[0][0], _carries(1, 49, 20)[0][0]])


@pytest.mark.parametrize("min_spikes", [2, 3, 6])
def test_finalize_bitwise(nets, min_spikes):
    c, jc = nets
    ids = V.sample_ids(c.pop_sizes, per_pop=40, seed=5)
    raster = _raster(600, ids.size, seed=min_spikes)
    a, b = VS.RasterAccumulator(ids.size, 20), \
        JVS.RasterAccumulator(ids.size, 20)
    a.update(raster)
    b.update(raster)
    got = VS.finalize(a.carry, ids, c.pop_of, 8, 0.1, 20, min_spikes)
    want = JVS.finalize(b.carry, ids, np.asarray(jc.pop_of), 8, 0.1, 20,
                        min_spikes)
    _assert_stats_equal(got, want)
    assert np.isfinite(got.cv_isi).all() and got.n_bins == 30
    with pytest.raises(ValueError, match="empty"):
        VS.finalize(VS.RasterAccumulator(3, 5).carry, ids[:3], c.pop_of, 8,
                    0.1, 5)


def test_finalize_with_one_bin_and_an_unsampled_population(nets):
    c, jc = nets
    ids = V.sample_ids(c.pop_sizes, per_pop=10, seed=1)
    ids = ids[np.asarray(c.pop_of)[ids] != 3]          # L6E unsampled
    raster = _raster(30, ids.size, seed=2, rate=0.2)
    a, b = VS.RasterAccumulator(ids.size, 20), \
        JVS.RasterAccumulator(ids.size, 20)
    a.update(raster)
    b.update(raster)
    got = VS.finalize(a.carry, ids, c.pop_of, 8, 0.1, 20)
    want = JVS.finalize(b.carry, ids, np.asarray(jc.pop_of), 8, 0.1, 20)
    _assert_stats_equal(got, want)
    assert np.isnan(got.correlation).all() and got.n_sampled[3] == 0


@pytest.mark.parametrize("per_pop,seed", [(100, 0), (7, 55), (10_000, 3)])
def test_sample_ids(nets, per_pop, seed):
    c, jc = nets
    got = V.sample_ids(c.pop_sizes, per_pop=per_pop, seed=seed)
    want = JV.sample_ids(np.asarray(jc.pop_sizes), per_pop=per_pop,
                         seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _results(nets, source: str, t: int = 400):
    """A port and a JAX ``RunResult`` holding the same seeded data."""
    c, jc = nets
    raster = _raster(t, c.n_total, seed=9, rate=0.001)
    pop_counts = np.stack([np.bincount(np.asarray(c.pop_of)[row],
                                       minlength=8)
                           for row in raster]).astype(np.int32)
    data, streams = {}, {}
    if source in ("stream", "renamed_stream", "pop_counts", "all"):
        data["pop_counts"] = pop_counts
    if source in ("raster", "all"):
        data["spikes"] = raster
    if source in ("stream", "renamed_stream", "stream_only", "all"):
        ids = V.sample_ids(c.pop_sizes, per_pop=30, seed=4)
        acc = VS.RasterAccumulator(ids.size, bin_steps=20)
        acc.update(raster[:, ids])
        name = "stats_l4" if source == "renamed_stream" else "spike_stats"
        streams[name] = {"carry": acc.carry,
                         "meta": {"ids": ids, "bin_steps": 20}}
    kw = dict(data=data, t_model_ms=t * 0.1, n_steps=t, dt=0.1, wall_s=1.0,
              overflow=2, streams=streams)
    return RunResult(_connectome=c, **kw), JaxRunResult(_connectome=jc, **kw)


@pytest.mark.parametrize("source", ["stream", "renamed_stream", "raster",
                                    "pop_counts", "stream_only", "all"])
def test_validate_report_equals_the_reference(nets, source):
    ours, ref = _results(nets, source)
    got, want = ours.validate(), ref.validate()
    assert got.to_dict() == want.to_dict()
    assert got.table() == want.table()
    assert got.to_json() == want.to_json()
    assert got.passed == want.passed
    statuses = {ck.status for ck in got.checks}
    if source == "pop_counts":
        assert statuses >= {"skip"}


def test_validate_with_a_tightened_spec(nets):
    ours, ref = _results(nets, "all")
    kw = dict(rate_rel_tol=0.1, rate_abs_tol=0.2, cv_band=(0.9, 1.1))
    got = V.validate(ours, V.microcircuit_reference(**kw))
    want = JV.validate(ref, JV.microcircuit_reference(**kw))
    assert got.to_dict() == want.to_dict() and not got.passed
    assert got.failures() and got.by_population() == want.by_population()


def test_validate_needs_a_source_and_the_connectome(nets, tmp_path):
    ours, _ = _results(nets, "all")
    with pytest.raises(ValueError, match="needs at least one"):
        V.validate(dataclasses.replace(ours, data={}, streams={}))
    with pytest.raises(ValueError, match="connectome"):
        V.validate(dataclasses.replace(ours, _connectome=None))
    report = ours.validate()
    path = tmp_path / "report.json"
    report.to_json(str(path))
    assert json.loads(path.read_text())["schema"] == \
        "repro.validation_report/v1"


def test_batch_result_pools_the_trials(nets):
    """``BatchResult``: the RTF per trial, mean and std; ``pooled`` the
    trials' data concatenated and their carries pooled; ``validate`` the
    pooled result's report."""
    c, _ = nets
    trials = []
    for i, (carry, _) in enumerate(_carries(3, 30, bin_steps=20)):
        trials.append(RunResult(
            data={"pop_counts": np.full((10 + i, 8), i, np.int32)},
            t_model_ms=1.0 + 0.1 * i, n_steps=10 + i, dt=0.1,
            wall_s=0.5 + i, overflow=i, _connectome=c,
            streams={"spike_stats": {"carry": carry, "meta": {
                "ids": V.sample_ids(c.pop_sizes, per_pop=30, seed=0)[:30],
                "bin_steps": 20}}}))
    batch = BatchResult(trials=trials, wall_s=9.0, seeds=[1, 2, 3])
    np.testing.assert_allclose(batch.rtf_trials,
                               [r.rtf for r in trials])
    assert batch.rtf_mean == pytest.approx(np.mean(batch.rtf_trials))
    assert batch.rtf_std == pytest.approx(np.std(batch.rtf_trials))
    pooled = batch.pooled()
    assert pooled.n_steps == 33 and pooled.wall_s == 9.0
    assert pooled.overflow == 3 and pooled["pop_counts"].shape == (33, 8)
    _assert_carry_equal(pooled.streams["spike_stats"]["carry"],
                        VS.pool_carries([t.streams["spike_stats"]["carry"]
                                         for t in trials]))
    assert batch.validate().to_dict() == pooled.validate().to_dict()
    assert len(batch) == 3 and batch[1] is trials[1] and not batch.vmapped
