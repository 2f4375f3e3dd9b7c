"""The port builds the JAX package's connectome bit for bit.

``repro_torch.core.connectivity`` is a numpy copy of
``repro.core.connectivity``: the same seed must give ``np.array_equal``
fields, and the ``event`` / ``ell`` strategies must prepare the same
device tables (sentinel row N, the ``ell`` pad to ``block_k = 128``).
Tolerance: none, every array is compared exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import delivery as jdlv
from repro.core import params as jparams
from repro.core.connectivity import build_connectome as jax_build
from repro.core.engine import SimConfig as JaxSimConfig
from repro_torch.core import delivery as tdlv
from repro_torch.core import params as tparams
from repro_torch.core.connectivity import build_connectome as port_build
from repro_torch.core.engine import SimConfig

CASES = [dict(scale=0.02, seed=55), dict(scale=0.02, seed=7),
         dict(n_scaling=0.03, k_scaling=0.01, seed=3)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def pair(request):
    return jax_build(**request.param), port_build(**request.param)


def test_connectome_fields_equal(pair):
    want, got = pair
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("strategy", ["event", "ell"])
def test_prepared_tables_equal(pair, strategy):
    c_jax, c_port = pair
    want = jdlv.get_strategy(strategy).prepare(
        c_jax, JaxSimConfig(strategy=strategy))
    got = tdlv.get_strategy(strategy).prepare(
        c_port, SimConfig(strategy=strategy), torch.device("cpu"))
    n = c_port.n_total
    for name in ("targets", "weights", "dbins"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the sentinel source row: every entry the dump column, weight 0
    assert (got.targets[n] == n).all() and (got.weights[n] == 0).all()
    if strategy == "ell":
        assert got.targets.shape[1] % tdlv.EllDelivery.block_k == 0


def test_params_copy_equal():
    """The numbers the connectome is built from are the reference's."""
    for name in ("POPULATIONS", "N_FULL", "CONN_PROBS", "K_EXT",
                 "FULL_MEAN_RATES", "V0_MEAN", "V0_SD", "N_EXC_POPS"):
        a, b = getattr(jparams, name), getattr(tparams, name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert dataclasses.asdict(jparams.NeuronParams()) == \
        dataclasses.asdict(tparams.NeuronParams())
    assert dataclasses.asdict(jparams.SynapseParams()) == \
        dataclasses.asdict(tparams.SynapseParams())


def test_auto_spike_budget_equal(pair):
    c_jax, c_port = pair
    assert tdlv.auto_spike_budget(c_port, 0.1) == \
        jdlv.auto_spike_budget(c_jax, 0.1)
