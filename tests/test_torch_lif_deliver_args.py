"""K3's and K4's launch arguments, on the CPU.

The wrapper builds the constant part of a launch's C arguments (the
tables' addresses, the sizes, the propagators, the grid, the workspace and
K4's coefficients) once per session and caches it.  Here the cached pack
that the launch path takes (``session_pack``) must equal, field by field,
the pack built afresh from the same tensors and values as a call without
the cache would build it, for two networks and for K3 and K4, asked for in
turns so that a stale hit would show.  Also: the compaction's tiles cover
``[0, N)`` for any N and grid, and the stamped kernel is refused on CPU
tensors.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import plasticity as PL
from repro_torch.core.connectivity import build_connectome
from repro_torch.core.delivery import REGISTRY as STRATEGIES
from repro_torch.core.neuron import Propagators
from repro_torch.core.params import NeuronParams
from repro_torch.kernels import lif_deliver as K3

CPU = torch.device("cpu")
NETS = {"scale_0.02_seed_55": (0.02, 55), "scale_0.01_seed_7": (0.01, 7)}


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name, (scale, seed) in NETS.items():
        c = build_connectome(scale=scale, seed=seed)
        tables = STRATEGIES["ell"].prepare(c, None, CPU)
        ptab = PL.build_plastic_tables(tables, c.n_exc)
        coef = PL.stdp_coefficients(PL.STDPConfig(w_ref=float(c.w_ext),
                                                  dt=0.1))
        out[name] = dict(c=c, tables=tables, pmask=ptab.plastic_out,
                         weights=tables.weights.clone(), coef=coef,
                         ws=torch.zeros(1 + 7, dtype=torch.int64))
    return out


def _inputs(net, plastic, budget=128, grid=7):
    c, tb = net["c"], net["tables"]
    return dict(
        targets=tb.targets, weights=net["weights"] if plastic
        else tb.weights, dbins=tb.dbins,
        pmask=net["pmask"] if plastic else None, ws=net["ws"],
        n=c.n_total, n_exc=c.n_exc, d_bins=c.d_max_bins, budget=budget,
        grid=grid, prop=Propagators.make(NeuronParams(), 0.1),
        coef=net["coef"] if plastic else None)


def _fresh(x):
    """The pack as a call without the cache builds it."""
    p, coef = x["prop"], x["coef"]
    f32 = lambda v: float(np.float32(v))
    return {"targets": x["targets"].data_ptr(),
            "weights": x["weights"].data_ptr(),
            "dbins": x["dbins"].data_ptr(),
            "pmask": None if x["pmask"] is None else x["pmask"].data_ptr(),
            "ws": x["ws"].data_ptr(), "k_pad": x["targets"].shape[1],
            "n": x["n"], "n_exc": x["n_exc"], "d_bins": x["d_bins"],
            "budget": x["budget"], "grid": x["grid"],
            **{f: f32(getattr(p, f)) for f in (
                "P11_ex", "P11_in", "P22", "P21_ex", "P21_in", "P20", "V_th",
                "V_reset", "E_L")},
            "ref_steps": p.ref_steps,
            "dep_coef": f32(coef.dep) if coef else 0.0,
            "decay_p": f32(coef.decay_p) if coef else 0.0,
            "decay_m": f32(coef.decay_m) if coef else 0.0}


def _fields(pack):
    return {name: getattr(pack, name) for name, _ in K3.StepConst._fields_}


@pytest.mark.parametrize("plastic", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("net_name", list(NETS))
def test_cached_pack_equals_per_call_pack(nets, net_name, plastic):
    other = next(n for n in NETS if n != net_name)
    x = _inputs(nets[net_name], plastic)
    kw = {k: v for k, v in x.items() if k not in ("targets", "weights",
                                                  "dbins", "pmask", "ws")}
    args = (x["targets"], x["weights"], x["dbins"], x["pmask"], x["ws"])
    first = K3.session_pack(*args, **kw)
    # the other network, then the other kernel, in between
    for y in (_inputs(nets[other], plastic), _inputs(nets[other], not plastic),
              _inputs(nets[net_name], not plastic)):
        K3.session_pack(y["targets"], y["weights"], y["dbins"], y["pmask"],
                        y["ws"], **{k: v for k, v in y.items() if k not in (
                            "targets", "weights", "dbins", "pmask", "ws")})
    again = K3.session_pack(*args, **kw)
    assert again is first                     # the cache's own pack
    assert _fields(again) == _fields(K3.step_const(
        (x["targets"].data_ptr(), x["weights"].data_ptr(),
         x["dbins"].data_ptr(), 0 if x["pmask"] is None
         else x["pmask"].data_ptr(), x["ws"].data_ptr()),
        (x["targets"].shape[1], x["n"], x["n_exc"], x["d_bins"], x["budget"],
         x["grid"]), x["prop"], x["coef"]))
    assert _fields(again) == _fresh(x)
    assert _fields(again) != _fields(K3.session_pack(
        *(_inputs(nets[other], plastic)[k] for k in ("targets", "weights",
                                                     "dbins", "pmask",
                                                     "ws")),
        **{k: v for k, v in _inputs(nets[other], plastic).items()
           if k not in ("targets", "weights", "dbins", "pmask", "ws")}))


def test_pack_changes_with_the_budget_and_grid(nets):
    x = _inputs(nets["scale_0.02_seed_55"], False)
    kw = {k: v for k, v in x.items() if k not in ("targets", "weights",
                                                  "dbins", "pmask", "ws")}
    args = (x["targets"], x["weights"], x["dbins"], x["pmask"], x["ws"])
    base = K3.session_pack(*args, **kw)
    for change in ({"budget": 256}, {"grid": 3}, {"n_exc": x["n_exc"] - 1}):
        pack = K3.session_pack(*args, **{**kw, **change})
        (key, want), = change.items()
        assert getattr(pack, key) == want and getattr(base, key) != want


def test_step_const_has_the_c_layout():
    """5 pointers, k_pad..grid, the 10 LifProp fields, K4's 3 floats: the
    C struct's 120 bytes (checked against the library on the card)."""
    assert ctypes.sizeof(K3.StepConst) == 5 * 8 + 6 * 4 + 10 * 4 + 3 * 4 + 4
    assert K3.StepConst.k_pad.offset == 40
    assert K3.StepConst.P11_ex.offset == 64
    assert K3.StepConst.dep_coef.offset == 104


@pytest.mark.parametrize("n,grid", [(77_169, 132), (1_544, 7), (10, 132),
                                    (1_024, 1), (131, 132), (2_000, 3)])
def test_compaction_tiles_cover_n(n, grid):
    tiles = K3.compaction_tiles(n, grid)
    assert len(tiles) == grid
    assert tiles[0][0] == 0 and max(hi for _, hi in tiles) == n
    for (lo, hi), (lo2, _) in zip(tiles, tiles[1:]):
        assert lo <= hi == lo2 or hi == lo2 == n
    sizes = {hi - lo for lo, hi in tiles if hi - lo}
    assert max(sizes) == -(-n // grid)


def test_stamps_need_the_card(nets):
    net = nets["scale_0.02_seed_55"]
    c, tb = net["c"], net["tables"]
    n = c.n_total
    z = torch.zeros(n)
    with pytest.raises(ValueError, match="stamps"):
        K3.lif_deliver(torch.zeros(c.d_max_bins, 2, n + 1), tb.targets,
                       tb.weights, tb.dbins, torch.zeros(n, dtype=torch.bool),
                       z, z, z, torch.zeros(n, dtype=torch.int32), z, z, 7,
                       n_exc=c.n_exc, budget=128,
                       prop=Propagators.make(NeuronParams(), 0.1),
                       stamps=torch.zeros(7, 8, dtype=torch.int64))
