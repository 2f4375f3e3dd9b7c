"""K2's, K3's, K4's and ``stdp_update``'s launch arguments, on the CPU.

The wrappers build the constant part of a launch's C arguments (the
tables' addresses, the sizes, the propagators, the grid, the workspace and
the coefficients) once per session and cache it.  Here the cached pack
that the launch path takes (``session_pack``) must equal, field by field,
the pack built afresh from the same tensors and values as a call without
the cache would build it, for two networks and for K3, K4 and K2 (the
kernel's delivery-only form: no propagators, no ``w_ext``), asked for in
turns so that a stale hit would show; ``stdp_update``'s pack likewise, and it must change
with the budget, the grid and each table.  Also: the packs' C layouts, the
compaction's tiles cover ``[0, N)`` for any N and grid (K2's grids among
them), and the stamped kernels are refused on CPU tensors.
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
from repro_torch.kernels import ell_deliver as K2
from repro_torch.kernels import lif_deliver as K3
from repro_torch.kernels import stdp as KS

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
                         in_syn=ptab.in_syn_idx, pmask_in=ptab.plastic_in,
                         weights=tables.weights.clone(), coef=coef,
                         ws=torch.zeros(1 + 7, dtype=torch.int64))
    return out


FORMS = {"K3": False, "K4": True, "K2": None}


def _inputs(net, plastic, budget=128, grid=7):
    """A pack's inputs: K3 (``plastic`` False), K4 (True) or K2 (None)."""
    c, tb = net["c"], net["tables"]
    return dict(
        targets=tb.targets, weights=net["weights"] if plastic
        else tb.weights, dbins=tb.dbins,
        pmask=net["pmask"] if plastic else None, ws=net["ws"],
        n=c.n_total, n_tgt=c.n_total, n_exc=c.n_exc, d_bins=c.d_max_bins,
        budget=budget,
        grid=grid, prop=None if plastic is None
        else Propagators.make(NeuronParams(), 0.1),
        coef=net["coef"] if plastic else None,
        w_ext=0.0 if plastic is None else float(c.w_ext))


def _fresh(x):
    """The pack as a call without the cache builds it."""
    p, coef = x["prop"], x["coef"]
    f32 = lambda v: float(np.float32(v))
    lif = ("P11_ex", "P11_in", "P22", "P21_ex", "P21_in", "P20", "V_th",
           "V_reset", "E_L")
    return {"targets": x["targets"].data_ptr(),
            "weights": x["weights"].data_ptr(),
            "dbins": x["dbins"].data_ptr(),
            "pmask": None if x["pmask"] is None else x["pmask"].data_ptr(),
            "ws": x["ws"].data_ptr(), "k_pad": x["targets"].shape[1],
            "n": x["n"], "n_tgt": x["n_tgt"], "n_exc": x["n_exc"],
            "d_bins": x["d_bins"],
            "budget": x["budget"], "grid": x["grid"],
            **{f: f32(getattr(p, f)) if p else 0.0 for f in lif},
            "ref_steps": p.ref_steps if p else 0,
            "dep_coef": f32(coef.dep) if coef else 0.0,
            "decay_p": f32(coef.decay_p) if coef else 0.0,
            "decay_m": f32(coef.decay_m) if coef else 0.0,
            "w_ext": f32(x["w_ext"])}


def _fields(pack):
    return {name: getattr(pack, name) for name, _ in K3.StepConst._fields_}


@pytest.mark.parametrize("plastic", list(FORMS.values()), ids=list(FORMS))
@pytest.mark.parametrize("net_name", list(NETS))
def test_cached_pack_equals_per_call_pack(nets, net_name, plastic):
    other = next(n for n in NETS if n != net_name)
    x = _inputs(nets[net_name], plastic)
    kw = {k: v for k, v in x.items() if k not in ("targets", "weights",
                                                  "dbins", "pmask", "ws")}
    args = (x["targets"], x["weights"], x["dbins"], x["pmask"], x["ws"])
    first = K3.session_pack(*args, **kw)
    # the other network, then the other kernels, in between
    others = [f for f in FORMS.values() if f is not plastic]
    for y in (_inputs(nets[other], plastic),
              *(_inputs(nets[other], f) for f in others),
              *(_inputs(nets[net_name], f) for f in others)):
        K3.session_pack(y["targets"], y["weights"], y["dbins"], y["pmask"],
                        y["ws"], **{k: v for k, v in y.items() if k not in (
                            "targets", "weights", "dbins", "pmask", "ws")})
    again = K3.session_pack(*args, **kw)
    assert again is first                     # the cache's own pack
    assert _fields(again) == _fields(K3.step_const(
        (x["targets"].data_ptr(), x["weights"].data_ptr(),
         x["dbins"].data_ptr(), 0 if x["pmask"] is None
         else x["pmask"].data_ptr(), x["ws"].data_ptr()),
        (x["targets"].shape[1], x["n"], x["n_tgt"], x["n_exc"], x["d_bins"],
         x["budget"], x["grid"]), x["prop"], x["coef"], x["w_ext"]))
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
    # the ring's target count: K2's local-ring form over a rank's block
    for change in ({"budget": 256}, {"grid": 3}, {"n_exc": x["n_exc"] - 1},
                   {"n_tgt": x["n"] // 2}, {"w_ext": 2.5}):
        pack = K3.session_pack(*args, **{**kw, **change})
        (key, want), = change.items()
        assert getattr(pack, key) == want and getattr(base, key) != want


def test_step_const_has_the_c_layout():
    """5 pointers, k_pad..grid (the ring's target count n_tgt after n),
    the 10 LifProp fields, K4's 3 floats, K3's and K4's ``w_ext``: the C
    struct's 124 bytes, padded to 128 by its pointers' alignment (checked
    against the library on the card)."""
    assert ctypes.sizeof(K3.StepConst) == 5 * 8 + 7 * 4 + 10 * 4 + 3 * 4 \
        + 4 + 4
    assert K3.StepConst.k_pad.offset == 40
    assert K3.StepConst.n_tgt.offset == 48
    assert K3.StepConst.P11_ex.offset == 68
    assert K3.StepConst.dep_coef.offset == 108
    assert K3.StepConst.w_ext.offset == 120


@pytest.mark.parametrize("n,grid", [(77_169, 132), (1_544, 7), (10, 132),
                                    (1_024, 1), (131, 132), (2_000, 3),
                                    # K2's grids for smaller networks
                                    (15_435, 61), (771, 4), (255, 1)])
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
                       z, z, z, torch.zeros(n, dtype=torch.int32), z, z,
                       torch.tensor(7, dtype=torch.int32),
                       torch.tensor(0, dtype=torch.int32),
                       n_exc=c.n_exc, budget=128, w_ext=float(c.w_ext),
                       prop=Propagators.make(NeuronParams(), 0.1),
                       stamps=torch.zeros(7, 8, dtype=torch.int64))


def test_deliver_pack_has_no_propagators(nets):
    """K2's pack: the shared C layout, the tables, sizes and workspace, and
    zeros where K3 keeps its propagators and ``w_ext`` and K4 its
    coefficients."""
    x = _inputs(nets["scale_0.02_seed_55"], None)
    pack = K3.session_pack(x["targets"], x["weights"], x["dbins"], None,
                           x["ws"], **{k: x[k] for k in (
                               "n", "n_exc", "d_bins", "budget", "grid",
                               "prop", "coef")})
    assert type(pack) is K3.StepConst
    assert ctypes.sizeof(pack) == 128
    got = _fields(pack)
    assert got["pmask"] is None and got["ws"] == x["ws"].data_ptr()
    assert all(got[f] == 0 for f in ("P11_ex", "P22", "V_th", "ref_steps",
                                     "dep_coef", "decay_m", "w_ext"))
    k3 = K3.session_pack(x["targets"], x["weights"], x["dbins"], None,
                         x["ws"], **{**{k: x[k] for k in (
                             "n", "n_exc", "d_bins", "budget", "grid")},
                             "prop": Propagators.make(NeuronParams(), 0.1),
                             "coef": None})
    assert _fields(k3) != got


def _stdp_inputs(net, budget=128, grid=132):
    c, tb = net["c"], net["tables"]
    return dict(weights=net["weights"], targets=tb.targets,
                pmask=net["pmask"], in_syn=net["in_syn"],
                pmask_in=net["pmask_in"], n=c.n_total, budget=budget,
                grid=grid, coef=net["coef"])


def _stdp_pack(x):
    return KS.session_pack(*(x[k] for k in ("weights", "targets", "pmask",
                                            "in_syn", "pmask_in")),
                           **{k: x[k] for k in ("n", "budget", "grid",
                                                "coef")})


def _stdp_fields(pack):
    return {name: getattr(pack, name) for name, _ in KS.StdpConst._fields_}


def test_stdp_pack_has_the_c_layout():
    """5 pointers, n..grid, the 5 coefficients: the C struct's 80 bytes
    (checked against the library on the card)."""
    assert ctypes.sizeof(KS.StdpConst) == 5 * 8 + 5 * 4 + 5 * 4
    assert KS.StdpConst.n.offset == 40
    assert KS.StdpConst.dep.offset == 60


@pytest.mark.parametrize("net_name", list(NETS))
def test_stdp_cached_pack_equals_per_call_pack(nets, net_name):
    other = next(n for n in NETS if n != net_name)
    x = _stdp_inputs(nets[net_name])
    first = _stdp_pack(x)
    _stdp_pack(_stdp_inputs(nets[other]))
    again = _stdp_pack(x)
    assert again is first
    f32 = lambda v: float(np.float32(v))
    assert _stdp_fields(again) == {
        "targets": x["targets"].data_ptr(), "pmask": x["pmask"].data_ptr(),
        "w": x["weights"].data_ptr(), "in_syn": x["in_syn"].data_ptr(),
        "pmask_in": x["pmask_in"].data_ptr(), "n": x["n"],
        "k": x["weights"].shape[1], "k_in": x["in_syn"].shape[1],
        "budget": x["budget"], "grid": x["grid"],
        **{f: f32(getattr(x["coef"], f)) for f in (
            "dep", "pot", "decay_p", "decay_m", "w_max")}}


def test_stdp_pack_changes_with_budget_grid_and_tables(nets):
    net = nets["scale_0.02_seed_55"]
    x = _stdp_inputs(net)
    base = _stdp_fields(_stdp_pack(x))
    for key, value in (("budget", 256), ("grid", 66)):
        got = _stdp_fields(_stdp_pack({**x, key: value}))
        assert got[key] == value and got != base
    fields = {"weights": "w", "targets": "targets", "pmask": "pmask",
              "in_syn": "in_syn", "pmask_in": "pmask_in"}
    for key, field in fields.items():
        moved = x[key].clone()                # same values, new address
        got = _stdp_fields(_stdp_pack({**x, key: moved}))
        assert got[field] == moved.data_ptr() != base[field]
        assert {k: v for k, v in got.items() if k != field} \
            == {k: v for k, v in base.items() if k != field}


def test_k2_and_stdp_stamps_need_the_card(nets):
    net = nets["scale_0.02_seed_55"]
    c, tb = net["c"], net["tables"]
    n = c.n_total
    stamps = torch.zeros(7, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="stamps"):
        K2.ell_deliver(torch.zeros(c.d_max_bins, 2, n + 1), tb.targets,
                       tb.weights, tb.dbins, torch.zeros(n, dtype=torch.bool),
                       7, c.n_exc, 128, stamps=stamps)
    with pytest.raises(ValueError, match="stamps"):
        KS.stdp_update(net["weights"], tb.targets, net["pmask"],
                       net["in_syn"], net["pmask_in"],
                       torch.full((128,), n, dtype=torch.int32),
                       torch.zeros(n), None, None, net["coef"], full=False,
                       clip_all=False, stamps=stamps)
