"""The copied roofline arithmetic at a hand-worked small case, and the
per-layer readers on a recorded profile (``profile_fixture.json``)."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import bench, trace  # noqa: E402
from perfbench import roofline as R  # noqa: E402

FIXTURE = Path(__file__).with_name("profile_fixture.json")


def test_bound_takes_the_larger_side():
    assert R.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert R.bound_s(0, 67e12) == pytest.approx(1.0)
    assert R.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_bytes_and_operations_by_hand():
    # n = 10 neurons, a budget of 4 ids, 6 delivered entries:
    # state 10 * 41, spikes 10, the slot 2 * 2 * 11 * 4, ids 16, overflow
    # 4, entries 6 * 20
    assert R.k3_bytes(10, 4, 6) == 410 + 10 + 176 + 16 + 4 + 120
    assert R.k3_ops(10, 6) == 13 * 10 + 3 * 6
    assert R.k2_bytes(10, 4, 6) == 10 + 16 + 4 + 120
    w = {"out": 6, "out_plastic": 3, "in": 5, "in_plastic": 2,
         "sources": 1.5}
    # K3's plus the plastic mask 6, the plastic weights 12, traces 160
    assert R.k4_bytes(10, 4, w) == 736 + 6 + 12 + 160
    assert R.k4_ops(10, w) == 130 + 18 + 6 + 40
    # ids 16, IN masks 5, plastic entries 24, sources 6, OUT masks 6,
    # OUT plastic weights 12
    assert R.stdp_bytes(w, 4) == 16 + 5 + 24 + 6 + 6 + 12
    assert R.stdp_ops(w) == 4


def test_spike_work_from_counts():
    net = {"out": [10.0] * 8, "out_plastic": [4.0] * 4 + [0.0] * 4,
           "in": [20.0] * 8, "in_plastic": [8.0] * 4 + [0.0] * 4,
           "n_exc": 1000}
    w = R.spike_work([1, 0, 0, 0, 2, 0, 0, 0], net)
    assert (w["out"], w["out_plastic"], w["in"], w["in_plastic"]) == \
        (30.0, 4.0, 60.0, 8.0)
    assert 7.9 < w["sources"] < 8.0


def test_kernel_forms():
    name = ("void (anonymous namespace)::lif_deliver_kernel<((anonymous "
            "namespace)::Form){}, false>((anonymous namespace)::StepArgs)")
    assert [R.kernel_form(name.format(i)) for i in range(3)] == \
        ["K3", "K4", "K2"]
    assert R.kernel_form("void stdp_update_kernel<false>(StdpArgs)") \
        == "stdp_update"
    assert R.kernel_form("memcpy32_post") is None


@pytest.fixture(scope="module")
def record():
    fx = json.loads(FIXTURE.read_text())
    prof = trace.finish(trace.reduce(fx["device_ops"], fx["host_ops"],
                                     tuple(fx["window"])),
                        [np.array(c) for c in fx["counts"]])
    return {"profile": prof, "net": fx["net"], "window": fx["window_stats"],
            "spans": {}, "setup_s": 1.0}


def test_reduce_on_the_fixture(record):
    p = record["profile"]
    # window 0..1000 us; K3 at 100..110 and 300..310, a small op at
    # 110..120, a copy at 500..520
    assert p["busy_s"] == pytest.approx(50e-6)
    assert p["window_s"] == pytest.approx(1000e-6)
    assert p["hand"]["K3"] == {"us": pytest.approx(20.0), "calls": 2}
    assert (p["units"], p["steps"]) == (2, 2)
    assert p["counts_per_step"] == [0.5, 0.5, 0, 0, 0.5, 0, 0, 0]
    gaps = p["breakdown"]["idle_gaps"]
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(480e-6)]
    assert gaps[1][0] == "perfbench.unit"      # nothing else was traced


def test_readers_on_the_fixture(record):
    read = lambda name: bench.reader(name)(record)
    net, p, w = record["net"], record["profile"], record["window"]
    s = R.spike_work(p["counts_per_step"], net)
    k3 = R.bound_s(R.k3_bytes(net["n"], net["budget"], s["out"]),
                   R.k3_ops(net["n"], s["out"]))
    assert read("lif_deliver_roofline") == pytest.approx(100 * k3 / 10e-6)
    assert read("device.idle_share") == pytest.approx(95.0)
    # 25 us busy a traced chunk of a 1.05 ms mean chunk
    assert read("device.idle_share.loop") == pytest.approx(
        100 * (1 - 25 / 1050))
    assert read("step.small_ops_us") == pytest.approx((10 + 20) / 2)
    # the window's mean chunk (1.05 ms) less the traced busy a chunk
    assert read("loop.host_us_per_chunk") == pytest.approx(1050 - 25)
    s = R.spike_work(w["counts_per_step"], net)
    step = R.bound_s(R.k3_bytes(net["n"], net["budget"], s["out"])
                     + R.drive_probe_bytes(net["n"]),
                     R.k3_ops(net["n"], s["out"]))
    assert read("mfu.step") == pytest.approx(100 * step / 5e-5)
    assert read("lif_deliver_plastic_roofline") is None
    assert read("stdp_update_roofline") is None
    assert read("rtf") == pytest.approx(0.5)
    # numpy's linear percentile: index 0.95 * 19 = 18.05, 1 + 0.05 ms
    assert read("chunk_p95_ms") == pytest.approx(1.05)
