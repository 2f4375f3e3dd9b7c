"""The ``pop_counts`` kernel (``csrc/pop_counts.cu``) on the card, against
its plain version on the CPU, bitwise: on every case of
``pop_counts_cases`` (PD14's full-scale sizes at densities 0, 0.02, 0.5
and 1, empty and single populations, every bound off 16-byte alignment, a
sharded registry whose spiking tail must not be counted), whose plain
counts ``test_torch_probes.py`` holds to the JAX package's on the CPU; and
captured in a CUDA graph, replayed over changing spike vectors.

Marked ``card``: each test skips without a CUDA card.  The file imports no
JAX, so it runs on a machine without it::

    python -m pytest -q --noconftest -m card tests/test_torch_pop_counts_card.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import probes as PR
from repro_torch.kernels import _build
from repro_torch.kernels import pop_counts as KP

sys.path.insert(0, str(Path(__file__).resolve().parent))
import pop_counts_cases  # noqa: E402

pytestmark = pytest.mark.card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


class _Net:
    def __init__(self, pop_of):
        self.pop_of = pop_of


def _on_card(spiked: np.ndarray, offset: int, dev) -> torch.Tensor:
    """``spiked`` on the card, ``offset`` bytes into a 16-byte aligned
    buffer (a contiguous view)."""
    buf = torch.zeros(spiked.size + offset, dtype=torch.bool, device=dev)
    view = buf[offset:]
    view.copy_(torch.from_numpy(spiked))
    return view


@pytest.mark.parametrize("name", pop_counts_cases.CASES)
def test_kernel_equals_plain(dev, name):
    probe = PR.pop_counts()
    for seed in range(3):
        pop_of, spiked, n_pops, offset = pop_counts_cases.case(name, seed)
        want = probe(PR.ProbeContext(None, torch.from_numpy(spiked),
                                     _Net(torch.from_numpy(pop_of)), n_pops))
        x = _on_card(spiked, offset, dev)
        assert x.data_ptr() % 16 == offset
        ctx = PR.ProbeContext(None, x, _Net(torch.from_numpy(pop_of).to(dev)),
                              n_pops)
        before = _build.launches["pop_counts"]
        got = probe(ctx)
        assert _build.launches["pop_counts"] == before + 1
        assert got.dtype == torch.int32 and got.shape == (n_pops,)
        assert torch.equal(got.cpu(), want), (name, seed)
        plain = PR.pop_counts()(ctx._replace(kernels=False))
        assert torch.equal(plain.cpu(), want)
        if name == "padded_tail":
            assert int(got.sum()) == int(spiked[:-pop_counts_cases.PAD].sum())


def test_graph_replays_equal_eager(dev):
    """The probe captured in a CUDA graph (its bounds built at an eager
    call first), replayed over changing spike vectors, gives the eager
    counts."""
    pop_of, spiked, n_pops, _ = pop_counts_cases.case("pd14_density_0.02")
    probe = PR.pop_counts()
    net = _Net(torch.from_numpy(pop_of).to(dev))
    x = torch.from_numpy(spiked).to(dev)
    probe(PR.ProbeContext(None, x, net, n_pops))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = probe(PR.ProbeContext(None, x, net, n_pops))
    at = torch.from_numpy(np.concatenate([[0], np.searchsorted(
        pop_of, np.arange(n_pops), side="right")]).astype(np.int32))
    rng = np.random.default_rng(11)
    before = _build.launches["pop_counts"]
    for density in (0.0, 0.01, 0.3, 1.0, 0.05):
        fresh = torch.from_numpy(rng.random(spiked.size) < density)
        x.copy_(fresh.to(dev))
        graph.replay()          # a bare graph adds no launch to the count
        eager = KP.pop_counts(x, at.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert torch.equal(out.cpu(), KP.pop_counts_plain(fresh, at))
    assert _build.launches["pop_counts"] == before + 5
