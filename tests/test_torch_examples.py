"""``examples/microcircuit_sim_torch.py`` on the CPU at scale 0.02: a
chunked, checkpointed sharded run gives the population counts of an
unchunked one, bitwise, and leaves a checkpoint after every chunk."""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example():
    spec = importlib.util.spec_from_file_location(
        "microcircuit_sim_torch",
        ROOT / "examples" / "microcircuit_sim_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chunked_checkpointed_sharded_run_equals_one_run(tmp_path, capsys):
    ex = _example()
    flags = ["--scale", "0.02", "--t-sim", "20", "--t-presim", "10",
             "--strategy", "ell", "--backend", "sharded", "--device", "cpu"]
    whole = ex.main(flags)
    chunked = ex.main(flags + ["--chunk", "5", "--checkpoint-dir",
                               str(tmp_path)])
    assert whole.n_steps == chunked.n_steps == 200
    assert whole["pop_counts"].sum() > 0
    np.testing.assert_array_equal(chunked["pop_counts"],
                                  whole["pop_counts"])
    # keep=3: the last three of the four chunks' checkpoints
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000100", "step_00000150", "step_00000200"]
    out = capsys.readouterr().out
    assert "RTF=" in out and "overflow: 0" in out
