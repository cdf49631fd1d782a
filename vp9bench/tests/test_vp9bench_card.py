"""On the card: each cell of BENCHMARK.json at its own load, a short
window on three seeds, as it is (correct) and with its control, the
outputs at the next lower precision (not correct). Run with
`python -m pytest vp9bench/tests -m cuda`."""
import time

import pytest
import torch

from vp9bench import control, harness, registry

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
CONTROL_SECONDS = 5.0


def cells():
    return [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("seed", SEEDS)
def test_cell_is_correct_and_its_control_is_not(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = registry.benchmark()
    w, _e, _p = registry.cell(bench, cell)
    bits = registry.config(w["config"])["bit_depth"]
    dev = torch.device("cuda", 0)
    sound = harness.run_cell(cell, seed, CONTROL_SECONDS, False, dev,
                             time.perf_counter(), bench=bench)
    assert sound["correct"], sound["checks"]
    ctl = harness.run_cell(cell, seed, CONTROL_SECONDS, False, dev,
                           time.perf_counter(), bench=bench,
                           output_hook=control.lower_precision(bits))
    print(f"{cell} seed {seed}: sound {sound['checks']}, control "
          f"{ctl['checks']}")
    assert not ctl["correct"]
    assert ctl["checks"]["mismatched_frames"]["value"] > 0
