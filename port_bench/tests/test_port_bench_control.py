"""The control of each cell, on the card at the cell's own size on three
seeds: the reference computed in bfloat16, put in the port's place, is not
correct by the cell's limits (and for a fit, neither is the loss taken over
half of the image's columns). Run on a card: ``python -m pytest
port_bench/tests/test_port_bench_control.py -q -o addopts="" -s``."""
import pytest
import torch

from port_bench import calibrate, core

CELLS = [w["name"] for w in core.Manifest().data["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size: it needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 3, 4099])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, seed):
    m = core.Manifest()
    limits = m.cell(cell).params["limits"]
    out = calibrate.control(cell, seed, 3.0, m)
    print(cell, seed, out)
    for name, readings in out.items():
        assert any(readings[k] > lim for k, lim in limits.items()), (name, readings)
