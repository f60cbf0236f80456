"""The control at the route cell's own size, on the card: on three blocks
of the cell's set the program's answers read within the cell's limits and
the control's, the float32 route without the float64 refinement, fail one
of them.  Run on the card with ``python -m pytest portbench/tests -m gpu``."""
import pytest
import torch

from portbench import control
from portbench import run as harness

SEED = 3000000101


@pytest.mark.gpu
def test_control_fails_and_program_passes_at_the_cell_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's size runs on the card")
    limits = harness.load_json("workloads", "route-100k-block.json")["limits"]
    sound = control.readings("route-100k-block", [SEED], 3, control=False)
    low = control.readings("route-100k-block", [SEED], 3, control=True)
    for row in sound:
        assert row["certified"] and all(row[k] <= v for k, v in limits.items()), row
    for row in low:
        assert any(row[k] > v for k, v in limits.items()), row
