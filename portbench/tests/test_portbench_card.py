"""The comparison's control and the training step's planted fault, read on
the card at each cell's own size (`control.py`): on every seed the
program's sound run passes every limit, and the control (the reference one
precision below the configuration's in the program's place) fails one.

    python3 -m pytest portbench/tests -m card     # on a machine with the card
"""
import pytest

from portbench import control, run
from portbench.tests.tiny import CELLS

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload, cuda_device):
    limits = run.load_spec(workload)["limits"]
    for row in control.readings(workload, SEEDS, 3.0, device=cuda_device):
        assert all(row[k] <= v for k, v in limits.items()), row
        assert any(row[f"control_{k}"] > v for k, v in limits.items()), row


@pytest.mark.card
@pytest.mark.parametrize("fault", ["half_batch", "half_batch_loss", "unchanged"])
def test_training_faults_fail(fault, cuda_device):
    limits = run.load_spec("clevr.train.b16")["limits"]
    for row in control.readings("clevr.train.b16", SEEDS, 1.0, fault=fault, device=cuda_device):
        assert any(row[k] > v for k, v in limits.items()), row
