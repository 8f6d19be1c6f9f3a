"""On the card, at each cell's own size: the program passes every limit
and the control (the reference in the arithmetic below the
configuration's: fp8 for bf16, TF32 for fp32, in the program's place)
fails at least one, on three seeds. Run on the chip:

    python -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

import pytest
import torch

from portbench import calibrate, run

SEEDS = (2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903)
CELLS = {"wsi.conic-bf16.slide40x": ("fp8", 1.0),
         "eval.consep-fp32.images1000": ("tf32", 18.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_passes_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    control, seconds = CELLS[cell]
    limits = run.workload_file(cell)["limits"]
    for row in calibrate.readings(cell, SEEDS, seconds, control):
        passed = {k: row["program"][k] <= v for k, v in limits.items()}
        failed = {k: row["control"][k] > v for k, v in limits.items()}
        assert all(passed.values()), (row, limits)
        assert any(failed.values()), (row, limits)
