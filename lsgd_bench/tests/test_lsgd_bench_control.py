"""The control on the card: the reference computed with TF32 matmuls (the
precision below the configurations' float32), put in the program's
place, is not correct under the cell's limits.  At the cells' widths
with 2 layers and 2 workers of 2 x 512 tokens; ``calibrate.py`` reads
it at the cells' own size."""
import pytest

from conftest import CELLS, ROOT
from lsgd_bench import calibrate, check
from lsgd_bench import run as R


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(cuda, cell):
    files = R.cell_files(R.load_json(ROOT / "BENCHMARK.json"), cell)
    cfg, traffic = files["config"], files["traffic"]
    cfg["num_hidden_layers"] = 2
    traffic.update(workers=2, local_batch=2)
    bats = R.data.batches(cfg, traffic, 3, cuda)
    ref = R.reference_readings(cfg, traffic, 3, bats, cuda)
    control = calibrate.control_readings(cfg, traffic, 3, bats, cuda)
    ok, failed = check.judge(check.numbers(control, ref), files["limits"])
    assert not ok and failed >= 1
