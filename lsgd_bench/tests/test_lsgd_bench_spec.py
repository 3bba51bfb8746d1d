"""The harness finds every cell, configuration, traffic mix, limit file
and metric reader by name, and refuses an unknown one."""
import json
import re

import pytest

from conftest import CELLS, ROOT
from lsgd_bench import run as R

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    files = R.cell_files(BENCH, cell)
    assert files["config"]["name"] == files["workload"]["config"]
    assert R.check.compared(files["limits"])
    assert {m["name"] for m in files["end_to_end"]} >= {"tokens_per_s", "setup_s"}
    for m in files["per_layer"]:
        assert callable(R.metric_reader(m["name"]).read)


def test_unknown_names_are_refused():
    with pytest.raises(R.Failure, match="unknown workload"):
        R.cell_files(BENCH, "no-such-cell")
    with pytest.raises(R.Failure, match="no reader"):
        R.metric_reader("no_such_metric")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert list(CELLS) == ["qwen3-h16-mean"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert "tf32" not in cfg          # float32 with TF32 off, always
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024
