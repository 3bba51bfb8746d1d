"""A run without a card, or without the program, fails: another exit
code than 0 and no result line."""
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def run_in(root):
    return subprocess.run(
        [sys.executable, "lsgd_bench/run.py", "--workload", "qwen3-h16-mean",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = run_in(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "lsgd_bench", tmp_path / "lsgd_bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    p = run_in(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
