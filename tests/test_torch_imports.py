"""Rules of the port: ``src/repro_torch`` and ``chip_smoke.py`` import no
JAX, nothing of the JAX package and nothing of the reference's top-level
``benchmarks`` harness (which imports JAX); entry points never fall back
to the CPU on their own; ``chip_smoke.py`` refuses to run without a card
or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train
from repro_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], (ast.Constant, ast.JoinedStr)):
            arg = node.args[0]
            yield (arg.value if isinstance(arg, ast.Constant)
                   else "".join(v.value for v in arg.values
                                if isinstance(v, ast.Constant)))


def test_port_imports_no_jax_and_nothing_of_repro():
    assert len(PORT_FILES) > 20
    names = {f.relative_to(ROOT).as_posix() for f in PORT_FILES}
    for mod in ("fused_bucket", "fused_sgd", "sign_compress", "flash_attention",
                "ops", "ref", "build"):
        assert f"src/repro_torch/kernels/{mod}.py" in names, mod
    for mod in ("controller", "noise", "syncplan", "local_sgd"):
        assert f"src/repro_torch/core/{mod}.py" in names, mod
    for mod in ("common", "paper_tables", "bench_convex", "run"):
        assert f"src/repro_torch/benchmarks/{mod}.py" in names, mod
    assert "src/repro_torch/telemetry/metrics.py" in names
    bad = []
    for f in PORT_FILES:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_port_modules_import_without_jax():
    """Import every port module in a fresh interpreter where importing
    jax or repro fails."""
    mods = [".".join(f.relative_to(ROOT / "src").with_suffix("").parts)
            for f in PORT_FILES if f.name != "chip_smoke.py"]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            f"import importlib\nfor m in {mods!r}:\n    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = RunConfig(model=configs.get_smoke("paper-lm"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train(run, num_workers=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1"])
    assert build_train(run, num_workers=2, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""            # no card, even on a GPU host
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, env=env, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
