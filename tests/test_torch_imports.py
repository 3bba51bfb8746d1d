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
    for mod in ("olmoe_1b_7b", "deepseek_v2_lite", "paper_lm", "qwen3_32b",
                "phi4_mini", "minitron_4b", "gemma3_1b", "xlstm_1_3b", "zamba2_7b",
                "whisper_small", "internvl2_76b"):
        assert f"src/repro_torch/configs/{mod}.py" in names, mod
    for mod in ("lm", "blocks", "layers", "mamba2", "xlstm"):
        assert f"src/repro_torch/models/{mod}.py" in names, mod
    for mod in ("common", "paper_tables", "bench_convex", "run"):
        assert f"src/repro_torch/benchmarks/{mod}.py" in names, mod
    for mod in ("quickstart", "train_lm", "hierarchical_local_sgd",
                "adaptive_local_sgd", "convex_logreg",
                "post_local_generalization", "noise_adaptive_frontier",
                "traced_run", "serve_lm", "serve_continuous"):
        assert f"src/repro_torch/examples/{mod}.py" in names, mod
    assert "src/repro_torch/telemetry/metrics.py" in names
    assert "src/repro_torch/launch/inputs.py" in names
    for mod in ("telemetry/trace", "telemetry/export", "checkpoint/checkpoint",
                "checkpoint/__init__", "core/elastic", "serving/paged",
                "serving/engine", "serving/publish", "serving/__init__",
                "backend/__init__", "backend/base", "backend/local",
                "backend/simulated", "backend/distributed",
                "backend/collectives", "sharding/__init__", "sharding/layout"):
        assert f"src/repro_torch/{mod}.py" in names, mod
    bad = []
    for f in PORT_FILES:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_rank_helpers_import_no_jax():
    """The helpers that spawned ranks import (``tests/_torch_*_variants.py``,
    the within-worker grid's included) import no JAX and nothing of the
    JAX package: the ranks run the port alone."""
    helpers = sorted((ROOT / "tests").glob("_torch_*variants.py"))
    assert {h.name for h in helpers} >= {"_torch_dist_variants.py",
                                        "_torch_sharded_variants.py",
                                        "_torch_elastic_variants.py"}
    bad = [f"{h.name}: {m}" for h in helpers for m in _imports(h)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_segment_sum_builds_nothing_on_the_cpu():
    """The segmented sum's kernel (``fb_segment_sum``) is built and loaded
    at its first launch on the card, never at import nor for CPU tensors,
    where the plain version runs; a tensor on another device raises."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import fused_bucket as fb
    assert "fb_segment_sum" in fb._LIB.signatures
    seg = torch.tensor([0, 0, 1, 1, 1, 0], dtype=torch.int32)
    index = fb.segment_index(seg, 2)
    vals = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    assert fb.segment_sum(vals, index).tolist() == [[6.0, 9.0], [24.0, 27.0]]
    assert fb.segment_sum(vals, index, chain=True).tolist() == [30.0, 36.0]
    assert "fused_bucket" not in kbuild._LOADED
    with pytest.raises(ValueError):
        fb.segment_sum(vals.to("meta"), index)


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


def test_registered_archs_import_without_jax():
    """Every arch the port registers resolves (full and smoke) in a fresh
    interpreter where importing jax or repro fails, and its modules
    import nothing of either."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "from repro_torch import configs\n"
            "from repro_torch.models import lm\n"
            "assert len(configs.ARCHS) == 10, configs.ARCHS\n"
            "for a in ('paper-lm',) + configs.ARCHS:\n"
            "    lm.param_specs(configs.get(a)); lm.param_specs(configs.get_smoke(a))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "print('ok' if not bad else bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", (out.stdout, out.stderr)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = RunConfig(model=configs.get_smoke("paper-lm"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train(run, num_workers=2)
    from repro_torch.sharding.layout import train_layout
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train(run, num_workers=2, layout=train_layout(
            ("data", "model"), worker_axes=("data",)).with_sizes(
                {"data": 2, "model": 2}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "deepseek-v2-lite-16b", "--steps", "1"])
    from repro_torch.launch.steps import build_engine, build_serve
    for arch in ("whisper-small", "internvl2-76b"):
        cfg = configs.get_smoke(arch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_serve(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_train(RunConfig(model=cfg), num_workers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(configs.get_smoke("internvl2-76b"),
                     type("S", (), {"global_batch": 2, "seq_len": 16})())
    assert build_train(run, num_workers=2, device="cpu").device.type == "cpu"
    # the tree path across ranks: its backend refuses a worker split over
    # shard ranks before it needs a card, and builds for the card else
    from repro_torch.backend.distributed import DistributedBackend
    with pytest.raises(ValueError, match="whole workers"):
        DistributedBackend(4, use_kernel=False, within_worker_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedBackend(4, use_kernel=False, process_id=0,
                           num_processes=2).rank_device()


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
