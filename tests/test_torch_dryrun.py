"""The port's dry run (``repro_torch.launch.dryrun``) and layer-period
probe (``repro_torch.roofline.probe``) on the CPU.

* A smoke config's ``meta`` trace equals a CPU run of the same call
  exactly: FLOPs by op (``FlopCounterMode``) and the bytes saved for the
  backward (each storage once), for every registry family and paper-lm.
* ``m_reckon`` / ``x_depth`` give the values ``chip_smoke.py``'s phase
  comments pin (deepseek at 2 layers 95.3 GB; X2's depth 2 of 80), and a
  record's ``n_params`` is the reference's.
* The 1- and 2-period extrapolation equals the full-depth ``meta`` count
  for paper-lm and for xlstm-1.3b (a period of 8 layers).
* The CLIs: a pair's record, a one-card record, a named failure with a
  non-zero exit; the report and the markdown sections written only
  under ``--out``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape, RunConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_grid
from repro_torch.roofline import probe

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tuple(configs.ARCHS) + ("paper-lm",)
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trace_equals_cpu_run(arch):
    """FLOPs and saved bytes of one worker's loss and gradient: the meta
    trace is the CPU run's, exactly (the shapes carry no data)."""
    cfg = configs.get_smoke(arch)
    meta = dryrun.trace_train(cfg, 2, 64, device="meta")
    cpu = dryrun.trace_train(cfg, 2, 64, device="cpu")
    for k in ("flops", "flops_by_op", "saved_bytes", "saved_storages",
              "logits_grad_bytes"):
        assert meta[k] == cpu[k], k
    assert meta["flops"] > 0 and meta["saved_bytes"] > 0
    # the logits' gradient: every loss position x the vocabulary, f32
    batch = dryrun.worker_batch(cfg, 2, 64, "meta")
    assert meta["logits_grad_bytes"] == dryrun.logits_rows(batch) * \
        cfg.vocab_size * 4


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-small", "xlstm-1.3b",
                                  "deepseek-v2-lite-16b", "internvl2-76b"])
def test_meta_serve_equals_cpu_run(arch, kind):
    cfg = configs.get_smoke(arch)
    shape = InputShape(kind, 32, 2, INPUT_SHAPES[kind].kind)
    meta = dryrun.trace_serve(cfg, shape, device="meta")
    cpu = dryrun.trace_serve(cfg, shape, device="cpu")
    for k in ("flops", "flops_by_op", "cache_bytes", "param_bytes"):
        assert meta[k] == cpu[k], k


def test_m_reckon_and_x_depth_pinned():
    """The readings ``chip_smoke.py``'s phase comments cite."""
    ds = dryrun.m_reckon(configs.get("deepseek-v2-lite-16b").replace(
        num_layers=2), 2, "ef_sign")
    assert ds["params"] == 1_589_128_192 and ds["sync_copies"] == 15
    assert round(ds["copy_bytes"] / 1e9, 2) == 6.36
    assert round(ds["reckoned_peak_bytes"] / 1e9, 1) == 95.3
    wh = dryrun.m_reckon(configs.get("whisper-small"), 4, "ef_sign")
    assert wh["sync_copies"] == 29 and round(wh["reckoned_peak_bytes"] / 1e9, 1) == 32.3
    zb = dryrun.m_reckon(configs.get("zamba2-7b").replace(num_layers=12), 2,
                         "none")
    assert zb["params"] == 1_522_983_968 and round(zb["reckoned_peak_bytes"] / 1e9, 1) == 42.6
    assert dryrun.x_depth(configs.get("internvl2-76b"), 1, "none") == 2
    assert round(dryrun.m_reckon(configs.get("internvl2-76b").replace(
        num_layers=2), 1, "none")["reckoned_peak_bytes"] / 1e9, 1) == 62.1


def test_reckon_card_adds_activations():
    cfg = configs.get_smoke("paper-lm")
    t = dryrun.trace_train(cfg, 2, 64)
    rc = dryrun.reckon_card(cfg, t, workers=4, mode="ef_sign")
    m = dryrun.m_reckon(cfg, 4, "ef_sign")
    assert rc["state_bytes"] == m["reckoned_peak_bytes"]
    assert rc["step_peak_bytes"] == m["step_copies"] * m["copy_bytes"] + \
        t["saved_bytes"] + t["logits_grad_bytes"]
    assert rc["peak_bytes"] == max(rc["step_peak_bytes"], rc["sync_peak_bytes"])
    assert rc["flops_worker"] == t["flops"]


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_grid_record(layout):
    """A train pair on the 16 x 16 grid: the reference's parameter count,
    W from the layout, an FSDP shard rank's share of the batch, the sync's
    ring bytes over the shard's rows."""
    grid = make_production_grid()
    rec = dryrun.dryrun_train("gemma3-1b", INPUT_SHAPES["train_4k"], grid,
                              layout)
    jcfg = jconfigs.get("gemma3-1b")
    assert rec["n_params"] == jmbase.count_params(jlm.param_specs(jcfg))
    assert rec["num_workers"] == 16 and rec["local_batch"] == 16
    pc = rec["per_card"]
    split = 16 if layout == "fsdp" else 1
    assert pc["batch_split"] == split and pc["shard_ranks"] == 16
    ls = rec["local_step"]
    assert ls["flops"] == ls["flops_worker"] / split
    assert pc["peak_bytes"] == pc["state_bytes"] + pc["buffer_bytes"] + \
        pc["activation_bytes"] + pc["logits_grad_bytes"]
    assert rec["sync"]["collectives"]["moved_bytes"] > 0
    assert ls["collectives"]["count"] == (2 if layout == "fsdp" else 1)
    assert 1 <= pc["max_layers"] <= jcfg.num_layers


@pytest.mark.parametrize("arch", ["paper-lm", "xlstm-1.3b"])
def test_period_probe_extrapolates_exactly(arch):
    """fixed + slope x (L / period) from 1 and 2 periods is the full-depth
    trace, exactly, for a model of whole identical periods."""
    cfg = configs.get(arch)
    assert cfg.num_layers % len(cfg.blocks) == 0
    run = RunConfig(model=cfg, shape=InputShape("p", 16, 2, "train"))
    out = probe.probe_card(run, workers=2, device="meta")
    full = dryrun.trace_train(cfg, 1, 16)
    assert out["flops_full"] == 2 * full["flops"]
    assert out["saved_bytes_full"] == full["saved_bytes"]
    assert out["period"] == len(cfg.blocks)
    pp = dryrun.period_probe(cfg, 1, 16)
    assert pp["flops_fixed"] + pp["flops_per_period"] * (
        cfg.num_layers / pp["period"]) == full["flops"]


def _cli(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, env=ENV)


def test_dryrun_cli_pair_card_and_failure(tmp_path):
    res = _cli("repro_torch.launch.dryrun", "--arch", "gemma3-1b", "--shape",
               "decode_32k", "--device", "meta", "--out", str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    rec = json.loads((tmp_path / "gemma3-1b__decode_32k__16x16.json").read_text())
    assert rec["kind"] == "decode" and rec["decode"]["flops"] > 0
    assert rec["decode"]["cache_bytes"] > 0
    res = _cli("repro_torch.launch.dryrun", "--arch", "paper-lm", "--workers",
               "4", "--local-batch", "8", "--seq", "512", "--device", "meta",
               "--out", str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["max_layers"] == 12 and line["flops"] == 4 * 3_169_685_864_448
    res = _cli("repro_torch.launch.dryrun", "--arch", "no-such-arch", "--shape",
               "train_4k", "--device", "meta", "--out", str(tmp_path))
    assert res.returncode == 1
    assert "FAIL no-such-arch__train_4k__16x16" in res.stdout
    assert "1 dry-run failures" in res.stdout


def test_report_cli_writes_under_out(tmp_path):
    out = tmp_path / "out"
    res = _cli("repro_torch.roofline.report", "--dryrun", str(tmp_path),
               "--out", str(out))
    assert res.returncode == 0, res.stderr[-2000:]
    rows = json.loads((out / "roofline.json").read_text())
    assert len(rows) == len(configs.runnable_pairs())
    for a, s in configs.runnable_pairs():
        assert f"| {a} | {s} |" in res.stdout
    res = _cli("repro_torch.roofline.experiments_md", "--dryrun",
               str(tmp_path), "--out", str(out))
    assert res.returncode == 0, res.stderr[-2000:]
    assert sorted(p.name for p in out.iterdir()) == ["experiments.md",
                                                     "roofline.json"]


def test_cli_needs_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run on it")
    res = _cli("repro_torch.launch.dryrun", "--arch", "gemma3-1b", "--shape",
               "train_4k")
    assert res.returncode != 0 and "no CUDA device" in res.stderr


@pytest.mark.parametrize("seq", [128, 256])
def test_token_loop_extrapolation_is_exact(seq, monkeypatch):
    """A model with sLSTM blocks is traced at two shorter lengths and its
    counts taken to the pair's length: at smoke size (chunks of 16, the
    probe at 32 and 64 positions) they are the full trace's, exactly,
    for the step and for a prefill."""
    monkeypatch.setattr(dryrun, "SEQ_PROBE", 32)
    cfg = configs.get_smoke("xlstm-1.3b")
    got, want = dryrun.trace_train(cfg, 2, seq), dryrun._trace_train(cfg, 2, seq)
    assert got["seq_extrapolated_from"] == [32, 64]
    for k in ("flops", "flops_by_op", "saved_bytes", "logits_grad_bytes"):
        assert got[k] == want[k], k
    shape = InputShape("prefill_32k", seq, 2, "prefill")
    got, want = dryrun.trace_serve(cfg, shape), dryrun._trace_serve(cfg, shape)
    for k in ("flops", "flops_by_op", "cache_bytes", "param_bytes"):
        assert got[k] == want[k], k
    # a model without a per-token loop is traced in full
    assert "seq_extrapolated_from" not in dryrun.trace_train(
        configs.get_smoke("zamba2-7b"), 2, seq)
