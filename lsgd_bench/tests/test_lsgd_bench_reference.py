"""The reference against the port at small sizes on the CPU: the loss and
every gradient of one worker, and whole runs of each cell (set-up, a
short window, the comparison), which come out correct."""
import time

import pytest
import torch

from conftest import CELLS, MOE, ROOT, small, small_files
from lsgd_bench import data, program, weights
from lsgd_bench import run as R
from lsgd_bench.reference import lm as ref_lm


def small_model(config: str):
    cfg = (dict(MOE) if config == MOE["name"] else
           R.load_json(ROOT / "lsgd_bench" / "configs" / f"{config}.json"))
    return small(cfg, R.load_json(ROOT / "lsgd_bench" / "traffic" / "h16-mean.json"))


@pytest.mark.parametrize("config", ["qwen3-32b.l2.v8", MOE["name"]])
def test_loss_and_gradients_match_the_port(config):
    from repro_torch.models import lm
    cfg, traffic = small_model(config)
    bundle = program.build(cfg, traffic, "cpu")
    shapes = ref_lm.param_shapes(cfg)
    assert program.spec_shapes(bundle) == shapes
    w = {n: v.clone().requires_grad_(True)
         for n, v in weights.make(shapes, 5, "cpu").items()}
    b = data.batches(cfg, traffic, 5, "cpu")[0]
    tok, lab = b["tokens"][0], b["labels"][0]
    ours, _ = ref_lm.loss(cfg, w, tok, lab)
    theirs, _ = lm.loss_fn(bundle.cfg, program.tree_of(bundle, w),
                           {"tokens": tok, "labels": lab})
    assert ours.item() == pytest.approx(theirs.item(), rel=1e-6)
    names = sorted(w)
    g1 = torch.autograd.grad(ours, [w[n] for n in names])
    g2 = torch.autograd.grad(theirs, [w[n] for n in names])
    for n, a, c in zip(names, g1, g2):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6, msg=n)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = R.run(small_files(cell), cell, 2 ** 31 + 77, 0.2, False,
                device="cpu", t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["metrics"]["tokens_per_s"]["value"] > 0


def test_the_same_seed_makes_the_same_inputs():
    cfg, traffic = small_model(MOE["name"])
    shapes = ref_lm.param_shapes(cfg)
    a, b = weights.make(shapes, 9, "cpu"), weights.make(shapes, 9, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in shapes)
    assert not torch.equal(a["embed"], weights.make(shapes, 10, "cpu")["embed"])
    x, y = data.batches(cfg, traffic, 9, "cpu"), data.batches(cfg, traffic, 9, "cpu")
    assert all(torch.equal(p["tokens"], q["tokens"]) for p, q in zip(x, y))
    rows = torch.cat([p["tokens"].reshape(-1, traffic["seq_len"]) for p in x])
    assert len({tuple(r.tolist()) for r in rows}) == len(rows)


@pytest.mark.parametrize("compression, wire", [("sign", False), ("sign", True),
                                               ("ef_sign", False), ("ef_sign", True)])
def test_compressed_syncs_match_the_port(compression, wire):
    """The reference's sign / EF-sign syncs, with and without the 1-bit
    wire pack (no cell runs them yet), against the port's after every
    step.  The losses agree to a few ulps and the gradients to 1e-5; of
    the change, the median leaf is compared (under 1e-6 on seeds 1-3):
    the worst leaf moves by the sign flips of elements whose input lies
    within rounding of 0 (up to 7e-5 at this size)."""
    files = small_files(CELLS[0])
    cfg, traffic = files["config"], files["traffic"]
    traffic.update(sync_compression=compression, wire_pack=wire, local_steps=1)
    _, _, bats, readings = R.setup(cfg, traffic, 2, "cpu")
    nums = R.check.numbers(R.to_host(readings),
                           R.reference_readings(cfg, traffic, 2, bats, "cpu"))
    assert nums["loss_gap"] <= 1e-6 and nums["grad_gap"] <= 1e-5, nums
    assert nums["change_gap_median"] <= 1e-5, nums
