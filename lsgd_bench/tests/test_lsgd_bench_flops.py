"""The benchmark's own FLOP count (PaLM's) of one worker's step."""
import json

import pytest

from conftest import MOE, ROOT
from lsgd_bench import flops


def cfg(name):
    return json.loads((ROOT / "lsgd_bench" / "configs" / f"{name}.json").read_text())


# qwen3: 2 x (2 x 5120 x (64 + 8) x 128 + 3 x 5120 x 25600) + 5120 x 18992
# weights; 6 x that x 2,048 tokens + 12 x 2 x 8192 x 1024 x 2,048.
# OLMoE's layers: 2 x (4 x 2048 x 2048 + 2048 x 64 + 8 x 3 x 2048 x 1024)
# + 2048 x 50304; 6 x that x 4,096 + 12 x 2 x 2048 x 512 x 4,096
@pytest.mark.parametrize("name, weights, batch, seq, step", [
    ("qwen3-32b.l2.v8", 1_072_414_720, 2, 1024, 1.35901e13),
    (MOE["name"], 237_502_464, 8, 512, 5.9399e12),
])
def test_worker_step_flops(name, weights, batch, seq, step):
    c = MOE if name == MOE["name"] else cfg(name)
    assert flops.matmul_weights(c) == weights
    assert flops.worker_step_flops(c, batch, seq) == pytest.approx(step, rel=5e-5)


def test_routed_layers_count_only_the_chosen_experts():
    c = MOE
    more = dict(c, num_experts=128)          # more experts, the same top-k
    assert flops.matmul_weights(more) - flops.matmul_weights(c) == \
        2 * c["hidden_size"] * 64
