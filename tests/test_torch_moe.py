"""Port parity: the capacity-routed MoE FFN (``repro_torch.models.blocks``
vs ``repro.models.blocks``) at the smoke size of both MoE archs.

The JAX weights (``repro.models.base.materialize`` of ``moe_specs``) are
carried over through numpy; the same numpy x goes through both.  Routes
are held first: every token whose top-(k+1) router probabilities are
more than 1e-6 apart takes the same experts in the same order on both
sides (the router's f32 matmul sums in another order, so a closer
near-tie may flip; such tokens are counted, and at these sizes there are
none).  Only then are outputs and gradients compared.

Tolerances: output rtol 1e-5, atol 1e-6, and each gradient leaf rtol
1e-5, atol 1e-6 x its largest entry (float32 matmuls and softmax sums in
another order: gradient entries reach ~50 here, and a sum over the tokens
with cancellation leaves an absolute rounding of ~1e-7 of that on entries
near 0); aux rtol 1e-6 (one float32 dot of length X).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import base as jmbase
from repro.models import blocks as jB
from repro_torch import configs as tconfigs
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.convert import params_from_reference
from repro_torch.models import blocks as tB
from repro_torch.utils import tree_flatten, tree_unflatten

torch.set_num_threads(2)

ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
B, S = 2, 32
RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-6


def _cfgs(arch, capacity_factor=None):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=JMoEConfig(**{**jcfg.moe.__dict__,
                                              "capacity_factor": capacity_factor}))
        tcfg = tcfg.replace(moe=TMoEConfig(**{**tcfg.moe.__dict__,
                                              "capacity_factor": capacity_factor}))
    return jcfg, tcfg


def _setup(arch, seed=0, capacity_factor=None):
    jcfg, tcfg = _cfgs(arch, capacity_factor)
    jp = jmbase.materialize(jB.moe_specs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    g = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, x, g


def _ref_routes(cfg, p, x):
    """The reference's router: probs, and top_i by ``jax.lax.top_k``."""
    xf = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), axis=-1)
    _, top_i = jax.lax.top_k(probs, cfg.moe.top_k)
    return np.asarray(probs), np.asarray(top_i)


def _assert_routes(cfg, jp, x, route):
    """Equal expert choices for every token clear of a near-tie; returns
    the number of near-tie tokens (not compared)."""
    probs, top_i = _ref_routes(cfg, jp, x)
    srt = -np.sort(-probs, axis=-1)[:, :cfg.moe.top_k + 1]
    margin = (srt[:, :-1] - srt[:, 1:]).min(axis=-1)
    clear = margin > MARGIN
    np.testing.assert_array_equal(route.top_i.numpy()[clear], top_i[clear])
    return int((~clear).sum())


def _ref_drops(cfg, top_i, T):
    """Choices past capacity by the reference's rule, in numpy: choice slot
    j by slot j, a token takes the next row of its expert's buffer."""
    C = jB.moe_capacity(cfg, T)
    counts = np.zeros(cfg.moe.num_experts, np.int64)
    valid = np.zeros(top_i.shape, bool)
    for j in range(cfg.moe.top_k):
        for t in range(T):
            e = top_i[t, j]
            valid[t, j] = counts[e] < C
            counts[e] += 1
    return valid


def _ref_apply_and_grads(cfg, jp, x, g):
    def f(p, xx):
        ctx = jB.Ctx(mode="train")
        y = jB.moe_apply(cfg, p, xx, ctx)
        return jnp.sum(y * jnp.asarray(g)) + ctx.aux_losses[0], (y, ctx.aux_losses[0])
    (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    return np.asarray(y), float(aux), gp, np.asarray(gx)


def _port_apply_and_grads(cfg, tp, x, g):
    leaves, treedef = tree_flatten(tp)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    p = tree_unflatten(treedef, leaves)
    xt = torch.from_numpy(x).requires_grad_(True)
    ctx = tB.Ctx(mode="train")
    y = tB.moe_apply(cfg, p, xt, ctx)
    (aux,) = ctx.aux_losses
    (torch.sum(y * torch.from_numpy(g)) + aux).backward()
    return (y.detach().numpy(), float(aux.detach()), [a.grad.numpy() for a in leaves],
            xt.grad.numpy())


def _compare_grads(gp_ref, gp_port, gx_ref, gx_port):
    ref_leaves = jax.tree.leaves(gp_ref)
    assert len(ref_leaves) == len(gp_port)
    for a, b in zip(gp_port + [gx_port], ref_leaves + [gx_ref], strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL,
                                   atol=ATOL * np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_grads_match_reference(arch):
    jcfg, tcfg, jp, x, g = _setup(arch)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    route = tB.moe_route(tcfg, tp["router"], torch.from_numpy(x).reshape(-1, tcfg.d_model))
    assert _assert_routes(jcfg, jp, x, route) == 0
    y_ref, aux_ref, gp_ref, gx_ref = _ref_apply_and_grads(jcfg, jp, x, g)
    y, aux, gp, gx = _port_apply_and_grads(tcfg, tp, x, g)
    np.testing.assert_allclose(y, y_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, aux_ref, rtol=1e-6)
    _compare_grads(gp_ref, gp, gx_ref, gx)
    # the router (first leaf: keys sort) gets a gradient
    assert np.abs(gp[0]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_reference(arch):
    for seed in range(3):
        jcfg, tcfg, jp, x, _ = _setup(arch, seed=seed)
        ctx = jB.Ctx(mode="train")
        jB.moe_apply(jcfg, jp, jnp.asarray(x), ctx)
        tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
        tctx = tB.Ctx(mode="train")
        with torch.no_grad():
            tB.moe_apply(tcfg, tp, torch.from_numpy(x), tctx)
        assert len(tctx.aux_losses) == 1
        np.testing.assert_allclose(float(tctx.aux_losses[0]),
                                   float(ctx.aux_losses[0]), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forced_drops_match_reference(arch):
    """capacity_factor 0.1: C = 4 for 64 tokens, so most choices drop;
    the port drops the same choices and gives the reference's output and
    gradients (the trash row takes every dropped token, and nothing of it
    reaches the output or the gradients)."""
    jcfg, tcfg, jp, x, g = _setup(arch, seed=5, capacity_factor=0.1)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    xf = torch.from_numpy(x).reshape(-1, tcfg.d_model)
    route = tB.moe_route(tcfg, tp["router"], xf)
    assert _assert_routes(jcfg, jp, x, route) == 0
    assert route.capacity == jB.moe_capacity(jcfg, B * S) == 4
    want = _ref_drops(jcfg, route.top_i.numpy(), B * S)
    got = torch.stack(route.valids, dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    n_drop = int((~got).sum())
    assert n_drop > B * S // 2, n_drop
    X, C = tcfg.moe.num_experts, route.capacity
    for s, v in zip(route.slots, route.valids):
        assert bool((s[~v] == X * C).all()) and bool((s[v] < X * C).all())
    y_ref, aux_ref, gp_ref, gx_ref = _ref_apply_and_grads(jcfg, jp, x, g)
    y, aux, gp, gx = _port_apply_and_grads(tcfg, tp, x, g)
    np.testing.assert_allclose(y, y_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, aux_ref, rtol=1e-6)
    _compare_grads(gp_ref, gp, gx_ref, gx)


@pytest.mark.parametrize("arch", ARCHS + ("full:olmoe-1b-7b",
                                          "full:deepseek-v2-lite-16b"))
def test_moe_capacity_matches_reference(arch):
    if arch.startswith("full:"):
        jcfg, tcfg = (jconfigs.get(arch[5:]), tconfigs.get(arch[5:]))
    else:
        jcfg, tcfg = _cfgs(arch)
    for T in list(range(1, 70)) + [127, 128, 512, 1000, 4096, 8192, 65536]:
        assert tB.moe_capacity(tcfg, T) == jB.moe_capacity(jcfg, T), T


def test_exact_ties_take_the_lower_expert_first():
    """A router that gives every expert the same probability: the choices
    are experts 0..k-1 in order, as ``jax.lax.top_k`` gives them."""
    _, tcfg = _cfgs("olmoe-1b-7b")
    xf = torch.randn(16, tcfg.d_model)
    route = tB.moe_route(tcfg, torch.zeros(tcfg.d_model, tcfg.moe.num_experts), xf)
    K = tcfg.moe.top_k
    assert torch.equal(route.top_i, torch.arange(K).expand(16, K))
    _, top_i = jax.lax.top_k(jnp.full((16, tcfg.moe.num_experts), 0.25), K)
    np.testing.assert_array_equal(route.top_i.numpy(), np.asarray(top_i))


@pytest.mark.parametrize("arch", ARCHS)
def test_record_routes_collects_each_moe_call(arch):
    """``record_routes`` yields the Routing of every ``moe_apply`` call
    made inside it, in call order (a nested context sees only its own
    calls), each the routing ``moe_route`` gives the same input; nothing
    is kept once the contexts close.  The recorded drops are the
    reference's at a capacity factor that forces drops."""
    jcfg, tcfg, jp, x, _ = _setup(arch, capacity_factor=0.5)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        with tB.record_routes() as outer:
            tB.moe_apply(tcfg, tp, xt, tB.Ctx())
            with tB.record_routes() as inner:
                tB.moe_apply(tcfg, tp, 2 * xt, tB.Ctx())
        tB.moe_apply(tcfg, tp, xt, tB.Ctx())
    assert len(outer) == 2 and len(inner) == 1 and inner[0] is outer[1]
    assert tB._ROUTE_SINKS == []
    want = tB.moe_route(tcfg, tp["router"], xt.reshape(-1, tcfg.d_model))
    got = outer[0]
    assert torch.equal(got.top_i, want.top_i) and got.capacity == want.capacity
    assert all(torch.equal(a, b) for a, b in zip(got.slots, want.slots))
    _, top_i = _ref_routes(jcfg, jp, x)
    ref_valid = _ref_drops(jcfg, top_i, B * S)
    assert 0 < int((~ref_valid).sum()) == int((~torch.stack(got.valids)).sum())
