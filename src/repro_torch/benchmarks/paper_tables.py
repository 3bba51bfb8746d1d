"""One benchmark per paper table/figure (CIFAR -> synthetic stand-in), on
the port (the twin of the top-level ``benchmarks/paper_tables.py``, with
its row names and ``derived`` fields).

Each function emits CSV rows ``name,us_per_call,derived`` where
``derived`` carries the table's headline quantity (accuracy, speedup,
communication rounds, eigenvalue, ...).  ``device=None`` means the card.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from repro_torch.benchmarks.common import (dataset, emit, mlp_init, mlp_loss,
                                           test_acc, train_local_sgd, wall_timer)
from repro_torch.core.local_sgd import mean_params
from repro_torch.core.noise import gradient_noise_trace
from repro_torch.utils import resolve_device, tree_flatten, tree_unflatten

STEPS = 240
TRAIN, TEST = None, None


def _data():
    global TRAIN, TEST
    if TRAIN is None:
        TRAIN, TEST = dataset()
    return TRAIN, TEST


# ---------------------------------------------------------------------------
# Figure 1 + Table 2: generalization gap and post-local SGD closing it
# ---------------------------------------------------------------------------

def fig1_rows(steps):
    """Figure 1's (name, train_local_sgd kwargs) for a run of ``steps``."""
    return (
        ("A1_small_mb", dict(K=1, B_loc=64, H=1)),
        ("A2_large_mb", dict(K=8, B_loc=64, H=1)),
        ("A3_huge_mb", dict(K=8, B_loc=256, H=1, lr=0.05)),
        ("A4_local_sgd", dict(K=8, B_loc=64, H=4)),
        ("A5_post_local", dict(K=8, B_loc=64, H=4,
                               post_local_switch=steps // 2)),
    )


def fig1_generalization_gap(device=None):
    train, test = _data()
    accs = {}
    for name, kw in fig1_rows(STEPS):
        with wall_timer(f"fig1/{name}") as w:
            st, comm, _ = train_local_sgd(steps=STEPS, train=train,
                                          device=device, **kw)
        accs[name] = test_acc(st, test)
        emit(f"fig1/{name}", w["us"] / STEPS,
             f"test_acc={accs[name]:.4f};comm_rounds={comm}")
    # headline claims, qualitative: post-local >= large-batch baseline
    emit("fig1/gap_closed", 0.0,
         f"post_minus_large={accs['A5_post_local'] - accs['A2_large_mb']:+.4f}")


def table2_postlocal_vs_minibatch(device=None):
    train, test = _data()
    combos = [("mb_K4", dict(K=4, B_loc=64, H=1)),
              ("local_H8_K4", dict(K=4, B_loc=64, H=8)),
              ("post_H8_K4", dict(K=4, B_loc=64, H=8,
                                  post_local_switch=STEPS // 2))]
    for name, kw in combos:
        with wall_timer(f"table2/{name}") as w:
            st, comm, _ = train_local_sgd(steps=STEPS, train=train,
                                          device=device, **kw)
        emit(f"table2/{name}", w["us"] / STEPS,
             f"test_acc={test_acc(st, test):.4f};comm_rounds={comm}")


# ---------------------------------------------------------------------------
# Table 1 / Figure 2(a): scalability of local SGD over K and H
# ---------------------------------------------------------------------------

def table1_scaling(device=None):
    """Time-to-accuracy speedup model: measured per-step compute time +
    simulated communication cost (the paper's App. B.2 protocol, comm =
    25x one gradient step)."""
    train, test = _data()
    comm_cost = 25.0  # in units of one local gradient step
    base_time = None
    for K in (1, 2, 4, 8):
        for H in (1, 2, 4, 8):
            if K == 1 and H > 1:
                continue
            st, comm, _ = train_local_sgd(steps=STEPS, train=train, K=K,
                                          B_loc=32, H=H, device=device)
            acc = test_acc(st, test)
            # simulated wall time: steps (compute, perfectly parallel) + comm
            sim = STEPS + comm * comm_cost
            if K == 1 and H == 1:
                base_time = sim
            speedup = base_time / sim if base_time else 1.0
            emit(f"table1/K{K}_H{H}", sim,
                 f"speedup={speedup:.2f};test_acc={acc:.4f};comm_rounds={comm}")


def fig2b_same_effective_batch(device=None):
    """Local SGD vs mini-batch SGD at the same effective batch K*H*B."""
    train, test = _data()
    for K in (4, 8):
        stl, _, _ = train_local_sgd(steps=STEPS, train=train, K=K, B_loc=32,
                                    H=4, device=device)
        stm, _, _ = train_local_sgd(steps=STEPS, train=train, K=K, B_loc=128,
                                    H=1, lr=0.08, device=device)
        emit(f"fig2b/K{K}", 0.0,
             f"local_H4_acc={test_acc(stl, test):.4f};"
             f"minibatch_same_eff_acc={test_acc(stm, test):.4f}")


# ---------------------------------------------------------------------------
# Table 4: post-local SGD + sign compression
# ---------------------------------------------------------------------------

def table4_rows(steps):
    """Table 4's (name, train_local_sgd kwargs) for a run of ``steps``."""
    return tuple((name, dict(K=8, B_loc=32, lr=0.05, **kw)) for name, kw in (
        ("signSGD_H1", dict(sync_compression="sign", H=1)),
        ("signSGD_post_H8", dict(sync_compression="sign", H=8,
                                 post_local_switch=steps // 2)),
        ("EFsign_H1", dict(sync_compression="ef_sign", H=1)),
        ("EFsign_post_H8", dict(sync_compression="ef_sign", H=8,
                                post_local_switch=steps // 2))))


def table4_sign_compression(device=None):
    train, test = _data()
    for name, kw in table4_rows(STEPS):
        st, comm, _ = train_local_sgd(steps=STEPS, train=train, device=device,
                                      **kw)
        emit(f"table4/{name}", 0.0,
             f"test_acc={test_acc(st, test):.4f};comm_rounds={comm}")


# ---------------------------------------------------------------------------
# Table 8: local x global momentum grid
# ---------------------------------------------------------------------------

def table8_momentum(device=None):
    train, test = _data()
    for gm in (0.0, 0.3, 0.9):
        st, _, _ = train_local_sgd(steps=STEPS, train=train, K=4, B_loc=32,
                                   H=2, local_momentum=0.9, global_momentum=gm,
                                   device=device)
        emit(f"table8/local0.9_global{gm}", 0.0,
             f"test_acc={test_acc(st, test):.4f}")


# ---------------------------------------------------------------------------
# Table 14: isotropic noise injection baseline (Neelakantan et al.)
# ---------------------------------------------------------------------------

def table14_noise_injection(device=None):
    train, test = _data()
    st_post, _, _ = train_local_sgd(steps=STEPS, train=train, K=8, B_loc=64,
                                    H=4, post_local_switch=STEPS // 2,
                                    device=device)
    st_noise, _, _ = train_local_sgd(steps=STEPS, train=train, K=8, B_loc=64,
                                     H=1, noise_eta=1e-4, device=device)
    st_mb, _, _ = train_local_sgd(steps=STEPS, train=train, K=8, B_loc=64, H=1,
                                  device=device)
    emit("table14/post_local", 0.0, f"test_acc={test_acc(st_post, test):.4f}")
    emit("table14/isotropic_noise", 0.0, f"test_acc={test_acc(st_noise, test):.4f}")
    emit("table14/minibatch", 0.0, f"test_acc={test_acc(st_mb, test):.4f}")


# ---------------------------------------------------------------------------
# Table 16/17: hierarchical local SGD
# ---------------------------------------------------------------------------

def table16_rows():
    """Table 16's (name, train_local_sgd kwargs): H * H^b = 8 fixed."""
    return tuple((f"H{H}_Hb{Hb}", dict(K=8, B_loc=32, H=H, block_steps=Hb))
                 for H, Hb in ((1, 8), (2, 4), (4, 2), (8, 1)))


def sync_split(comm: int, block_steps: int) -> tuple[int, int]:
    """(global, block) syncs of ``comm`` rounds: every ``block_steps``-th
    sync is global."""
    glob = comm // block_steps if block_steps > 1 else comm
    return glob, comm - glob


def table16_hierarchical(device=None):
    """H * H^b = 8 fixed; vary the split; communication counted per level."""
    train, test = _data()
    for name, kw in table16_rows():
        st, comm, _ = train_local_sgd(steps=STEPS, train=train, device=device,
                                      **kw)
        glob, block = sync_split(comm, kw["block_steps"])
        emit(f"table16/{name}", 0.0,
             f"test_acc={test_acc(st, test):.4f};global_sync={glob};"
             f"block_sync={block}")


def table17_network_delay_tolerance():
    """Simulated time with slow outer links (paper Fig. 19): outer sync
    costs 50x an inner sync."""
    for H, Hb in [(2, 1), (2, 4), (2, 16)]:
        steps = 128
        syncs = steps // H
        glob = syncs // Hb
        block = syncs - glob
        sim = steps + block * 1.0 + glob * 50.0
        emit(f"table17/H{H}_Hb{Hb}", sim, f"sim_time_units={sim:.0f}")


# ---------------------------------------------------------------------------
# Figure 4 / 13 / 14: flatness — dominant Hessian eigenvalue (power iter)
# ---------------------------------------------------------------------------

def _hvp(params, batch):
    """(flat params, u -> H u): the loss Hessian at ``params`` times a flat
    vector, forward over reverse (``jvp`` of ``grad``), with the leaves
    flattened in tree order (the reference's ``ravel_pytree`` order)."""
    leaves, treedef = tree_flatten(params)
    shapes = [l.shape for l in leaves]
    sizes = [l.numel() for l in leaves]
    flat = torch.cat([l.reshape(-1) for l in leaves]).detach()

    def loss_flat(f):
        parts = [p.reshape(s) for p, s in zip(torch.split(f, sizes), shapes)]
        return mlp_loss(tree_unflatten(treedef, parts), batch)[0]

    return flat, lambda u: jvp(grad(loss_flat), (flat,), (u,))[1]


def _dominant_eig(params, batch, iters=20, seed=0):
    """lambda_max of the loss Hessian by power iteration from a normal
    vector drawn by a generator seeded with ``seed``, on the params'
    device."""
    flat, hvp = _hvp(params, batch)
    gen = torch.Generator(device=flat.device).manual_seed(seed)
    v = torch.randn(flat.shape, generator=gen, device=flat.device)
    v = v / torch.linalg.vector_norm(v)
    lam = 0.0
    for _ in range(iters):
        hv = hvp(v)
        lam = float(torch.dot(v, hv))
        v = hv / (torch.linalg.vector_norm(hv) + 1e-12)
    return lam


def fig4_flatness(device=None):
    dev = resolve_device(device)
    train, test = _data()
    batch = {"x": torch.as_tensor(train["x"][:1024]).to(dev),
             "y": torch.as_tensor(train["y"][:1024]).to(dev, torch.int64)}
    st_mb, _, _ = train_local_sgd(steps=STEPS, train=train, K=8, B_loc=64, H=1,
                                  device=dev)
    st_post, _, _ = train_local_sgd(steps=STEPS, train=train, K=8, B_loc=64,
                                    H=4, post_local_switch=STEPS // 2,
                                    device=dev)
    pm, pp = mean_params(st_mb), mean_params(st_post)
    em = _dominant_eig(pm, batch)
    ep = _dominant_eig(pp, batch)
    emit("fig4/minibatch_eig", 0.0, f"lambda_max={em:.4f};acc={test_acc(pm, test):.4f}")
    emit("fig4/postlocal_eig", 0.0, f"lambda_max={ep:.4f};acc={test_acc(pp, test):.4f}")
    emit("fig4/flatter", 0.0, f"postlocal_minus_minibatch={ep - em:+.4f}")


# ---------------------------------------------------------------------------
# Section 5 eq. (4): K * Sigma(w) noise amplification
# ---------------------------------------------------------------------------

SEC5_BATCHES = (16, 32, 64, 128)


def noise_traces(params, train, device=None) -> dict:
    """{B_loc: tr(Sigma) estimate} from 16 workers' gradients at
    ``params``, each on B_loc examples drawn by ``default_rng(0)`` (the
    reference's index draws), per-worker gradients by ``vmap(grad)``."""
    dev = resolve_device(device)
    gfun = vmap(grad(lambda p, b: mlp_loss(p, b)[0]), in_dims=(None, 0))
    rng = np.random.default_rng(0)
    traces = {}
    for B in SEC5_BATCHES:
        idx = rng.integers(0, len(train["x"]), size=(16, B))
        batch = {"x": torch.as_tensor(train["x"][idx]).to(dev),
                 "y": torch.as_tensor(train["y"][idx]).to(dev, torch.int64)}
        tr, _ = gradient_noise_trace(gfun(params, batch))
        traces[B] = float(tr)
    return traces


def sec5_noise_scale(device=None):
    """Between-worker gradient variance scales ~1/B_loc (eq. 4): halving
    B_loc (the local SGD regime) doubles the injected noise trace."""
    dev = resolve_device(device)
    train, _ = _data()
    params = {k: v.to(dev) for k, v in
              mlp_init(torch.Generator().manual_seed(0)).items()}
    traces = noise_traces(params, train, dev)
    for B, tr in traces.items():
        emit(f"sec5/noise_trace_B{B}", 0.0, f"trace={tr:.5f}")
    ratio = traces[16] / max(traces[128], 1e-12)
    emit("sec5/trace_ratio_16_vs_128", 0.0, f"ratio={ratio:.2f};expected~8")


# ---------------------------------------------------------------------------
# Figures 10/11 (App. B.4.2): local-step warmup strategies
# ---------------------------------------------------------------------------

def fig10_warmup(device=None):
    """H warmed up 1 -> 8 with linear / exponential / constant schedules vs
    constant-H local SGD (the paper finds warmup unconvincing; we report
    the comparison)."""
    train, test = _data()
    rows = [("constH8", None)] + [(f"warmup_{k}", k)
                                  for k in ("linear", "exp", "constant")]
    for name, kind in rows:
        if kind is None:
            st, comm, _ = train_local_sgd(steps=STEPS, train=train, K=8,
                                          B_loc=32, H=8, device=device)
        else:
            st, comm, _ = _train_with_warmup(kind, train, device=device)
        emit(f"fig10/{name}", 0.0,
             f"test_acc={test_acc(st, test):.4f};comm_rounds={comm}")


def _train_with_warmup(kind, train, *, device=None, params0=None):
    """K=8, B_loc=32, H ramped to 8 over the first STEPS // 4 steps with
    the ``kind`` schedule; every sync global."""
    return train_local_sgd(steps=STEPS, train=train, K=8, B_loc=32, H=8,
                           warmup_kind=kind, warmup_steps=STEPS // 4,
                           params0=params0, device=device)
