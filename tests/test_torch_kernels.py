"""Port parity: the six bucket kernels' plain versions vs the Pallas
kernels of the JAX package (interpret mode on the CPU), and the
compressor and the LARS update built on them.

On the CPU every wrapper runs its plain PyTorch version (the CUDA kernels
need the card: ``tests/test_torch_cuda.py`` compares kernel and plain
version there and skips here).  Tolerances, each with its reason:

* elementwise SGD / LARS update: rtol 1e-6, atol 1e-7 — the same op
  order in float32, so differences are single roundings;
* reductions (sum g^2, sum x^2, per-row |x|, LARS row norms): rtol 1e-5
  — float32 sums taken in another order;
* apply_lars_buckets: rtol 1e-5, atol 1e-7 — the trust ratios come from
  such sums, so they carry their rounding into every updated element;
* sign: exact; compressor scales: 1e-6 relative on equal input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import flatbuf as jfb
from repro.kernels import fused_bucket as jkb
from repro.kernels import ops as jops
from repro.optim import lars as jlars
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro import configs as jconfigs
from repro_torch.core import compression as tcomp
from repro_torch.core import flatbuf as tfb
from repro_torch.core import syncplan as tsplan
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import fused_bucket as tkb
from repro_torch.kernels import ops as tops
from repro_torch.models import base as tmbase
from repro_torch.models import lm as tlm
from repro_torch.optim import lars as tlars
from repro_torch import configs as tconfigs

import _torch_segment_maps as segmaps

torch.set_num_threads(2)

W = 3
ROWS = (264, 3096)     # ragged against the TPU kernels' 256-row blocks


def _rand(rows, seed, lead=(W,), zero_frac=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (rows, 128)).astype(np.float32)
    if zero_frac:
        x[rng.random(x.shape) < zero_frac] = 0.0
    return x


def _wd_row(rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((rows, 1)) < 0.7).astype(np.float32)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("clip", [False, True])
def test_fused_sgd_plain_matches_pallas(rows, nesterov, wd, clip):
    p, g, u = (_rand(rows, s) for s in (1, 2, 3))
    u *= 0.1
    wd_row = _wd_row(rows, 4)
    lr, mom = np.float32(0.05), 0.9
    gscale = np.array([1.0, 0.25, 0.5], np.float32) if clip else None
    pt, ut = torch.from_numpy(p.copy()), torch.from_numpy(u.copy())
    gsq_t, usq_t = tkb.fused_sgd_bucket(
        pt, torch.from_numpy(g), ut, lr, torch.from_numpy(wd_row),
        momentum=mom, weight_decay=wd, nesterov=nesterov,
        gscale=torch.from_numpy(gscale) if clip else None, stats=True)
    assert tkb.LAUNCHES["fused_sgd_bucket"] == 0     # plain route: no launch
    for w in range(W):
        gw = g[w] * gscale[w] if clip else g[w]
        po, uo, gsq, usq = jkb.fused_sgd_bucket_2d(
            jnp.asarray(p[w]), jnp.asarray(gw), jnp.asarray(u[w]),
            jnp.full((1, 1), lr), jnp.asarray(wd_row), momentum=mom,
            weight_decay=wd, nesterov=nesterov, stats=True, interpret=True)
        np.testing.assert_allclose(pt[w].numpy(), np.asarray(po), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ut[w].numpy(), np.asarray(uo), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(gsq_t[w]), float(gsq), rtol=1e-5)
        np.testing.assert_allclose(float(usq_t[w]), float(usq), rtol=1e-5)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_lars_row_norms_plain_matches_pallas(rows, wd):
    p, g = _rand(rows, 21), _rand(rows, 22)
    wd_row = _wd_row(rows, 23)
    pn, gn = tkb.lars_row_norms(torch.from_numpy(p), torch.from_numpy(g),
                                torch.from_numpy(wd_row), weight_decay=wd)
    assert pn.shape == gn.shape == (W, rows)
    assert tkb.LAUNCHES["lars_row_norms"] == 0       # plain route: no launch
    for w in range(W):
        jp, jg = jkb.lars_row_norms_2d(jnp.asarray(p[w]), jnp.asarray(g[w]),
                                       jnp.asarray(wd_row), weight_decay=wd,
                                       interpret=True)
        np.testing.assert_allclose(pn[w].numpy(), np.asarray(jp)[:, 0], rtol=1e-5)
        np.testing.assert_allclose(gn[w].numpy(), np.asarray(jg)[:, 0], rtol=1e-5)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_fused_lars_plain_matches_pallas(rows, nesterov, wd):
    """Each worker slice against the reference's call on that worker, with
    a trust ratio that differs per worker and per row."""
    p, g, u = (_rand(rows, s) for s in (31, 32, 33))
    u *= 0.1
    wd_row = _wd_row(rows, 34)
    ratio = np.random.default_rng(35).uniform(0.01, 2.0, (W, rows)).astype(np.float32)
    lr, mom = np.float32(0.05), 0.9
    pt, ut = torch.from_numpy(p.copy()), torch.from_numpy(u.copy())
    gsq_t, usq_t = tkb.fused_lars_bucket(
        pt, torch.from_numpy(g), ut, lr, torch.from_numpy(wd_row),
        torch.from_numpy(ratio), momentum=mom, weight_decay=wd,
        nesterov=nesterov, stats=True)
    assert tkb.LAUNCHES["fused_lars_bucket"] == 0
    for w in range(W):
        po, uo, gsq, usq = jkb.fused_lars_bucket_2d(
            jnp.asarray(p[w]), jnp.asarray(g[w]), jnp.asarray(u[w]),
            jnp.full((1, 1), lr), jnp.asarray(wd_row),
            jnp.asarray(ratio[w][:, None]), momentum=mom, weight_decay=wd,
            nesterov=nesterov, stats=True, interpret=True)
        np.testing.assert_allclose(pt[w].numpy(), np.asarray(po), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ut[w].numpy(), np.asarray(uo), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(gsq_t[w]), float(gsq), rtol=1e-5)
        np.testing.assert_allclose(float(usq_t[w]), float(usq), rtol=1e-5)
    assert tkb.fused_lars_bucket(pt, torch.from_numpy(g), ut, lr,
                                 torch.from_numpy(wd_row), torch.from_numpy(ratio),
                                 momentum=mom, weight_decay=wd,
                                 nesterov=nesterov) is None


def test_apply_lars_buckets_matches_reference_per_worker():
    """W=4 workers whose grads differ in scale by 10x each: every worker's
    update uses its own layer norms, as the reference's vmapped update
    does (a ratio shared across workers would be off by those factors)."""
    jl, tl = _smoke_layouts()
    Wl = 4
    p = _delta(tl, 41, lead=(Wl,))
    g = _delta(tl, 42, lead=(Wl,)) * (10.0 ** np.arange(Wl, dtype=np.float32)
                                      )[:, None, None]
    u = 0.1 * _delta(tl, 43, lead=(Wl,))
    kw = dict(lr=0.1, trust=0.02, momentum_coef=0.9, weight_decay=1e-2,
              nesterov=True, want_stats=True)
    pt, ut = torch.from_numpy(p.copy()), torch.from_numpy(u.copy())
    _, _, (gsq_t, usq_t) = tlars.apply_lars_buckets(tl, [pt], [torch.from_numpy(g)],
                                                    [ut], **kw)
    assert gsq_t.shape == usq_t.shape == (Wl,)
    for w in range(Wl):
        po, uo, (gsq, usq) = jlars.apply_lars_buckets(
            jl, [jnp.asarray(p[w])], [jnp.asarray(g[w])], [jnp.asarray(u[w])],
            kernel=True, **kw)
        np.testing.assert_allclose(pt[w].numpy(), np.asarray(po[0]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ut[w].numpy(), np.asarray(uo[0]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(gsq_t[w]), float(gsq), rtol=1e-5)
        np.testing.assert_allclose(float(usq_t[w]), float(usq), rtol=1e-5)
    assert (pt.numpy() * (1 - tfb.valid_mask(tl, 0)) == 0).all()   # padding stays 0


@pytest.mark.parametrize("rows", ROWS)
def test_sq_sum_and_row_abs_sum_match_pallas(rows):
    x = _rand(rows, 7)
    xt = torch.from_numpy(x)
    sq = tkb.sq_sum(xt)
    ra = tkb.row_abs_sum(xt)
    assert sq.shape == (W,) and ra.shape == (W, rows)
    for w in range(W):
        np.testing.assert_allclose(float(sq[w]), float(jkb.sq_sum_2d(
            jnp.asarray(x[w]), interpret=True)), rtol=1e-5)
        np.testing.assert_allclose(ra[w].numpy(), np.asarray(jkb.row_abs_sum_2d(
            jnp.asarray(x[w]), interpret=True))[:, 0], rtol=1e-5)
    assert tkb.sq_sum(xt[0]).shape == ()


@pytest.mark.parametrize("rows", ROWS)
def test_scale_sign_rows_matches_pallas_exactly(rows):
    x = _rand(rows, 8, zero_frac=0.05)           # sign(0) = 0 must survive
    scale = np.abs(np.random.default_rng(9).normal(size=(rows,))).astype(np.float32)
    y = tkb.scale_sign_rows(torch.from_numpy(x), torch.from_numpy(scale))
    for w in range(W):
        want = np.asarray(jkb.scale_sign_rows_2d(
            jnp.asarray(x[w]), jnp.asarray(scale[:, None]), interpret=True))
        assert np.array_equal(y[w].numpy(), want)
    assert (y.numpy()[x == 0] == 0).all()


def test_segment_sum_matches_reference():
    """Scatter-add in index order on the CPU, as XLA's: float32 totals
    within one rounding of jax.ops.segment_sum."""
    rng = np.random.default_rng(0)
    seg = np.tile(np.repeat(np.arange(5), [8, 16, 8, 24, 8]), 3).astype(np.int32)
    vals = rng.random(seg.size).astype(np.float32)
    got = tops.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), 5)
    want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7)


# maps of the CPU tests: SegmentIndex runs and the kernel's order of adds;
# the layouts also at smoke size
INDEX_MAPS = ("sizes-3101", "sizes-264", "long", "residues", "permuted",
              "empty", "paper-lm", "fsdp-region", "tp-region")
LAYOUT_MAPS = ("paper-lm", "fsdp-region", "tp-region")


@pytest.mark.parametrize("case,full", [(c, True) for c in INDEX_MAPS]
                         + [(c, False) for c in LAYOUT_MAPS])
def test_segment_index_runs_list_the_order(case, full):
    """The runs of ``fused_bucket.segment_index`` and of the cached
    ``flatbuf.segment_index`` list exactly the rows of the map's order (a
    stable sort) and ``offsets``, segment by segment, in order, as few runs
    as the rows allow; ``by_length`` lists the segments longest first.  A layout's
    leaf is one run (the port's layouts pad each leaf in its own rows:
    no trailing rows), and its index's map is the reference's."""
    index, n_seg = segmaps.segment_index(case, "cpu", full=full)
    seg, offsets, runs, roff, by_len = (t.numpy() for t in index)
    assert seg.dtype == offsets.dtype == runs.dtype == roff.dtype == np.int64
    order = np.argsort(seg, kind="stable")        # segment by segment
    counts = np.bincount(seg, minlength=n_seg)
    assert np.array_equal(offsets, np.concatenate([[0], np.cumsum(counts)]))
    assert len(roff) == n_seg + 1 and roff[0] == 0 and roff[-1] == len(runs)
    assert (runs[:, 1] > 0).all()
    for s in range(n_seg):
        mine = runs[roff[s]:roff[s + 1]]
        rows = np.concatenate([np.arange(a, a + n) for a, n in mine] or [[]])
        assert np.array_equal(rows, order[offsets[s]:offsets[s + 1]])
        # maximal: no run starts where the one before it ends
        assert (mine[1:, 0] != mine[:-1, 0] + mine[:-1, 1]).all()
    assert np.array_equal(by_len, np.argsort(-counts, kind="stable"))
    if case in LAYOUT_MAPS:
        assert len(runs) == n_seg
        built = tkb.segment_index(torch.from_numpy(seg.astype(np.int32)), n_seg)
        assert all(torch.equal(a, b) for a, b in zip(built, index))
    if case == "paper-lm":
        jl = jfb.build_layout(jmbase.abstract(jlm.param_specs(
            (jconfigs.get if full else jconfigs.get_smoke)("paper-lm")),
            jnp.float32))
        assert np.array_equal(seg, jfb.row_segments(jl, 0))
    if case.startswith("sizes-"):
        assert runs[roff[0]:roff[1]][-1, 0] + runs[roff[0]:roff[1]][-1, 1] \
            == len(seg)                             # the trailing rows' run
    if case == "permuted":
        assert len(runs) > 0.9 * len(seg)           # nearly a run a row
    if case == "residues":                          # every start mod 4
        assert all(set(runs[roff[s]:roff[s + 1], 0] % 4) == {0, 1, 2, 3}
                   for s in range(n_seg))
    if case == "long":
        assert counts.max() >= 1 << 20
    if case == "empty":
        assert (counts == 0).sum() == 4 and (roff[1:] == roff[:-1]).sum() == 4


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("case", INDEX_MAPS)
def test_segment_sum_emulation_equals_plain(case, L):
    """A float32 numpy emulation of the card's order of adds -- each total
    from init (or 0), the segment's runs walked in order, leading index
    after leading index when chained, one add at a time -- equals the
    plain version (the host's index_add_, the reference's scatter order)
    bit for bit, per leading index and chained with and without init; so
    does ``ops.segment_totals`` on the CPU."""
    index, n_seg = segmaps.segment_index(case, "cpu", seed=L)
    rows = index.seg_ids.numel()
    rng = np.random.default_rng(rows + L)
    vals = rng.normal(size=(L, rows)).astype(np.float32)
    init = rng.normal(size=(n_seg,)).astype(np.float32)
    tv, seg = torch.from_numpy(vals), index.seg_ids
    for chain, start in ((False, None), (True, None), (True, init)):
        want = tkb.segment_sum_plain(
            tv, seg, n_seg, chain=chain,
            init=None if start is None else torch.from_numpy(start)).numpy()
        got = segmaps.emulate(vals, index, chain=chain, init=start)
        assert got.tobytes() == want.tobytes(), (case, L, chain)
        tot = tops.segment_totals(tv, index, chain=chain, init=None if start
                                  is None else torch.from_numpy(start))
        assert tot.numpy().tobytes() == want.tobytes()


def _smoke_layouts():
    jspecs = jlm.param_specs(jconfigs.get_smoke("paper-lm"))
    tspecs = tlm.param_specs(tconfigs.get_smoke("paper-lm"))
    jl = jfb.build_layout(jmbase.abstract(jspecs, jnp.float32),
                          wd_mask=jmbase.norm_param_mask(jspecs))
    tl = tfb.build_layout(tmbase.abstract(tspecs, torch.float32),
                          wd_mask=tmbase.norm_param_mask(tspecs))
    return jl, tl


def _delta(layout, seed, lead=(4,)):
    """A worker-stacked delta bucket with zero padding and a few exact
    zeros inside the leaves."""
    x = _rand(layout.bucket_rows[0], seed, lead=lead, zero_frac=0.01)
    return x * tfb.valid_mask(layout, 0)


def test_bucket_sign_compress_matches_reference():
    """ops level: equal input -> signs exact, scales within 1e-6 rel."""
    jl, tl = _smoke_layouts()
    x = _delta(tl, 11)
    seg = tfb.row_segments(tl, 0)
    sizes = tfb.segment_sizes(tl, 0)
    y, scales = tops.bucket_sign_compress(torch.from_numpy(x),
                                          torch.from_numpy(seg),
                                          torch.from_numpy(sizes * 4))
    jy, jscales = jops.bucket_sign_compress(
        jnp.asarray(x.reshape(-1, 128)), np.tile(seg, 4), sizes * 4,
        interpret=True)
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=1e-6)
    jy = np.asarray(jy).reshape(x.shape)
    assert np.array_equal(np.sign(y.numpy()), np.sign(jy))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-6)


@pytest.mark.parametrize("mode", ["sign", "ef_sign"])
def test_compress_stage_matches_reference(mode):
    """Module level (core/compression): the per-leaf L1 scale is shared
    across the W workers (leading=1), EF memory keeps e' = input - out."""
    jl, tl = _smoke_layouts()
    d = _delta(tl, 12)
    e = 0.1 * _delta(tl, 13)
    st = tsplan.SyncStage("pack", "global", (0,), mode, 4)
    y, e_new, inp = tcomp.compress_stage(tl, st, torch.from_numpy(d),
                                         torch.from_numpy(e), leading=1)
    from repro.core.syncplan import SyncStage as JStage
    jy, je, jinp = jcomp.compress_stage(jl, JStage("pack", "global", (0,), mode, 4),
                                        jnp.asarray(d), jnp.asarray(e),
                                        leading=1, kernel=True)
    jy, je, jinp = (np.asarray(a) for a in (jy, je, jinp))
    assert np.array_equal(inp.numpy(), jinp)
    assert np.array_equal(np.sign(y.numpy()), np.sign(jy))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-6)
    if mode == "ef_sign":
        np.testing.assert_allclose(e_new.numpy(), je, rtol=1e-6, atol=1e-6)
        # EF invariant: compressed + e' == input, to one float32 rounding
        np.testing.assert_allclose((y + e_new).numpy(), inp.numpy(), rtol=0,
                                   atol=2 * np.finfo(np.float32).eps
                                   * float(inp.abs().max()))
    assert (y.numpy() * (1 - tfb.valid_mask(tl, 0)) == 0).all()   # padding stays 0


def test_wrappers_refuse_other_devices():
    """No silent fallback: only CPU (plain) or CUDA (kernel) tensors."""
    x = torch.empty((2, 8, 128), device="meta")
    for fn in (tkb.sq_sum, tkb.row_abs_sum):
        with pytest.raises(ValueError):
            fn(x)
    with pytest.raises(ValueError):
        tkb.scale_sign_rows(x, torch.zeros(8))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tbuild.build_all()


def test_sq_sum_sweep_variants_match_the_kernel_source():
    """Each design variant of ``kernels/sq_sum_sweep.py`` is one text
    substitution of the CUDA source: the text must still be there, once."""
    from repro_torch.kernels import build as tbuild
    from repro_torch.kernels import sq_sum_sweep

    src = tbuild.SOURCES["fused_bucket"].read_text()
    assert sq_sum_sweep.VARIANTS["chosen"] is None
    for name, sub in sq_sum_sweep.VARIANTS.items():
        if sub is not None:
            assert src.count(sub[0]) == 1, name
