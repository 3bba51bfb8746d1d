"""Row -> segment maps for the segmented sum's tests, on the CPU and on
the card (torch and the port only, no JAX).

Each map is made from a seed with numpy: the bucket layouts the port
builds (paper-lm's one bucket, a shard region of its 2 x 2 FSDP and TP
sub-buckets, at full width or smoke size) and maps no layout makes but
the kernel takes: leaves of random sizes with trailing padding rows in
segment 0, one segment of more than 2^20 rows, runs starting at every
residue mod 4, a random map (a run a row), empty segments.
"""
import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import flatbuf
from repro_torch.kernels import fused_bucket as fb
from repro_torch.models import base as mbase
from repro_torch.models import lm
from repro_torch.sharding import layout as sl

# maps of the card tests; the layouts at full width
CARD_MAPS = ("sizes-3101", "sizes-264", "sizes-300007", "paper-lm",
             "fsdp-region", "tp-region", "long", "residues", "permuted",
             "empty")


def paper_lm_layout(kind=None, *, full=True):
    """paper-lm's layout: one replicated bucket, or the 2 x 2 ("data",
    "model") sub-buckets of ``kind`` "fsdp" or "tp"."""
    cfg = (configs.get if full else configs.get_smoke)("paper-lm")
    specs = lm.param_specs(cfg)
    classes = None
    if kind is not None:
        mesh = (sl.train_layout(("data", "model"), worker_axes=("data",))
                if kind == "tp" else
                sl.fsdp_within_worker_layout(("data", "model"),
                                             worker_axes=("data",),
                                             shard_axes=("model",)))
        classes = flatbuf.shard_classes(specs, mesh.with_sizes(
            {"data": 2, "model": 2}))
    return flatbuf.build_layout(mbase.abstract(specs, torch.float32),
                                wd_mask=mbase.norm_param_mask(specs),
                                shard_classes=classes)


def sharded_bucket(layout) -> int:
    """The bucket of ``layout`` split over shard regions."""
    return next(b for b in range(layout.num_buckets)
                if layout.bucket_shard_count(b) > 1)


def seg_map(case: str, seed: int = 0):
    """(seg_ids int32 (rows,), num_segments) of a map no layout makes."""
    rng = np.random.default_rng(seed)
    if case.startswith("sizes-"):
        # leaves of random sizes, the last empty, trailing rows to leaf 0
        rows, n_seg = int(case.split("-")[1]), 37
        sizes = rng.integers(0, 2 * rows // n_seg, n_seg)
        sizes[-1] = 0
        ids = np.repeat(np.arange(n_seg, dtype=np.int32), sizes)[:rows]
        seg = np.zeros((rows,), np.int32)
        seg[:len(ids)] = ids
        return seg, n_seg
    if case == "long":
        # one leaf of 2^20 + 5 rows between two pieces of leaf 0
        seg = np.zeros(((1 << 20) + 37,), np.int32)
        seg[3:3 + (1 << 20) + 5] = 1
        return seg, 2
    if case == "residues":
        # blocks of 1-7 rows dealt to 8 leaves in turn: every leaf's runs
        # start at every residue mod 4
        lens = 1 + np.arange(700) % 7
        ids = (np.arange(700) % 8).astype(np.int32)
        return np.repeat(ids, lens), 8
    if case == "permuted":
        # a random map: nearly every row its own run
        return rng.integers(0, 13, 50_021).astype(np.int32), 13
    if case == "empty":
        # leaves 0, 3, 4 and 9 of 10 empty; the others of random sizes
        keep = np.array([1, 2, 5, 6, 7, 8], np.int32)
        ids = np.repeat(keep, rng.integers(1, 4_000, len(keep)))
        return rng.permutation(ids).astype(np.int32), 10
    raise ValueError(case)


def segment_index(case: str, device, seed: int = 0, *, full=True):
    """(SegmentIndex, num_segments) of map ``case`` on ``device``: a
    layout's cached index, or ``fused_bucket.segment_index`` of the map."""
    if case == "paper-lm":
        return flatbuf.segment_index(paper_lm_layout(full=full), 0, device), 11
    if case in ("fsdp-region", "tp-region"):
        lay = paper_lm_layout(case.split("-")[0], full=full)
        b = sharded_bucket(lay)
        return (flatbuf.segment_index(lay, b, device),
                len(lay.bucket_slots(b)))
    seg, n_seg = seg_map(case, seed)
    return fb.segment_index(torch.from_numpy(seg).to(device), n_seg), n_seg


def emulate(vals: np.ndarray, index, *, chain: bool = False, init=None):
    """The kernel's sums in float32 numpy: each total from ``init`` (or
    0), walking the segment's runs in order (leading index after leading
    index when chained), one add at a time (``np.add.accumulate`` in
    float32 adds one element after another)."""
    runs = index.runs.cpu().numpy()
    roff = index.run_offsets.cpu().numpy()
    n_seg = len(roff) - 1
    vals = np.asarray(vals, np.float32)

    def total(acc, leads, s):
        acc = np.float32(acc)
        for l in leads:
            for start, length in runs[roff[s]:roff[s + 1]]:
                acc = np.add.accumulate(np.concatenate(
                    [[acc], vals[l, start:start + length]]),
                    dtype=np.float32)[-1]
        return acc
    if chain:
        start = (np.zeros(n_seg, np.float32) if init is None
                 else np.asarray(init, np.float32))
        return np.array([total(start[s], range(len(vals)), s)
                         for s in range(n_seg)], np.float32)
    return np.array([[total(0.0, (l,), s) for s in range(n_seg)]
                     for l in range(len(vals))], np.float32)
