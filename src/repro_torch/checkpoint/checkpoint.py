"""Checkpoints in the reference's npz format (the port of
``repro.checkpoint.checkpoint``): per-leaf snapshots (:func:`save` /
:func:`restore`), dtype-bucketed flat snapshots (:func:`save_flat` /
:func:`restore_flat`, with the elastic worker-axis restore) and the
versioned publish channel of the serving hot-swap (:func:`publish_flat` /
:func:`latest_flat`).

A file written by one package restores in the other, member for member:

* Leaves are visited in ``jax.tree.flatten`` order and named by JAX's key
  path, ``"/".join(str(k) for k in path)``: ``['embed']`` for a dict key,
  ``[0]`` for a sequence index, ``.params`` for a dataclass field, and
  ``[<flat index i>]`` for bucket ``i`` of a ``BucketState`` (a pytree
  node without keys in the reference).  A resident state's members are
  ``.params/[<flat index 0>]``, ``.momentum/...``, ``.step``, ``.rng``,
  ``.stats/.acc_grad_sq``...; ``LocalSGDState`` keeps the reference's
  field order for this.
* :func:`save_flat` packs every leaf through ``flatbuf.build_layout`` into
  one buffer per dtype, stored as ``bucket{i}``, a ``uint8`` view of
  ``(rows, 128)`` (so bfloat16 round-trips as raw bytes), with the layout
  in the ``.meta.json`` sidecar; a restore checks the template's layout
  against it.

**The state's step and generator.**  The reference's ``step`` is an int32
scalar and its ``rng`` a ``uint32[2]`` JAX key; the port's are an ``int``
and a ``torch.Generator``.  Both are written in the reference's form, so
the leaf layout (and so every bucket) is the same in both packages:
``.step`` as int32, ``.rng`` as the key ``[seed >> 32, seed & 0xffffffff]``
of the generator's ``initial_seed()`` (what ``jax.random.PRNGKey(seed)``
gives for the same seed).  The generator's full state (its position in
the stream) goes into one more member, ``.rng#generator``, which the
reference never reads.  So:

* port -> port: the generator is restored from ``.rng#generator`` and the
  gradient-noise stream resumes exactly;
* JAX -> port: there is no generator state; the port's generator is
  seeded from the key's two words, with a ``UserWarning`` — JAX's
  threefry stream cannot be carried into torch's, so a noisy run
  continues on another stream (noise compares only statistically across
  packages; parity runs use ``noise_eta == 0``);
* port -> JAX: the reference reads the key and ignores the extra member.

Buckets, the step and the statistics cross in both directions row for
row.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings

import numpy as np
import torch

from repro_torch.convert import generator_from_key, key_from_generator
from repro_torch.core import flatbuf
from repro_torch.models.base import ShapeDtype

_GEN_SUFFIX = "#generator"        # npz member of a generator's full state
# leaves, whatever else they are (ShapeDtype is a dataclass)
_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, ShapeDtype,
               torch.Generator, int, float)


# ---------------------------------------------------------------------------
# Tree walk with the reference's key paths
# ---------------------------------------------------------------------------

def _children(node):
    """``[(path element, child)]`` of an inner node, in jax.tree.flatten
    order; None for a leaf."""
    if isinstance(node, _LEAF_TYPES):
        return None
    if flatbuf.is_bucket_state(node):
        return [(f"[<flat index {i}>]", b) for i, b in enumerate(node.buckets)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(tree):
    """(paths, leaves) of ``tree``; None subtrees hold no leaves."""
    paths, leaves = [], []

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for k, v in kids:
            walk(v, prefix + (k,))

    walk(tree, ())
    return paths, leaves


def _rebuild(template, values):
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if flatbuf.is_bucket_state(node):
            return node.with_buckets([build(b) for b in node.buckets])
        kids = _children(node)
        if kids is None:
            return next(it)
        if dataclasses.is_dataclass(node):
            return type(node)(**{k[1:]: build(v) for k, v in kids})
        if isinstance(node, dict):          # leaves come in sorted-key order
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(v) for v in node)

    return build(template)


# ---------------------------------------------------------------------------
# Leaves <-> numpy
# ---------------------------------------------------------------------------

def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the reference would write it: tensors as their values
    (bfloat16 as 2-byte raw values), a Python int (the step) as int32, a
    generator as its key."""
    if isinstance(leaf, torch.Generator):
        return key_from_generator(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(leaf, (bool, int, np.integer)) and not isinstance(leaf, np.ndarray):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _spec(leaf) -> ShapeDtype:
    """Shape and dtype of a save-side or template leaf, in the form the
    checkpoint stores it (step int32 (), rng uint32 (2,))."""
    if isinstance(leaf, torch.Generator):
        return ShapeDtype((2,), np.dtype(np.uint32))
    if isinstance(leaf, (bool, int, np.integer)) and not isinstance(leaf, np.ndarray):
        return ShapeDtype((), np.dtype(np.int32))
    return ShapeDtype(tuple(leaf.shape), leaf.dtype)


def _generators(paths, leaves) -> dict:
    """npz members holding the full state of every generator leaf."""
    return {p + _GEN_SUFFIX: leaf.get_state().numpy()
            for p, leaf in zip(paths, leaves)
            if isinstance(leaf, torch.Generator)}


def _target_device(leaf, device):
    if device is not None:
        return torch.device(device)
    dev = getattr(leaf, "device", None)
    if dev is None or dev.type == "meta":
        return torch.device("cpu")
    return dev


def _from_numpy(arr: np.ndarray, tmpl, path: str, data, device,
                saved_dtype=None):
    """The restored value for template leaf ``tmpl`` from ``arr`` (stored
    as ``saved_dtype`` where that differs from the template's)."""
    if isinstance(tmpl, torch.Generator):
        dev = _target_device(tmpl, device)
        member = path + _GEN_SUFFIX
        if member not in data:
            gen = generator_from_key(arr, dev)
            warnings.warn(
                f"{path}: the snapshot holds a JAX key, no generator state: "
                f"the generator is seeded with {gen.initial_seed()} from the "
                f"key's words (another noise stream than the reference's)",
                stacklevel=3)
            return gen
        gen = torch.Generator(device=dev)
        gen.set_state(torch.from_numpy(np.array(data[member])))
        return gen
    if isinstance(tmpl, (bool, int, np.integer)) and not isinstance(tmpl, np.ndarray):
        return int(np.asarray(arr))
    dt = tmpl.dtype if isinstance(tmpl.dtype, torch.dtype) else \
        flatbuf.torch_dtype(flatbuf.dtype_name(tmpl.dtype))
    a = np.ascontiguousarray(arr)
    # a bfloat16 member is stored as its raw 16-bit words; ``saved_dtype``
    # names the stored dtype where a widening restore converts it
    if (saved_dtype or dt) == torch.bfloat16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dt)
    else:
        t = torch.from_numpy(a.copy()).to(dt)
    return t.reshape(tuple(tmpl.shape)).to(_target_device(tmpl, device))


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".meta.json"


# ---------------------------------------------------------------------------
# Per-leaf snapshots
# ---------------------------------------------------------------------------

def save(path: str, tree, *, step: int | None = None, extra: dict | None = None):
    """One npz member per leaf of ``tree`` (a param tree, a
    ``LocalSGDState``, resident or not), named by its key path."""
    paths, leaves = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = {p: _to_numpy(x) for p, x in zip(paths, leaves)}
    arrs.update(_generators(paths, leaves))
    np.savez(_npz(path), **arrs)
    with open(_meta_path(path), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)


def restore(path: str, template, *, device=None):
    """Restore into the structure of ``template`` (tensors, ``ShapeDtype``
    or meta tensors, a ``LocalSGDState``).  Leaves take the template's
    dtype and land on ``device``, else on the template leaf's device (the
    CPU for an abstract leaf)."""
    data = np.load(_npz(path))
    paths, leaves = _flatten(template)
    vals = []
    for p, leaf in zip(paths, leaves):
        arr = data[p]
        if arr.dtype.kind == "V" and not isinstance(leaf, torch.Generator):
            arr = arr.view(np.int16)            # raw bfloat16 values
        vals.append(_from_numpy(arr, leaf, p, data, device))
    return _rebuild(template, vals)


def load_meta(path: str) -> dict:
    with open(_meta_path(path)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Flat-bus snapshots: one npz member per dtype bucket
# ---------------------------------------------------------------------------

def _layout_of(leaves) -> flatbuf.FlatLayout:
    return flatbuf.build_layout([_spec(x) for x in leaves])


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=flatbuf.torch_dtype(name)).element_size()


def save_flat(path: str, tree, *, step: int | None = None,
              extra: dict | None = None):
    """Snapshot ``tree`` as dtype-bucketed flat buffers (the reference's
    format: ``bucket{i}`` members, the layout in the sidecar).

    A resident state's leaves ARE its bucket buffers, so each is copied
    from the device once, straight into its rows of the host bucket.
    """
    paths, leaves = _flatten(tree)
    layout = _layout_of(leaves)
    resident = _any_bucket_state(tree)
    arrs = {}
    for b in range(layout.num_buckets):
        isz = _itemsize(layout.bucket_dtypes[b])
        buf = np.zeros((layout.bucket_rows[b], flatbuf.LANE * isz), np.uint8)
        flat = buf.reshape(-1)
        for s in layout.bucket_slots(b):
            off = s.row_offset * flatbuf.LANE * isz
            leaf = leaves[s.index]
            if isinstance(leaf, torch.Tensor):
                dst = torch.from_numpy(flat[off:off + s.size * isz])
                dst.copy_(leaf.detach().reshape(-1).contiguous()
                          .view(torch.uint8))
            else:
                src = np.ascontiguousarray(_to_numpy(leaf)).reshape(-1)
                flat[off:off + s.size * isz] = src.view(np.uint8)
        arrs[f"bucket{b}"] = buf
    arrs.update(_generators(paths, leaves))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz(path), **arrs)
    meta = {"step": step, "format": "flatbuf", "resident": resident,
            "bucket_dtypes": list(layout.bucket_dtypes),
            "bucket_rows": list(layout.bucket_rows),
            "leaf_shapes": [list(s.shape) for s in layout.slots],
            "leaf_dtypes": [s.dtype for s in layout.slots],
            "num_leaves": layout.num_leaves, **(extra or {})}
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def _any_bucket_state(tree) -> bool:
    if flatbuf.is_bucket_state(tree):
        return True
    kids = _children(tree) if tree is not None else None
    return bool(kids) and any(_any_bucket_state(v) for _, v in kids)


def _unpack_buckets(path, layout, specs):
    """The leaves of a flat snapshot as numpy arrays of ``specs``' shapes."""
    data = np.load(_npz(path))
    out = [None] * layout.num_leaves
    for b in range(layout.num_buckets):
        raw = data[f"bucket{b}"].reshape(-1)
        isz = _itemsize(layout.bucket_dtypes[b])
        name = layout.bucket_dtypes[b]
        np_dt = np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)
        for s in layout.bucket_slots(b):
            off = s.row_offset * flatbuf.LANE * isz
            out[s.index] = raw[off:off + s.size * isz].view(np_dt).reshape(
                specs[s.index].shape)
    return data, out


def _elastic_leaves(path, layout, meta, template_leaves):
    """Worker-axis re-bucket: the leaves of a snapshot saved at W_old,
    resized to the template's W_new (shrink keeps the first workers bit
    for bit, grow repeats them).  Applies only when the saved and template
    leaves agree on everything but one consistent leading-dim pair;
    returns None otherwise."""
    from repro_torch.core.elastic import resize_axis

    saved_shapes = [tuple(s) for s in meta["leaf_shapes"]]
    tmpl_shapes = [tuple(s.shape) for s in layout.slots]
    if len(saved_shapes) != len(tmpl_shapes) or \
            meta["leaf_dtypes"] != [s.dtype for s in layout.slots]:
        return None
    pair = None
    for ss, ts in zip(saved_shapes, tmpl_shapes):
        if ss == ts:
            continue
        if len(ss) != len(ts) or not ss or ss[1:] != ts[1:]:
            return None
        if pair is None:
            pair = (ss[0], ts[0])
        elif (ss[0], ts[0]) != pair:
            return None
    if pair is None:
        return None          # identical leaves, bucketing disagreed
    w_old, w_new = pair
    if (w_old % w_new) if w_old > w_new else (w_new % w_old):
        return None
    # the layout the snapshot was SAVED with, checked against the sidecar
    # so a stale meta cannot misparse the buffers
    specs = [ShapeDtype(s, flatbuf.torch_dtype(d))
             for s, d in zip(saved_shapes, meta["leaf_dtypes"])]
    slay = flatbuf.build_layout(specs)
    if list(slay.bucket_dtypes) != meta["bucket_dtypes"] or \
            list(slay.bucket_rows) != meta["bucket_rows"]:
        return None
    data, saved = _unpack_buckets(path, slay, specs)
    out = []
    for arr, ts, leaf in zip(saved, tmpl_shapes, template_leaves):
        if tuple(arr.shape) != ts:
            arr = resize_axis(torch.from_numpy(np.ascontiguousarray(arr)),
                              ts[0], fold="slice").numpy()
        out.append(arr)
    return data, out


def _widened_leaves(path, layout, meta):
    """The leaves of a snapshot with the template's shapes where some
    leaf is stored in bf16 or float16 and the template's is float32 (a
    reference state saved before its first EF-sign sync holds a bf16
    bucket's EF memory in bf16; the port's is float32 from ``init`` on):
    ``(data, arrays, saved dtypes)``, parsed with the saved layout, the
    saved torch dtype None where it equals the template's.  None for any
    other mismatch."""
    saved = meta["leaf_dtypes"]
    if [list(s.shape) for s in layout.slots] != meta["leaf_shapes"] or \
            len(saved) != layout.num_leaves:
        return None
    widened = []
    for s, d in zip(layout.slots, saved):
        if d == s.dtype:
            widened.append(None)
        elif s.dtype == "float32" and d in ("bfloat16", "float16"):
            widened.append(flatbuf.torch_dtype(d))
        else:
            return None
    specs = [ShapeDtype(tuple(s.shape), flatbuf.torch_dtype(d))
             for s, d in zip(layout.slots, saved)]
    slay = flatbuf.build_layout(specs)
    if list(slay.bucket_dtypes) != meta["bucket_dtypes"] or \
            list(slay.bucket_rows) != meta["bucket_rows"]:
        return None
    data, arrs = _unpack_buckets(path, slay, specs)
    return data, arrs, widened


def restore_flat(path: str, template, *, device=None):
    """Restore a :func:`save_flat` snapshot into the structure, shapes and
    dtypes of ``template`` (see :func:`restore` for where leaves land).

    A snapshot saved at another worker count restores through the elastic
    re-bucket (shrink keeps the surviving workers bit for bit, grow
    repeats them); a float32 template leaf saved in bf16 or float16 is
    widened, exactly; any other layout mismatch raises."""
    paths, leaves = _flatten(template)
    layout = _layout_of(leaves)
    meta = load_meta(path)
    widened = [None] * layout.num_leaves
    if list(layout.bucket_dtypes) != meta["bucket_dtypes"] or \
            list(layout.bucket_rows) != meta["bucket_rows"] or \
            layout.num_leaves != meta["num_leaves"] or \
            [list(s.shape) for s in layout.slots] != meta["leaf_shapes"] or \
            [s.dtype for s in layout.slots] != meta["leaf_dtypes"]:
        got = _widened_leaves(path, layout, meta)
        if got is not None:
            got, widened = got[:2], got[2]
        else:
            got = _elastic_leaves(path, layout, meta, leaves)
        if got is None:
            raise ValueError(
                f"flat checkpoint layout mismatch: saved "
                f"{meta['bucket_dtypes']}/{meta['bucket_rows']} "
                f"({meta['num_leaves']} leaves) vs template "
                f"{list(layout.bucket_dtypes)}/{list(layout.bucket_rows)} "
                f"({layout.num_leaves} leaves)")
        data, arrs = got
    else:
        data, arrs = _unpack_buckets(path, layout, [_spec(x) for x in leaves])
    vals = [_from_numpy(a, leaf, p, data, device, saved_dtype=w)
            for a, leaf, p, w in zip(arrs, leaves, paths, widened)]
    return _rebuild(template, vals)


# ---------------------------------------------------------------------------
# Versioned publish channel: trainer -> serving hot-swap (see serving/)
# ---------------------------------------------------------------------------

def publish_flat(dir: str, tree, *, step: int | None = None,
                 extra: dict | None = None) -> tuple[int, str]:
    """Publish ``tree`` as the next weight version under ``dir``:
    ``weights_v{n}.npz`` by :func:`save_flat`, then ``manifest.json``
    advanced atomically (temp file + ``os.replace``), so a reader polling
    :func:`latest_flat` only sees complete versions.  Returns
    ``(version, snapshot_path)``."""
    os.makedirs(dir, exist_ok=True)
    mpath = os.path.join(dir, "manifest.json")
    manifest = {"latest": -1, "versions": {}}
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    version = int(manifest["latest"]) + 1
    name = f"weights_v{version}"
    save_flat(os.path.join(dir, name), tree, step=step,
              extra={"version": version, **(extra or {})})
    manifest["latest"] = version
    manifest["versions"][str(version)] = {"path": name + ".npz", "step": step}
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mpath)
    return version, os.path.join(dir, name + ".npz")


def latest_flat(dir: str) -> tuple[int, str] | None:
    """The latest published ``(version, snapshot_path)`` under ``dir``, or
    None when nothing is published yet."""
    mpath = os.path.join(dir, "manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        manifest = json.load(f)
    latest = int(manifest["latest"])
    if latest < 0:
        return None
    return latest, os.path.join(dir, manifest["versions"][str(latest)]["path"])
