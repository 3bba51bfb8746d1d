"""Continuous-batching decode engine over the paged KV cache (the port of
``repro.serving.engine``).

:class:`DecodeEngine` treats the decode batch as a pool of **slots** fed
from an admission queue: a sequence retires the step it hits EOS or its
token budget, its slot and KV pages go back to the allocator, and the
next queued request is prefilled between decode steps.  The decode shapes
are fixed: idle slots ride along with ``len == 0``, their logits ignored
and their page writes dropped.

Two programs cover the loop:

* prefill: one padded ``(max_batch, prefill_len)`` forward per admission
  wave -> first-token logits read at each row's true length
  (``lm.prefill(lengths=)``) + the pages written
  (:func:`repro_torch.serving.paged.scatter_prefill`; length-0 rows, idle
  or mid-decode, write nothing).
* decode: one step for ALL slots —
  :func:`repro_torch.serving.paged.paged_decode_step` (gather -> decode ->
  write-back) + greedy sampling and length increments on the card.  The
  loop state (tokens, lengths, page tables) stays on the card between
  steps; only the (B,) sampled tokens cross to the host.

The pools are updated in place (the reference donates them to its jitted
programs).

**Live weight hot-swap**: :meth:`install_weights` replaces the params
between decode steps from a published ``BucketState`` (bucket buffers ->
one ``unpack()``) and re-prefills every resident sequence's history under
the new weights, so its continuation is what a fresh engine on the new
version, given the emitted history as its prompt, would produce.  Swaps
are traced as ``swap`` spans and fed to ``repro_serve_swap_seconds`` /
``repro_serve_weight_version``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import flatbuf
from repro_torch.models import lm
from repro_torch.serving import paged
from repro_torch.telemetry.metrics import observe_serve_step, observe_swap
from repro_torch.telemetry.trace import NULL


@dataclass(frozen=True)
class Request:
    """One generation request for the admission queue."""
    uid: int
    prompt: tuple            # token ids
    max_new: int = 16
    eos_id: int | None = None


@dataclass
class Result:
    """A retired request: emitted tokens + why it stopped."""
    uid: int
    tokens: list = field(default_factory=list)
    finish_reason: str = "length"        # "eos" | "length"
    weight_versions: tuple = ()          # versions that produced tokens


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeEngine:
    """Continuous-batching engine: queue -> slots -> paged decode.

    ``max_batch`` decode slots over a shared page pool sized for full
    occupancy by default, on the params' device.  Sequencing state
    (histories, lengths, page tables, the free-page list) is host-side
    numpy; the card holds the page pools, the params and the decode
    loop's mirrors.  Sampling is greedy.  ``on_logits(kind, rows,
    logits, inputs)``, if given, sees every program's logits (``kind``
    "prefill" or "decode", ``rows`` the ``(slot, uid)`` pairs whose rows
    are live, ``logits`` the (max_batch, 1, V) tensor on the card) and
    the program's inputs, ``(tokens, lengths)`` on the card: the padded
    (max_batch, S) prompts and their lengths for a prefill, the
    (max_batch, 1) tokens and the lengths including them (0 for an idle
    slot) for a decode step.  It is the hook that holds the engine
    against a reference run on the same batches.
    """

    def __init__(self, cfg, params, *, max_batch: int, max_len: int,
                 page_size: int = 8, num_pages: int | None = None,
                 prefill_len: int | None = None, eos_id: int | None = None,
                 tracer=None, metrics=None, on_logits=None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        # prompts pad to ONE admission shape; keep it near the real prompt
        # lengths — padding past them is wasted forward work
        self.prefill_len = int(prefill_len) if prefill_len else self.max_len
        if not 0 < self.prefill_len <= self.max_len:
            raise ValueError(f"prefill_len {self.prefill_len} outside "
                             f"(0, max_len={self.max_len}]")
        self.eos_id = eos_id
        self.tracer = tracer if tracer is not None else NULL
        self.metrics = metrics
        self.on_logits = on_logits

        pl = paged.build_page_layout(cfg, page_size=page_size,
                                     max_len=max_len, num_pages=0)
        if num_pages is None:      # full occupancy + the null page
            num_pages = 1 + self.max_batch * pl.pages_per_seq
        self.pl = pl = paged.PageLayout(
            token_layout=pl.token_layout, leaf_axes=pl.leaf_axes,
            page_size=pl.page_size, num_pages=int(num_pages),
            pages_per_seq=pl.pages_per_seq)
        self.pools = paged.init_pool(pl, self.device)
        self.free_pages = list(range(pl.num_pages - 1, 0, -1))  # pop() -> low ids first

        B = self.max_batch
        self.tables = np.zeros((B, pl.pages_per_seq), np.int32)  # NULL_PAGE
        self.lens = np.zeros(B, np.int32)        # tokens held incl. pending
        self.hist = [None] * B                   # list[int] per live slot
        self.prompt_len = np.zeros(B, np.int32)
        self.gen = np.zeros(B, np.int32)         # tokens emitted
        self.slot_req = [None] * B               # Request per live slot
        self.slot_versions = [()] * B

        self.queue: deque[Request] = deque()
        self.completed: list[Result] = []
        self.weight_version = -1
        self._uid = 0
        self.steps = 0
        self.tokens_out = 0
        # card mirrors of the decode loop state, refreshed from the host
        # arrays only when slot membership changes (admit / retire /
        # swap): a steady-state step uploads nothing
        self._dirty = True
        self._tok_dev = None
        self._lens_dev = None
        self._tab_dev = None

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # Queue
    # ------------------------------------------------------------------

    def submit(self, prompt, *, max_new: int = 16,
               eos_id: int | None = None) -> int:
        """Enqueue a prompt; returns the request uid."""
        prompt = tuple(int(t) for t in np.asarray(prompt).reshape(-1))
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(f"prompt({len(prompt)}) + max_new({max_new}) "
                             f"exceeds max_len({self.max_len})")
        uid = self._uid
        self._uid += 1
        self.queue.append(Request(uid=uid, prompt=prompt, max_new=max_new,
                                  eos_id=eos_id if eos_id is not None
                                  else self.eos_id))
        return uid

    @property
    def num_active(self) -> int:
        return int((self.lens > 0).sum())

    @property
    def idle(self) -> bool:
        return not self.queue and self.num_active == 0

    # ------------------------------------------------------------------
    # Admission + prefill
    # ------------------------------------------------------------------

    def _admit(self):
        """Move queued requests into free slots while pages last; the
        admission wave runs ONE batched prefill (idle and mid-decode rows
        ride along with length 0 and write nothing), and each admitted
        slot emits its first token."""
        free_slots = [b for b in range(self.max_batch) if self.lens[b] == 0]
        if not self.queue or not free_slots:
            return 0
        admits = []
        with self.tracer.span("admit") as sp:
            while (self.queue and free_slots
                   and len(self.free_pages) >= self.pl.pages_per_seq):
                req = self.queue.popleft()
                slot = free_slots.pop(0)
                row = np.array([self.free_pages.pop()
                                for _ in range(self.pl.pages_per_seq)],
                               np.int32)
                self.tables[slot] = row
                self.slot_req[slot] = req
                admits.append((slot, list(req.prompt)))
            sp.set(admitted=len(admits), queued=len(self.queue))
        if admits:
            self._prefill_batch(admits)
        return len(admits)

    @torch.no_grad()
    def _prefill_batch(self, work, *, emit: bool = True):
        """Prefill ``work`` — a list of (slot, history) — in one padded
        batch; when ``emit``, sample each slot's first token, else just
        rebuild the KV (the hot-swap re-prefill, lens untouched)."""
        self._dirty = True
        Ls = [len(h) for _, h in work]
        # two padded shapes at most: the admission shape (prefill_len)
        # and the swap re-prefill shape (max_len, histories mid-flight)
        S = self.prefill_len if max(Ls) <= self.prefill_len else self.max_len
        toks = np.zeros((self.max_batch, S), np.int64)
        lens = np.zeros(self.max_batch, np.int64)
        for slot, h in work:
            toks[slot, :len(h)] = h
            lens[slot] = len(h)
        with self.tracer.span("prefill") as sp:
            toks_dev, lens_dev = self._dev(toks), self._dev(lens)
            logits, cache = lm.prefill(self.cfg, self.params, toks_dev,
                                       lengths=lens_dev)
            paged.scatter_prefill(self.pl, self.pools, cache,
                                  self._dev(self.tables), lens_dev)
            del cache
            sp.set(slots=len(work), length=int(max(Ls)))
            first = logits[:, -1].argmax(-1).cpu().numpy() if emit else None
        if not emit:
            return
        if self.on_logits is not None:
            self.on_logits("prefill", [(s, self.slot_req[s].uid)
                                       for s, _ in work], logits,
                           (toks_dev, lens_dev))
        for slot, history in work:
            tok = int(first[slot])
            self.hist[slot] = history + [tok]
            self.prompt_len[slot] = len(history)
            self.lens[slot] = len(history) + 1
            self.gen[slot] = 1
            self.slot_versions[slot] = (self.weight_version,)
            self.tokens_out += 1
            self._maybe_retire(slot, tok)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _decode(self):
        """One decode step for all slots; the new tokens and lengths stay
        on the card.  Returns the step's logits."""
        logits, self.pools = paged.paged_decode_step(
            self.cfg, self.params, self._tok_dev, self.pools, self._tab_dev,
            self._lens_dev, self.pl)
        tok = logits[:, -1].argmax(-1)                    # greedy
        self._lens_dev = torch.where(self._lens_dev > 0, self._lens_dev + 1,
                                     self._lens_dev)
        self._tok_dev = tok[:, None]
        return logits

    def step(self) -> int:
        """One engine iteration: admit new work, then one continuous
        decode step over every resident sequence.  Returns the number of
        tokens emitted this step."""
        self._admit()
        active = np.flatnonzero(self.lens > 0)
        emitted = 0
        dt = None
        if active.size:
            if self._dirty:
                toks = np.zeros((self.max_batch, 1), np.int64)
                for b in active:
                    toks[b, 0] = self.hist[b][-1]
                self._tok_dev = self._dev(toks)
                self._lens_dev = self._dev(self.lens.astype(np.int64))
                self._tab_dev = self._dev(self.tables.astype(np.int64))
                self._dirty = False
            inputs = (self._tok_dev, self._lens_dev)
            t0 = time.perf_counter()
            with self.tracer.span("decode") as sp:
                logits = self._decode()
                tk = self._tok_dev[:, 0].cpu().numpy()  # the step's one sync
                sp.set(active=int(active.size), step=self.steps)
            dt = time.perf_counter() - t0
            if self.on_logits is not None:
                self.on_logits("decode", [(int(b), self.slot_req[b].uid)
                                          for b in active], logits, inputs)
            for b in active:
                tok = int(tk[b])
                self.hist[b].append(tok)
                self.lens[b] += 1
                self.gen[b] += 1
                emitted += 1
                self._maybe_retire(b, tok)
            self.tokens_out += emitted
        self.steps += 1
        if self.metrics is not None:
            observe_serve_step(
                self.metrics, new_tokens=emitted,
                queue_depth=len(self.queue),
                occupancy=active.size / self.max_batch, decode_s=dt)
        return emitted

    def run(self, *, max_steps: int = 10_000) -> list:
        """Step until queue and slots drain; returns retired Results."""
        n0 = len(self.completed)
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        return self.completed[n0:]

    def _maybe_retire(self, slot: int, tok: int):
        req = self.slot_req[slot]
        done_eos = req.eos_id is not None and tok == req.eos_id
        done_len = (self.gen[slot] >= req.max_new
                    or self.lens[slot] >= self.max_len)
        if not (done_eos or done_len):
            return
        self.completed.append(Result(
            uid=req.uid, tokens=self.hist[slot][self.prompt_len[slot]:],
            finish_reason="eos" if done_eos else "length",
            weight_versions=self.slot_versions[slot]))
        self.free_pages.extend(int(p) for p in self.tables[slot])
        self.tables[slot] = paged.NULL_PAGE
        self.lens[slot] = 0
        self.hist[slot] = None
        self.slot_req[slot] = None
        self.gen[slot] = 0
        self._dirty = True          # slot membership changed

    # ------------------------------------------------------------------
    # Live weight hot-swap
    # ------------------------------------------------------------------

    def install_weights(self, weights, *, version: int | None = None):
        """Install new weights between decode steps.

        ``weights``: a param tree, or a published ``BucketState``
        (single-copy, or worker-stacked ``leading=1`` — averaged bucket by
        bucket in float32, never through a per-leaf view).  Every resident
        sequence's history is re-prefilled under the new weights so its
        continuation matches a restart on the new version.
        """
        t0 = time.perf_counter()
        with self.tracer.span("swap") as sp:
            if flatbuf.is_bucket_state(weights):
                from repro_torch.serving.publish import consensus_buckets
                weights = consensus_buckets(weights.with_buckets(
                    [b.to(self.device) for b in weights.buckets]))
                self.params = weights.unpack()
            else:
                self.params = weights
            self.weight_version = (version if version is not None
                                   else self.weight_version + 1)
            residents = [b for b in range(self.max_batch) if self.lens[b] > 0]
            if residents:
                self._prefill_batch([(b, self.hist[b][:-1])
                                     for b in residents], emit=False)
            for b in residents:
                self.slot_versions[b] = (self.slot_versions[b]
                                         + (self.weight_version,))
            _sync(self.device)
            sp.set(version=self.weight_version, residents=len(residents))
        if self.metrics is not None:
            observe_swap(self.metrics, version=self.weight_version,
                         swap_s=time.perf_counter() - t0)

    def poll_weights(self, subscriber) -> int | None:
        """Install the latest published version if it is newer than the
        resident one (see :class:`repro_torch.serving.publish.WeightSubscriber`).
        Returns the installed version or None."""
        got = subscriber.poll(newer_than=self.weight_version)
        if got is None:
            return None
        version, state = got
        self.install_weights(state, version=version)
        return version

    # ------------------------------------------------------------------

    def describe(self) -> dict:
        pl = self.pl
        return {
            "arch": self.cfg.name, "max_batch": self.max_batch,
            "max_len": self.max_len, "page_size": pl.page_size,
            "num_pages": pl.num_pages, "pages_per_seq": pl.pages_per_seq,
            "free_pages": len(self.free_pages),
            "pool_bytes": pl.pool_bytes(),
            "active": self.num_active, "queued": len(self.queue),
            "steps": self.steps, "tokens_out": self.tokens_out,
            "weight_version": self.weight_version,
        }
