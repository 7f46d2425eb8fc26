"""Continuous-batching slot scheduler over a paged or contiguous KV pool
(port of trlx_tpu.serve.slots).

- :class:`SlotPoolRuntime` owns the device half: the pool (pages of bf16
  or, under ``serve.kv_dtype: int8``, int8 codes + float32 scales; or,
  under ``serve.kv_layout: contiguous``, one region per slot), the
  per-slot lanes, and the primitives (trlx_tpu_torch.models.generation)
  — ``prefill_into_slots`` per admission bucket (plain, or the
  prefix-context variant when a request hit the radix cache),
  ``decode_step`` for all slots at once and, under speculation,
  ``verify_step`` — each behind its own
  :func:`~trlx_tpu_torch.utils.aotjit.aot_jit` (on the card, one CUDA
  graph per bucket and variant, one for the step and one for the verify
  pass, all captured at warmup, as trlx_tpu keeps one executable each).
  Pool and lanes are static buffers updated in place. ``serve.attention:
  pallas`` hands decode the hand-written paged-decode kernel, which then
  runs inside the step's graph at either KV tier; prefill and the verify
  pass are plain torch.
- :class:`SlotScheduler` runs the host loop on one worker thread: at
  every step boundary it harvests finished rows (EOS, or the request's
  own ``max_new_tokens``), frees their slots (and pages), and admits
  queued requests into free slots. Paged: radix-matching each prompt,
  mapping hit pages copy-free into its page table, reserving pages for
  the unmatched suffix + decode budget, and prefilling only the suffix;
  page exhaustion leaves requests QUEUED, never failed. Contiguous: the
  whole left-padded prompt into the slot's own region. Under
  ``serve.speculation`` each step first gathers proposals (the lookup
  tier's per-slot n-gram index and the radix cache, or the draft model;
  trlx_tpu_torch.serve.speculate) and verifies them in one
  ``verify_step``; a dry or faulting proposal (the ``serve_speculate``
  chaos seam included) falls back to a plain step
  (``serve/spec_fallbacks``).

The worker enters the serve supervisor when one is given and marks each
step as the ``serve_decode`` phase (its chaos seam inside) with a
heartbeat, each admission as ``serve_admit``.

Not ported in this slice: tenants/quotas/brownout, crash-only replay,
graceful drain, hot-swap, request tracing and the flight recorder. A
step that raises fails the requests in flight (the reference's
last-resort containment) and the loop keeps serving.
"""

import contextlib
import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch import supervisor, telemetry
from trlx_tpu_torch.models.generation import (
    _segments_of,
    decode_step,
    init_page_pool,
    init_slot_pool,
    init_slot_state,
    prefill_into_slots,
    verify_step,
)
from trlx_tpu_torch.serve.batcher import QueueFull, Request
from trlx_tpu_torch.serve.paged import RadixCache
from trlx_tpu_torch.supervisor import chaos, monotonic
from trlx_tpu_torch.telemetry.flops import kv_bytes_per_token
from trlx_tpu_torch.utils.aotjit import aot_jit


def _prefill(spec, blocks, embed, ln_f, pool, state, inputs, compute_dtype,
             page_size, suffix) -> None:
    """One admission bucket, in place on pool and lanes (a graph per
    bucket and variant on the card); ``page_tables`` and ``start`` are
    None under the contiguous layout."""
    tokens, mask, slot_ids, max_new, page_tables, start = inputs
    prefill_into_slots(
        spec, blocks, embed, ln_f, pool, state, tokens, mask, slot_ids,
        max_new, compute_dtype=compute_dtype, page_tables=page_tables,
        page_size=page_size, start=start, prefix_context=suffix,
    )


def _step(spec, blocks, embed, ln_f, pool, state, generator, config,
          compute_dtype, paged_decode_fn) -> torch.Tensor:
    """One decode step for every slot; tokens, emitted and finished
    packed into one int32 [3, S] tensor, so the host reads them in one
    copy."""
    _, _, tok, emitted, finished = decode_step(
        spec, blocks, embed, ln_f, pool, state, generator, config,
        compute_dtype=compute_dtype, paged_decode_fn=paged_decode_fn,
    )
    return torch.stack([tok, emitted.int(), finished.int()])


def _verify(spec, blocks, embed, ln_f, pool, state, generator, proposals,
            n_proposed, config, compute_dtype) -> torch.Tensor:
    """One speculative verify pass for every slot; candidates [S, K+1],
    counts and finished packed into one int32 [S, K+3] tensor."""
    _, _, cand, counts, finished = verify_step(
        spec, blocks, embed, ln_f, pool, state, generator, proposals,
        n_proposed, config, compute_dtype=compute_dtype,
    )
    return torch.cat([cand, counts[:, None], finished.int()[:, None]], 1)


class SlotPoolRuntime:
    """Device half of the slot scheduler: the pool, per-slot lanes, and
    the prefill / step / verify calls."""

    STEP_SPAN = "serve/slot_step"
    VERIFY_SPAN = "serve/spec_verify"

    def __init__(self, engine, num_slots: Optional[int] = None):
        from trlx_tpu_torch.ops.paged_attention import make_paged_decode_fn

        self.engine = engine
        self.device = engine.device
        self.num_slots = engine.slot_count() if num_slots is None \
            else int(num_slots)
        self.kv_layout = engine.serve.kv_layout
        self._segments, self._seg_sizes = _segments_of(engine.blocks)
        self._vocab = engine.spec.vocab_size
        if self.kv_layout == "paged":
            self.page_size = engine.page_size_tokens()
            self.max_pages = engine.pages_per_slot()
            self.num_pages = engine.page_count()
            # logical per-slot extent rounds UP to whole pages
            self.buffer_len = self.max_pages * self.page_size
            # serve.kv_dtype picks the pool tier (bf16 at any compute
            # dtype, or int8 (codes, scales) pairs)
            cache_dtype = torch.int8 if engine.serve.kv_dtype == "int8" \
                else torch.bfloat16
            self.pool = init_page_pool(
                engine.spec, self._seg_sizes, self.num_pages,
                self.page_size, cache_dtype, self.device,
            )
        else:
            self.page_size = self.max_pages = self.num_pages = 0
            self.buffer_len = engine.slot_buffer_len()
            self.pool = init_slot_pool(
                engine.spec, self._seg_sizes, self.num_slots,
                self.buffer_len, torch.bfloat16, self.device,
            )
        self.state = self._fresh_state()
        #: one sampling stream, re-seeded per step from serve.seed + step
        self.generator = torch.Generator(device=self.device)
        self.paged_decode_fn = (
            make_paged_decode_fn() if engine.serve.attention == "pallas"
            else None
        )
        #: speculation: K proposals verified per step (0 = off); K is
        #: static, so the verify pass is one more graph
        self.spec_k = (int(engine.serve.spec_k)
                       if engine.serve.speculation != "off" else 0)
        #: decode steps run (kernel launches = steps x layers under
        #: pallas); verify passes run
        self.steps = 0
        self.verify_steps = 0
        self.warmed = False
        self._step_fn = aot_jit(_step)
        self._verify_fn = aot_jit(_verify)
        self._prefill_fns = {}  # (Bp, P[, suffix]) -> its own aot_jit

    def _fresh_state(self):
        return init_slot_state(self.num_slots, self.buffer_len, self._vocab,
                               self.max_pages or None, self.device)

    def prefill_span(self, bucket, suffix: bool = False) -> str:
        Bp, P = bucket
        return f"serve/prefill{'_sfx' if suffix else ''}_b{Bp}p{P}"

    @torch.no_grad()
    def prefill(self, bucket, tokens: np.ndarray, mask: np.ndarray,
                slot_ids, max_new, page_tables=None, start=None,
                suffix: bool = False) -> None:
        """Admit one prompt bucket into the pool: filler rows carry the
        out-of-range slot id and are dropped. Paged: ``page_tables``
        maps each row's logical pages (sentinel-padded), ``start`` is its
        committed prefix length, ``suffix=True`` attends to the committed
        prefix, tokens are right-padded. Contiguous: tokens left-padded,
        no tables. The host arrays become device tensors before the
        bucket's graph."""
        e = self.engine
        paged = self.kv_layout == "paged"
        key = (*bucket, bool(suffix)) if paged else tuple(bucket)
        fn = self._prefill_fns.get(key)
        if fn is None:
            fn = self._prefill_fns[key] = aot_jit(_prefill)
        arrays = (tokens, mask, slot_ids, max_new) + (
            (page_tables, start) if paged else (None, None))
        with telemetry.span(self.prefill_span(bucket, suffix)):
            inputs = tuple(
                None if x is None else torch.as_tensor(
                    np.ascontiguousarray(x, np.int32), device=self.device)
                for x in arrays)
            fn(e.spec, e.blocks, e.embed, e.ln_f, self.pool, self.state,
               inputs, e.compute_dtype, self.page_size or None,
               bool(suffix))

    @torch.no_grad()
    def step(self, seed: int):
        """One decode step for every slot; returns host numpy (tokens [S],
        emitted [S], finished [S]), read in one device-to-host copy. The
        step's stream is re-seeded with ``seed`` first, which the graph's
        replay reads. The span closes after the results reach the host,
        so it times the device work too."""
        e = self.engine
        self.generator.manual_seed(int(seed))
        with telemetry.span(self.STEP_SPAN):
            out = self._step_fn(
                e.spec, e.blocks, e.embed, e.ln_f, self.pool, self.state,
                self.generator, e.gen_config, e.compute_dtype,
                self.paged_decode_fn,
            )
            self.steps += 1
            tok, emitted, finished = out.cpu().numpy()
            return tok, emitted.astype(bool), finished.astype(bool)

    @torch.no_grad()
    def verify(self, seed: int, proposals: np.ndarray,
               n_proposed: np.ndarray):
        """One speculative verify pass for every slot: the K proposals
        and the free token scored together. Returns host numpy (cand
        [S, K+1], counts [S], finished [S]); slot s emits
        ``cand[s, :counts[s]]``."""
        e = self.engine
        self.generator.manual_seed(int(seed))
        with telemetry.span(self.VERIFY_SPAN):
            out = self._verify_fn(
                e.spec, e.blocks, e.embed, e.ln_f, self.pool, self.state,
                self.generator,
                torch.as_tensor(np.ascontiguousarray(proposals, np.int32),
                                device=self.device),
                torch.as_tensor(np.ascontiguousarray(n_proposed, np.int32),
                                device=self.device),
                e.gen_config, e.compute_dtype,
            )
            self.verify_steps += 1
            out = out.cpu().numpy()
            K1 = out.shape[1] - 2
            return out[:, :K1], out[:, K1], out[:, K1 + 1].astype(bool)

    def graphs(self):
        """Every captured graph of this runtime (capture seconds, pool
        bytes)."""
        fns = [self._step_fn, self._verify_fn, *self._prefill_fns.values()]
        return [g for fn in fns for g in fn.graphs()]

    def reset_lanes(self) -> None:
        """All-free lanes, refilled in place (the graphs read these
        buffers), reusing the pool (zeroed lanes gate every read of
        it)."""
        for lane, fresh in zip(self.state, self._fresh_state()):
            if lane is not None:
                lane.copy_(fresh)

    def warmup(self) -> Dict[str, float]:
        """Run every admission bucket (paged: both variants) against the
        live pool with all rows aimed at the drop sentinel, then one
        decode step over the all-free pool — which builds the decode
        kernel under ``attention: pallas`` on the card and, there,
        captures every graph — and, under speculation, one verify pass
        (every row non-emitting: pure shape). Touches no slot. Returns
        {span: first-call seconds} (on the card: the eager first call
        plus the capture)."""
        pad = self.engine.pad_token_id
        paged = self.kv_layout == "paged"
        variants = (False, True) if paged else (False,)
        spans = [self.STEP_SPAN]
        for P, extents in self.engine.prompt_classes():
            for Bp in extents:
                for suffix in variants:
                    spans.append(self.prefill_span((Bp, P), suffix))
                    tokens = np.full((Bp, P), pad, np.int32)
                    mask = np.zeros((Bp, P), np.int32)
                    col = 0 if paged else -1  # paged prompts: right-padded
                    tokens[:, col] = 0
                    mask[:, col] = 1
                    self.prefill(
                        (Bp, P), tokens, mask,
                        np.full((Bp,), self.num_slots, np.int32),
                        np.ones((Bp,), np.int32),
                        page_tables=np.full((Bp, self.max_pages),
                                            self.num_pages, np.int32)
                        if paged else None,
                        start=np.zeros((Bp,), np.int32) if paged else None,
                        suffix=suffix,
                    )
        self.step(0)
        if self.spec_k > 0:
            spans.append(self.VERIFY_SPAN)
            self.verify(0, np.zeros((self.num_slots, self.spec_k), np.int32),
                        np.zeros((self.num_slots,), np.int32))
        latencies = {}
        tel = telemetry.current()
        if tel is not None:
            for span in spans:
                hist = tel.registry.hists.get(f"time/{span}")
                if hist is not None and hist.first is not None:
                    latencies[span] = hist.first
        self.warmed = True
        telemetry.set_gauge(
            "serve/slot_programs_warmed",
            len(self._prefill_fns) + 1 + (1 if self.spec_k > 0 else 0))
        return latencies


class _LiveSlot:
    """Host bookkeeping for one occupied slot: its request, emitted
    tokens and, under the paged layout, its page-table content (one
    allocator reference per entry) and the pages its admission committed
    to the radix tree."""

    __slots__ = ("request", "tokens", "pages", "committed")

    def __init__(self, request: Request, pages=None, committed=None):
        self.request = request
        self.tokens: List[int] = []
        self.pages: List[int] = pages or []
        self.committed: List[int] = committed or []


class SlotScheduler:
    """The continuous-batching decode driver: one worker thread running
    the admit -> step -> harvest loop over the slot pool. Same
    ``submit`` / ``start`` / ``stop`` / ``queue_depth`` surface as the
    static :class:`~trlx_tpu_torch.serve.batcher.MicroBatcher`.

    ``run_supervisor`` (a RunSupervisor) is entered by the worker thread;
    ``draft`` injects the draft tier's proposer (otherwise built from
    ``serve.spec_draft_checkpoint`` under ``speculation: draft``)."""

    def __init__(self, engine, max_queue: Optional[int] = None,
                 slots: Optional[int] = None, run_supervisor=None,
                 draft=None):
        self.engine = engine
        cfg = engine.serve
        self.max_queue = cfg.max_queue if max_queue is None else max_queue
        self.run_supervisor = run_supervisor
        self.runtime = SlotPoolRuntime(engine, num_slots=slots)
        #: host paged-KV broker (allocator + radix prefix cache); None
        #: under the contiguous layout
        self.cache: Optional[RadixCache] = None
        if self.runtime.kv_layout == "paged":
            self.cache = RadixCache(self.runtime.num_pages,
                                    self.runtime.page_size)
        self._prompt_tokens_total = 0
        self._prefix_tokens_saved = 0
        self._queue = deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._free = list(range(self.runtime.num_slots))
        self._live: Dict[int, _LiveSlot] = {}
        self._step_counter = 0
        self._starved = False
        # -- speculation: propose -> verify -> accept each step -------- #
        self._spec_mode = cfg.speculation
        self.spec_k = self.runtime.spec_k
        #: the lookup tier's per-slot state, dropped at harvest
        self._speculators: Dict[int, object] = {}
        self._draft = draft
        if self._spec_mode == "draft" and draft is None \
                and cfg.spec_draft_checkpoint:
            from trlx_tpu_torch.serve.speculate import DraftProposer

            self._draft = DraftProposer.from_checkpoint(
                cfg.spec_draft_checkpoint, engine, self.spec_k)
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        #: slots that emitted in verify passes, and the tokens they emitted
        self._spec_slot_passes = 0
        self._spec_tokens = 0

    # -- lifecycle ------------------------------------------------------ #

    def warmup(self) -> Dict[str, float]:
        """The runtime's warmup, then one draft proposal over dead rows
        (so the draft's graph, too, is captured before traffic)."""
        latencies = self.runtime.warmup()
        if self.spec_k > 0 and self._draft is not None:
            self._draft.propose([None] * self.runtime.num_slots)
        return latencies

    @property
    def warmed(self) -> bool:
        return self.runtime.warmed

    def graphs(self):
        """The runtime's captured graphs and the draft's."""
        draft = self._draft.graphs() if self._draft is not None else []
        return self.runtime.graphs() + list(draft)

    def start(self) -> "SlotScheduler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="trlx-torch-serve-slots", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
        live = list(self._live.values())
        self._live.clear()
        self._speculators.clear()
        self._free = list(range(self.runtime.num_slots))
        for req in pending + [s.request for s in live]:
            req.error = RuntimeError("serve slot scheduler stopped")
            req.done.set()

    # -- submission ----------------------------------------------------- #

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def free_slots(self) -> int:
        return len(self._free)

    def retry_after_s(self) -> int:
        """The 429 ``Retry-After`` hint: queue depth x recent step p50,
        never below 1 s."""
        p50 = 0.05
        tel = telemetry.current()
        if tel is not None:
            hist = tel.registry.hists.get(f"time/{SlotPoolRuntime.STEP_SPAN}")
            if hist is not None and hist.count:
                p50 = max(hist.quantile(0.5), 1e-4)
        return max(1, int(-(-(self.queue_depth() * p50) // 1)))

    def submit(self, tokens: List[int], max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None) -> Request:
        """Enqueue one request. ValueError when no bucket (or the page
        pool) can ever hold it, QueueFull past ``max_queue``."""
        if not tokens:
            raise ValueError("empty prompt: at least one token is required")
        if max_new_tokens is None:
            max_new_tokens = self.engine.default_max_new_tokens()
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        shape = self.engine.pick_shape(len(tokens), max_new_tokens)
        if self.cache is not None:
            need = self.engine.request_page_need(len(tokens), max_new_tokens)
            if need > self.runtime.num_pages:
                raise ValueError(
                    f"request needs {need} KV pages worst-case but the "
                    f"pool holds {self.runtime.num_pages}; raise "
                    f"serve.pages (or serve.page_size)"
                )
        req = Request(list(tokens), max_new_tokens, shape, seed=seed)
        with self._cond:
            if len(self._queue) >= self.max_queue:
                telemetry.inc("serve/rejected")
                raise QueueFull(
                    f"serve queue is full ({self.max_queue} pending); retry "
                    f"with backoff"
                )
            self._queue.append(req)
            telemetry.inc("serve/requests")
            telemetry.set_gauge("serve/queue_depth", len(self._queue))
            self._cond.notify_all()
        return req

    # -- worker --------------------------------------------------------- #

    def _occupancy(self) -> float:
        return len(self._live) / max(self.runtime.num_slots, 1)

    def _admit(self) -> None:
        """Move queued requests into free slots, one prompt-class bucket
        at a time (the oldest request's class first, FIFO within it)."""
        while True:
            with self._cond:
                self._starved = bool(self._queue) and not self._free
                if not self._queue or not self._free:
                    return
                P = min(self._queue, key=lambda r: r.seq).shape[0]
                extents = self.engine.prefill_batch_sizes(P)
                same = sorted((r for r in self._queue if r.shape[0] == P),
                              key=lambda r: r.seq)
                batch = same[:min(len(same), len(self._free), extents[-1])]
                for r in batch:
                    self._queue.remove(r)
                telemetry.set_gauge("serve/queue_depth", len(self._queue))
            admitted_all = True
            with supervisor.phase("serve_admit"):
                try:
                    chaos.maybe_inject("serve_admit")
                    admitted_all = self._prefill_batch(batch, P, extents)
                except Exception as e:  # a failed admission fails its batch
                    telemetry.inc("serve/request_errors", len(batch))
                    for r in batch:
                        r.error = e
                        r.done.set()
                supervisor.beat()
            if not admitted_all:
                # page pool exhausted: the rest stay QUEUED until
                # harvests return pages — keep stepping the live slots
                self._starved = True
                return

    def _spawn_speculator(self, slot: int, history: List[int]) -> None:
        """The lookup tier's per-slot state: an n-gram index over the
        request's own prompt (bounded by ``serve.spec_index_max_keys``,
        dropped at harvest)."""
        if self.spec_k <= 0 or self._spec_mode != "lookup":
            return
        from trlx_tpu_torch.serve.speculate import SlotSpeculator

        cfg = self.engine.serve
        self._speculators[slot] = SlotSpeculator(
            history, self.spec_k, ngram_max=int(cfg.spec_ngram_max),
            max_keys=int(cfg.spec_index_max_keys))

    def _prefill_batch(self, batch: List[Request], P: int, extents) -> bool:
        """Prefill one admission batch; returns False when the paged
        allocator ran dry and part of the batch went back to the queue."""
        if self.cache is not None:
            return self._prefill_batch_paged(batch, P, extents)
        Bp = next(b for b in extents if b >= len(batch))
        slots = [self._free.pop() for _ in batch]
        slot_ids = slots + [self.runtime.num_slots] * (Bp - len(batch))
        tokens, mask = self.engine.pad_batch([r.tokens for r in batch],
                                             (Bp, P, 0))
        max_new = [r.max_new_tokens for r in batch] + [1] * (Bp - len(batch))
        try:
            self.runtime.prefill((Bp, P), tokens, mask, slot_ids, max_new)
        except Exception:
            self._free.extend(slots)  # nothing was admitted
            raise
        for r, s in zip(batch, slots):
            self._live[s] = _LiveSlot(r)
            self._spawn_speculator(s, r.tokens)
        telemetry.inc("serve/admissions", len(batch))
        telemetry.set_gauge("serve/slot_occupancy", self._occupancy())
        return True

    def _prefill_batch_paged(self, batch: List[Request], P: int,
                             extents) -> bool:
        """Paged admission: radix-match each prompt, reserve pages for the
        unmatched suffix + decode budget, map hit pages copy-free, and
        prefill ONLY the suffix. Requests the allocator cannot cover
        (even after LRU eviction) go back to the queue head in order.
        Returns False when that happened."""
        ps = self.runtime.page_size
        plans = []  # (request, toks, matched, pages, committed)
        deferred: List[Request] = []
        for i, r in enumerate(batch):
            toks = r.tokens[-P:]
            matched = self.cache.match(toks)
            need = self.engine.request_page_need(
                len(toks), r.max_new_tokens
            ) - len(matched)
            fresh = self.cache.alloc(need)
            if fresh is None:
                self.cache.release_all(matched)
                deferred = batch[i:]
                break
            pages = matched + fresh
            committed = self.cache.commit(toks, pages)
            plans.append((r, toks, matched, pages, committed))
        if deferred:
            with self._cond:
                for r in reversed(deferred):
                    self._queue.appendleft(r)
                telemetry.set_gauge("serve/queue_depth", len(self._queue))
            # the caller's failure path must not fail re-queued rows
            batch[:] = [p[0] for p in plans]
        if not plans:
            telemetry.set_gauge("serve/pages_free", self.cache.free_pages())
            return False

        rt = self.runtime
        Bp = next(b for b in extents if b >= len(plans))
        slots = [self._free.pop() for _ in plans]
        tokens = np.full((Bp, P), self.engine.pad_token_id, np.int32)
        mask = np.zeros((Bp, P), np.int32)
        page_tables = np.full((Bp, rt.max_pages), rt.num_pages, np.int32)
        starts = np.zeros((Bp,), np.int32)
        max_new = np.ones((Bp,), np.int32)
        slot_ids = np.full((Bp,), rt.num_slots, np.int32)
        for j, ((r, toks, matched, pages, _), s) in enumerate(
            zip(plans, slots)
        ):
            start = len(matched) * ps
            suf = toks[start:]
            tokens[j, :len(suf)] = suf  # right-padded suffix
            mask[j, :len(suf)] = 1
            page_tables[j, :len(pages)] = pages
            starts[j] = start
            max_new[j] = r.max_new_tokens
            slot_ids[j] = s
        try:
            rt.prefill((Bp, P), tokens, mask, slot_ids, max_new,
                       page_tables=page_tables, start=starts,
                       suffix=bool(starts.any()))
        except Exception:
            self._free.extend(slots)  # nothing was admitted
            for *_, committed in reversed(plans):
                self.cache.rollback(committed)  # content never landed
            for _, _, _, pages, _ in plans:
                self.cache.release_all(pages)
            raise
        saved = 0
        for (r, toks, matched, pages, committed), s in zip(plans, slots):
            self._live[s] = _LiveSlot(r, pages, committed)
            self._spawn_speculator(s, r.tokens)
            saved += len(matched) * ps
            self._prompt_tokens_total += len(toks)
        self._prefix_tokens_saved += saved
        if saved:
            telemetry.inc("serve/prefix_tokens_saved", saved)
        telemetry.inc("serve/admissions", len(plans))
        telemetry.set_gauge("serve/slot_occupancy", self._occupancy())
        telemetry.set_gauge("serve/pages_free", self.cache.free_pages())
        telemetry.set_gauge("serve/prefix_hit_rate", self._hit_rate())
        return not deferred

    def _hit_rate(self) -> float:
        return self._prefix_tokens_saved / max(self._prompt_tokens_total, 1)

    def pool_stats(self) -> Dict:
        """Host view of the KV pool — the /healthz ``kv`` block."""
        rt = self.runtime
        kv_dtype = self.engine.serve.kv_dtype
        pool_bytes = 0
        for seg in rt.pool:
            for side in seg:
                for t in (side if isinstance(side, tuple) else (side,)):
                    pool_bytes += t.numel() * t.element_size()
        stats = {
            "kv_layout": rt.kv_layout,
            "kv_dtype": kv_dtype,
            "kv_bytes_per_token": kv_bytes_per_token(self.engine.spec,
                                                     kv_dtype),
            "slots": rt.num_slots,
            "pool_gb": round(pool_bytes / 2**30, 6),
            "decode_steps": rt.steps,
        }
        if self.cache is not None:
            stats.update(
                page_size=rt.page_size,
                pages_total=rt.num_pages,
                pages_free=self.cache.free_pages(),
                pages_cached=self.cache.cached_pages(),
                evicted_pages=self.cache.evicted_pages,
                prefix_hit_rate=round(self._hit_rate(), 4),
                prefix_tokens_saved=self._prefix_tokens_saved,
            )
        if self.spec_k > 0:
            stats["speculation"] = {
                "mode": self._spec_mode, "k": self.spec_k,
                "proposed": self._spec_proposed_total,
                "accepted": self._spec_accepted_total,
                "acceptance_rate": round(self._spec_acceptance_rate(), 4),
                "verify_steps": rt.verify_steps,
                # tokens a slot emits per verify pass (1 = no gain)
                "tokens_per_slot_pass": round(
                    self._spec_tokens / max(self._spec_slot_passes, 1), 4),
            }
        return stats

    # -- speculation ---------------------------------------------------- #

    def _clamp_proposal(self, live: _LiveSlot, n: int) -> int:
        """Cap a slot's proposal at the request's remaining budget: the
        free token spends one, so at most ``remaining - 1`` proposals
        can be accepted (the device clamps the same way)."""
        remaining = live.request.max_new_tokens - len(live.tokens)
        return max(0, min(n, self.spec_k, remaining - 1))

    def _spec_acceptance_rate(self) -> float:
        return self._spec_accepted_total / max(self._spec_proposed_total, 1)

    def _gather_proposals(self):
        """The host half of propose -> verify -> accept: one [S, K]
        proposal batch from the active tier, or None when every row is
        dry — a plain step then. Any proposal-side fault (the
        ``serve_speculate`` chaos seam included) also returns None:
        nothing was dispatched yet, so the step completes unspeculated
        and ``serve/spec_fallbacks`` counts it.

        Each tier ships the first K tokens of its continuation of the
        history, as trlx_tpu does. ``verify_step`` forwards
        ``[t0, proposals...]`` and accepts proposal j iff it is the
        greedy token after candidate j, while the history's next token
        is t0 itself: a proposal sits one position early and is
        accepted only where a token repeats its predecessor (ROADMAP
        queue 3). The greedy tokens are the same either way."""
        try:
            chaos.maybe_inject("serve_speculate")
            S, K = self.runtime.num_slots, self.spec_k
            props = np.zeros((S, K), np.int32)
            nprops = np.zeros((S,), np.int32)
            if self._spec_mode == "draft" and self._draft is not None:
                histories: List[Optional[List[int]]] = [None] * S
                for s, live in self._live.items():
                    histories[s] = live.request.tokens + live.tokens
                drafted = self._draft.propose(histories)
                for s, live in self._live.items():
                    p = drafted[s][:K]
                    n = self._clamp_proposal(live, len(p))
                    props[s, :n] = p[:n]
                    nprops[s] = n
            else:
                for s, live in self._live.items():
                    sp = self._speculators.get(s)
                    if sp is None:
                        continue
                    p = sp.propose(self.cache)[:K]
                    n = self._clamp_proposal(live, len(p))
                    props[s, :n] = p[:n]
                    nprops[s] = n
            if not nprops.any():
                return None
            return props, nprops
        except Exception:
            telemetry.inc("serve/spec_fallbacks")
            return None

    # -- the step ------------------------------------------------------- #

    def _step(self) -> None:
        plan = None
        with supervisor.phase("serve_decode"):
            chaos.maybe_inject("serve_decode")
            seed = self.engine.serve.seed + self._step_counter
            self._step_counter += 1
            if self.spec_k > 0 and self._live:
                plan = self._gather_proposals()
            if plan is not None:
                # K proposals + the free token in ONE verify pass; each
                # slot emits its longest greedy-matching prefix (>= 1)
                props, nprops = plan
                cand, counts, finished = self.runtime.verify(
                    seed, props, nprops)
                proposed = int(nprops.sum())
                accepted = int(np.maximum(counts - 1, 0).sum())
                span = self.runtime.VERIFY_SPAN
            else:
                tok, emitted, finished = self.runtime.step(seed)
                # a plain step is the counts <= 1 case of the same harvest
                cand = tok[:, None]
                counts = emitted.astype(np.int32)
                proposed = accepted = 0
                span = self.runtime.STEP_SPAN
            supervisor.beat()
        if self._starved:
            telemetry.inc("serve/preempted_steps")
        if plan is not None:
            if proposed:
                telemetry.inc("serve/spec_proposed", proposed)
            if accepted:
                # each accepted proposal is one step the target never ran
                telemetry.inc("serve/spec_accepted", accepted)
                telemetry.inc("serve/spec_steps_saved", accepted)
            self._spec_proposed_total += proposed
            self._spec_accepted_total += accepted
            self._spec_slot_passes += int((counts > 0).sum())
            self._spec_tokens += int(counts.sum())
            telemetry.set_gauge("serve/spec_acceptance_rate",
                                self._spec_acceptance_rate())
        done_at = monotonic()
        emitted_total = 0
        for slot in list(self._live):
            live = self._live[slot]
            c = int(counts[slot])
            if c:
                toks = [int(t) for t in cand[slot, :c]]
                live.tokens.extend(toks)
                emitted_total += c
                sp = self._speculators.get(slot)
                if sp is not None:
                    sp.append(toks)
            if finished[slot]:
                req = live.request
                req.result = live.tokens
                req.latency_s = done_at - req.enqueued_at
                telemetry.observe("serve/request_latency", req.latency_s,
                                  labels={"path": "slots"})
                req.done.set()
                del self._live[slot]
                self._speculators.pop(slot, None)
                self._free.append(slot)
                if self.cache is not None:
                    # committed (trie-owned) pages stay cached at
                    # refcount 0; the rest return to the free list
                    self.cache.release_all(live.pages)
                telemetry.inc("serve/evictions")
                telemetry.inc("serve/responses")
        if emitted_total:
            telemetry.inc("serve/generated_tokens", emitted_total)
            tel = telemetry.current()
            if tel is not None:
                hist = tel.registry.hists.get(f"time/{span}")
                if hist is not None and hist.last > 0:
                    telemetry.set_gauge("serve/tokens_per_sec",
                                        emitted_total / hist.last)
        telemetry.set_gauge("serve/slot_occupancy", self._occupancy())
        if self.cache is not None:
            telemetry.set_gauge("serve/pages_free", self.cache.free_pages())

    def _fail_live(self, error: BaseException) -> None:
        """Containment for a step that raised: fail every in-flight
        request, free all slots, reset lanes + prefix cache (the pool's
        content can no longer be trusted), keep the loop serving."""
        live = list(self._live.values())
        self._live.clear()
        self._speculators.clear()
        self._free = list(range(self.runtime.num_slots))
        telemetry.inc("serve/request_errors", len(live))
        self.runtime.reset_lanes()
        if self.cache is not None:
            self.cache = RadixCache(self.runtime.num_pages,
                                    self.runtime.page_size)
        for s in live:
            s.request.error = error
            s.request.done.set()
        telemetry.set_gauge("serve/slot_occupancy", 0.0)

    def _run(self) -> None:
        with self.run_supervisor or contextlib.nullcontext():
            while not self._stop.is_set():
                self._admit()
                if not self._live:
                    with self._cond:
                        if not self._queue and not self._stop.is_set():
                            self._cond.wait(timeout=0.1)
                    continue
                try:
                    self._step()
                except Exception as e:  # the worker must keep serving
                    self._fail_live(e)
