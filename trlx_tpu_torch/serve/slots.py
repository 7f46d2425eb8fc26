"""Continuous-batching slot scheduler over a paged KV pool (port of
trlx_tpu.serve.slots).

- :class:`SlotPoolRuntime` owns the device half: the page pool, the
  per-slot lanes, and the two primitives (trlx_tpu_torch.models
  .generation) — ``prefill_into_slots`` per admission bucket (plain, or
  the prefix-context variant when a request hit the radix cache) and
  ``decode_step`` for all slots at once, each behind its own
  :func:`~trlx_tpu_torch.utils.aotjit.aot_jit` (on the card, one CUDA
  graph per bucket and variant and one for the step, captured at
  warmup, as trlx_tpu keeps one executable each). Pool and lanes are
  static buffers updated in place. ``serve.attention: pallas`` hands
  decode the hand-written paged-decode kernel, which then runs inside
  the step's graph; prefill is plain torch either way.
- :class:`SlotScheduler` runs the host loop on one worker thread: at
  every step boundary it harvests finished rows (EOS, or the request's
  own ``max_new_tokens``), frees their slots and pages, and admits
  queued requests into free slots — radix-matching each prompt, mapping
  hit pages copy-free into its page table, reserving pages for the
  unmatched suffix + decode budget, and prefilling only the suffix. Page
  exhaustion leaves requests QUEUED, never failed.

Not ported in this slice: the contiguous layout, speculation and
``verify_step``, tenants/quotas/brownout, crash-only replay, graceful
drain, hot-swap, request tracing and the flight recorder. A step that
raises fails the requests in flight (the reference's last-resort
containment) and the loop keeps serving.
"""

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.models.generation import (
    _segments_of,
    decode_step,
    init_page_pool,
    init_slot_state,
    prefill_into_slots,
)
from trlx_tpu_torch.serve.batcher import QueueFull, Request
from trlx_tpu_torch.serve.paged import RadixCache
from trlx_tpu_torch.supervisor import monotonic
from trlx_tpu_torch.utils.aotjit import aot_jit


def _prefill(spec, blocks, embed, ln_f, pool, state, inputs, compute_dtype,
             page_size, suffix) -> None:
    """One admission bucket, in place on pool and lanes (a graph per
    bucket and variant on the card)."""
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


class SlotPoolRuntime:
    """Device half of the slot scheduler: page pool, per-slot lanes, and
    the prefill/step calls."""

    STEP_SPAN = "serve/slot_step"

    def __init__(self, engine, num_slots: Optional[int] = None):
        from trlx_tpu_torch.ops.paged_attention import make_paged_decode_fn

        self.engine = engine
        self.device = engine.device
        self.num_slots = engine.slot_count() if num_slots is None \
            else int(num_slots)
        self.kv_layout = engine.serve.kv_layout
        self._segments, self._seg_sizes = _segments_of(engine.blocks)
        self._vocab = engine.spec.vocab_size
        self.page_size = engine.page_size_tokens()
        self.max_pages = engine.pages_per_slot()
        self.num_pages = engine.page_count()
        # logical per-slot extent rounds UP to whole pages
        self.buffer_len = self.max_pages * self.page_size
        # the pool is bf16 at any compute dtype (the bf16 KV tier)
        self.pool = init_page_pool(
            engine.spec, self._seg_sizes, self.num_pages, self.page_size,
            torch.bfloat16, self.device,
        )
        self.state = self._fresh_state()
        #: one sampling stream, re-seeded per step from serve.seed + step
        self.generator = torch.Generator(device=self.device)
        self.paged_decode_fn = (
            make_paged_decode_fn() if engine.serve.attention == "pallas"
            else None
        )
        #: decode steps run (kernel launches = steps x layers under pallas)
        self.steps = 0
        self.warmed = False
        self._step_fn = aot_jit(_step)
        self._prefill_fns = {}  # (Bp, P, suffix) -> its own aot_jit

    def _fresh_state(self):
        return init_slot_state(self.num_slots, self.buffer_len, self._vocab,
                               self.max_pages, self.device)

    def prefill_span(self, bucket, suffix: bool = False) -> str:
        Bp, P = bucket
        return f"serve/prefill{'_sfx' if suffix else ''}_b{Bp}p{P}"

    @torch.no_grad()
    def prefill(self, bucket, tokens: np.ndarray, mask: np.ndarray,
                slot_ids, max_new, page_tables, start,
                suffix: bool = False) -> None:
        """Admit one prompt bucket into the pool: filler rows carry the
        out-of-range slot id and are dropped; ``page_tables`` maps each
        row's logical pages (sentinel-padded), ``start`` is its committed
        prefix length, ``suffix=True`` attends to the committed prefix.
        The host arrays become device tensors before the bucket's
        graph."""
        e = self.engine
        key = (*bucket, bool(suffix))
        fn = self._prefill_fns.get(key)
        if fn is None:
            fn = self._prefill_fns[key] = aot_jit(_prefill)
        with telemetry.span(self.prefill_span(bucket, suffix)):
            inputs = tuple(
                torch.as_tensor(np.ascontiguousarray(x, np.int32),
                                device=self.device)
                for x in (tokens, mask, slot_ids, max_new, page_tables,
                          start))
            fn(e.spec, e.blocks, e.embed, e.ln_f, self.pool, self.state,
               inputs, e.compute_dtype, self.page_size, bool(suffix))

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

    def graphs(self):
        """Every captured graph of this runtime (capture seconds, pool
        bytes)."""
        fns = [self._step_fn, *self._prefill_fns.values()]
        return [g for fn in fns for g in fn.graphs()]

    def reset_lanes(self) -> None:
        """All-free lanes, refilled in place (the graphs read these
        buffers), reusing the pool (zeroed lanes gate every read of
        it)."""
        for lane, fresh in zip(self.state, self._fresh_state()):
            lane.copy_(fresh)

    def warmup(self) -> Dict[str, float]:
        """Run every admission bucket (both variants) against the live
        pool with all rows aimed at the drop sentinel, then one decode
        step over the all-free pool — which builds the decode kernel
        under ``attention: pallas`` on the card and, there, captures
        every graph. Touches no slot. Returns {span: first-call seconds}
        (on the card: the eager first call plus the capture)."""
        pad = self.engine.pad_token_id
        spans = [self.STEP_SPAN]
        for P, extents in self.engine.prompt_classes():
            for Bp in extents:
                for suffix in (False, True):
                    spans.append(self.prefill_span((Bp, P), suffix))
                    tokens = np.full((Bp, P), pad, np.int32)
                    mask = np.zeros((Bp, P), np.int32)
                    tokens[:, 0] = 0  # right-padded: one real token first
                    mask[:, 0] = 1
                    self.prefill(
                        (Bp, P), tokens, mask,
                        np.full((Bp,), self.num_slots, np.int32),
                        np.ones((Bp,), np.int32),
                        page_tables=np.full((Bp, self.max_pages),
                                            self.num_pages, np.int32),
                        start=np.zeros((Bp,), np.int32), suffix=suffix,
                    )
        self.step(0)
        latencies = {}
        tel = telemetry.current()
        if tel is not None:
            for span in spans:
                hist = tel.registry.hists.get(f"time/{span}")
                if hist is not None and hist.first is not None:
                    latencies[span] = hist.first
        self.warmed = True
        return latencies


class _LiveSlot:
    """Host bookkeeping for one occupied slot: its request, emitted
    tokens, page-table content (one allocator reference per entry) and
    the pages its admission committed to the radix tree."""

    __slots__ = ("request", "tokens", "pages", "committed")

    def __init__(self, request: Request, pages, committed):
        self.request = request
        self.tokens: List[int] = []
        self.pages: List[int] = pages
        self.committed: List[int] = committed


class SlotScheduler:
    """The continuous-batching decode driver: one worker thread running
    the admit -> step -> harvest loop over the slot pool."""

    def __init__(self, engine, max_queue: Optional[int] = None,
                 slots: Optional[int] = None):
        self.engine = engine
        cfg = engine.serve
        self.max_queue = cfg.max_queue if max_queue is None else max_queue
        self.runtime = SlotPoolRuntime(engine, num_slots=slots)
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

    # -- lifecycle ------------------------------------------------------ #

    def warmup(self) -> Dict[str, float]:
        return self.runtime.warmup()

    @property
    def warmed(self) -> bool:
        return self.runtime.warmed

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
        need = self.engine.request_page_need(len(tokens), max_new_tokens)
        if need > self.runtime.num_pages:
            raise ValueError(
                f"request needs {need} KV pages worst-case but the pool "
                f"holds {self.runtime.num_pages}; raise serve.pages (or "
                f"serve.page_size)"
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
            try:
                admitted_all = self._prefill_batch(batch, P, extents)
            except Exception as e:  # an admission that raises fails its batch
                telemetry.inc("serve/request_errors", len(batch))
                for r in batch:
                    r.error = e
                    r.done.set()
                continue
            if not admitted_all:
                # page pool exhausted: the rest stay QUEUED until
                # harvests return pages — keep stepping the live slots
                self._starved = True
                return

    def _prefill_batch(self, batch: List[Request], P: int, extents) -> bool:
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
        return {
            "kv_layout": rt.kv_layout,
            "kv_dtype": "bf16",
            "slots": rt.num_slots,
            "page_size": rt.page_size,
            "pages_total": rt.num_pages,
            "pages_free": self.cache.free_pages(),
            "pages_cached": self.cache.cached_pages(),
            "evicted_pages": self.cache.evicted_pages,
            "prefix_hit_rate": round(self._hit_rate(), 4),
            "prefix_tokens_saved": self._prefix_tokens_saved,
            "decode_steps": rt.steps,
        }

    def _step(self) -> None:
        seed = self.engine.serve.seed + self._step_counter
        self._step_counter += 1
        tok, emitted, finished = self.runtime.step(seed)
        if self._starved:
            telemetry.inc("serve/preempted_steps")
        done_at = monotonic()
        emitted_total = 0
        for slot in list(self._live):
            live = self._live[slot]
            if emitted[slot]:
                live.tokens.append(int(tok[slot]))
                emitted_total += 1
            if finished[slot]:
                req = live.request
                req.result = live.tokens
                req.latency_s = done_at - req.enqueued_at
                telemetry.observe("serve/request_latency", req.latency_s,
                                  labels={"path": "slots"})
                req.done.set()
                del self._live[slot]
                self._free.append(slot)
                # committed (trie-owned) pages stay cached at refcount 0;
                # the rest return to the free list
                self.cache.release_all(live.pages)
                telemetry.inc("serve/evictions")
                telemetry.inc("serve/responses")
        if emitted_total:
            telemetry.inc("serve/generated_tokens", emitted_total)
        telemetry.set_gauge("serve/slot_occupancy", self._occupancy())
        telemetry.set_gauge("serve/pages_free", self.cache.free_pages())

    def _fail_live(self, error: BaseException) -> None:
        """Containment for a step that raised: fail every in-flight
        request, free all slots, reset lanes + prefix cache (the pool's
        content can no longer be trusted), keep the loop serving."""
        live = list(self._live.values())
        self._live.clear()
        self._free = list(range(self.runtime.num_slots))
        telemetry.inc("serve/request_errors", len(live))
        self.runtime.reset_lanes()
        self.cache = RadixCache(self.runtime.num_pages,
                                self.runtime.page_size)
        for s in live:
            s.request.error = error
            s.request.done.set()
        telemetry.set_gauge("serve/slot_occupancy", 0.0)

    def _run(self) -> None:
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
