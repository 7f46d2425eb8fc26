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
  pass are plain torch. On the serve mesh (``serve.mesh``) the pool holds
  this process's KV heads, the calls run on its shards with the tp sums
  and fsdp gathers captured in the graphs, and process 0 mirrors every
  call to the other processes (trlx_tpu_torch.serve.follower).
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

Crash-only recovery: the unit of failure is the STEP. A step (or an
admission) that raises dumps the flight recorder, resets the lanes and
the prefix cache, and RE-QUEUES every in-flight request with its
committed tokens journaled on the host; re-admission prefills ``prompt
+ committed`` and resumes decode from the last committed token (greedy
decode depends on the token prefix alone). ``serve.max_replays`` bounds
it per request (then ``ReplayExhausted``, 503); a fault at the
``serve_replay`` seam is a double fault and fails the batch. A sticky
CUDA error cannot be replayed: the process exits 70, as the watchdog's
abort does (:meth:`SlotScheduler._recover_step`).
:meth:`SlotScheduler.drain` is the graceful half (admission answers
``Draining``, in-flight work finishes within ``serve.drain_timeout``);
:meth:`SlotScheduler.request_swap` hot-swaps weights at a step boundary
IN PLACE (the graphs captured the engine's tensors), probes one prefill
bucket through its existing graph, and swaps back on failure (seam
``serve_reload``), with zero recompiles.

Overload: ``serve.tenants`` quotas at :meth:`SlotScheduler.submit`
(``QuotaExceeded``, 429 with the tenant's ``Retry-After``), priority
admission with aging, deadline shedding at every admission scan
(``DeadlineExceeded``), a halved queue bound while degraded, and a
hysteretic brownout that clamps best-effort tenants' ``max_new_tokens``.
Tracing: every request's
:class:`~trlx_tpu_torch.serve.trace.RequestTrace` is stamped at
admission, at each harvested token and at completion, from host clocks
the step already has; the flight recorder keeps one record per step. The
loop's host time is spanned: each turn that admits or steps is one
``serve/iteration``, holding ``serve/admit`` (an admission scan that
took a batch off the queue; its arguments: ``requests`` admitted,
``positions`` prefilled, Bp x P over its batches with the filler rows,
``needed``, the uncached suffix tokens of the real rows, and ``hit``,
the prefix tokens the radix cache served), the ``serve/prefill*`` device
phases, the device phase ``serve/slot_step`` (its device part ends at
the replay, the span after the step's results reach the host) and
``serve/harvest`` (the bookkeeping on those results). The counters
``serve/prefill_positions`` and ``serve/prefill_tokens_needed`` carry
the admission's padding on ``/metrics``. The stall dump, ``debug_state``
and ``pressure`` read host state only and never a CUDA tensor, so they
are safe off the worker thread (a device-wide synchronise from another
thread would invalidate a graph capture in progress).
"""

import contextlib
import os
import sys
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
from trlx_tpu_torch.serve.batcher import (
    DEFAULT_TENANT,
    Draining,
    DrainTimeout,
    QueueFull,
    ReplayExhausted,
    Request,
    TenantTable,
    _validate_deadline,
    shed_expired,
)
from trlx_tpu_torch.serve.paged import RadixCache
from trlx_tpu_torch.serve.trace import FlightRecorder, RequestTrace
from trlx_tpu_torch.supervisor import chaos, monotonic
from trlx_tpu_torch.telemetry.flops import kv_bytes_per_token
from trlx_tpu_torch.utils.aotjit import aot_jit


def _prefill(spec, blocks, embed, ln_f, pool, state, inputs, compute_dtype,
             page_size, suffix, tp) -> None:
    """One admission bucket, in place on pool and lanes (a graph per
    bucket and variant on the card); ``page_tables`` and ``start`` are
    None under the contiguous layout."""
    tokens, mask, slot_ids, max_new, page_tables, start = inputs
    prefill_into_slots(
        spec, blocks, embed, ln_f, pool, state, tokens, mask, slot_ids,
        max_new, compute_dtype=compute_dtype, page_tables=page_tables,
        page_size=page_size, start=start, prefix_context=suffix, tp=tp,
    )


def _step(spec, blocks, embed, ln_f, pool, state, generator, config,
          compute_dtype, paged_decode_fn, tp) -> torch.Tensor:
    """One decode step for every slot; tokens, emitted and finished
    packed into one int32 [3, S] tensor, so the host reads them in one
    copy."""
    _, _, tok, emitted, finished = decode_step(
        spec, blocks, embed, ln_f, pool, state, generator, config,
        compute_dtype=compute_dtype, paged_decode_fn=paged_decode_fn, tp=tp,
    )
    return torch.stack([tok, emitted.int(), finished.int()])


def _verify(spec, blocks, embed, ln_f, pool, state, generator, proposals,
            n_proposed, config, compute_dtype, tp) -> torch.Tensor:
    """One speculative verify pass for every slot; candidates [S, K+1],
    counts and finished packed into one int32 [S, K+3] tensor."""
    _, _, cand, counts, finished = verify_step(
        spec, blocks, embed, ln_f, pool, state, generator, proposals,
        n_proposed, config, compute_dtype=compute_dtype, tp=tp,
    )
    return torch.cat([cand, counts[:, None], finished.int()[:, None]], 1)


class SlotPoolRuntime:
    """Device half of the slot scheduler: the pool, per-slot lanes, and
    the prefill / step / verify calls.

    On a serve mesh of several processes, process 0's runtime publishes
    each call (:meth:`prefill`, :meth:`step`, :meth:`verify`,
    :meth:`reset_lanes`, :meth:`install`, :meth:`end_swap`) on the
    engine's host channel before it runs it, and the followers' runtimes
    run the same calls (trlx_tpu_torch.serve.follower ``follow``);
    :meth:`close` ends them."""

    STEP_SPAN = "serve/slot_step"
    VERIFY_SPAN = "serve/spec_verify"

    def __init__(self, engine, num_slots: Optional[int] = None):
        import hashlib

        from trlx_tpu_torch.ops.paged_attention import make_paged_decode_fn

        engine.check_graph_transport()
        self.engine = engine
        self.device = engine.device
        self.tp = engine.tp
        self.num_slots = engine.slot_count() if num_slots is None \
            else int(num_slots)
        self.kv_layout = engine.serve.kv_layout
        self._segments, self._seg_sizes = _segments_of(engine.blocks)
        self._vocab = engine.spec.vocab_size
        kv_heads = engine.spec.kv_heads if self.tp is None \
            else self.tp.kv_heads(engine.spec)
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
                self.page_size, cache_dtype, self.device, kv_heads,
            )
        else:
            self.page_size = self.max_pages = self.num_pages = 0
            self.buffer_len = engine.slot_buffer_len()
            self.pool = init_slot_pool(
                engine.spec, self._seg_sizes, self.num_slots,
                self.buffer_len, torch.bfloat16, self.device, kv_heads,
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
        #: sha-256 of every step's and verify pass's host results on this
        #: process: equal on every process of a mesh that kept in step
        self.digest = hashlib.sha256()

    def _mirror(self, op: str, *args) -> None:
        """Process 0 of a serve mesh publishes the call to the followers
        before running it (a no-op elsewhere)."""
        self.engine._mirror(op, *args)

    def close(self) -> None:
        """End the followers' loops (process 0 of a serve mesh; once:
        :meth:`InferenceEngine.close`). The runtime makes no device call
        afterwards."""
        self.engine.close()

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
        self._mirror("prefill", tuple(bucket), tokens, mask, slot_ids,
                     max_new, page_tables, start, bool(suffix))
        e = self.engine
        paged = self.kv_layout == "paged"
        key = (*bucket, bool(suffix)) if paged else tuple(bucket)
        fn = self._prefill_fns.get(key)
        if fn is None:
            fn = self._prefill_fns[key] = aot_jit(_prefill)
        arrays = (tokens, mask, slot_ids, max_new) + (
            (page_tables, start) if paged else (None, None))
        with telemetry.device_phase(self.prefill_span(bucket, suffix)):
            inputs = tuple(
                None if x is None else torch.as_tensor(
                    np.ascontiguousarray(x, np.int32), device=self.device)
                for x in arrays)
            fn(e.spec, e.blocks, e.embed, e.ln_f, self.pool, self.state,
               inputs, e.compute_dtype, self.page_size or None,
               bool(suffix), self.tp)

    @torch.no_grad()
    def step(self, seed: int):
        """One decode step for every slot; returns host numpy (tokens [S],
        emitted [S], finished [S]), read in one device-to-host copy. The
        step's stream is re-seeded with ``seed`` first, which the graph's
        replay reads. The span closes after the results reach the host,
        so it times the device work too; as a device phase its device part
        ends before the read."""
        self._mirror("step", int(seed))
        e = self.engine
        self.generator.manual_seed(int(seed))
        with telemetry.device_phase(self.STEP_SPAN) as phase:
            out = self._step_fn(
                e.spec, e.blocks, e.embed, e.ln_f, self.pool, self.state,
                self.generator, e.gen_config, e.compute_dtype,
                self.paged_decode_fn, self.tp,
            )
            self.steps += 1
            phase.end_device()
            out = out.cpu().numpy()
            self.digest.update(out.tobytes())
            tok, emitted, finished = out
            return tok, emitted.astype(bool), finished.astype(bool)

    @torch.no_grad()
    def verify(self, seed: int, proposals: np.ndarray,
               n_proposed: np.ndarray):
        """One speculative verify pass for every slot: the K proposals
        and the free token scored together. Returns host numpy (cand
        [S, K+1], counts [S], finished [S]); slot s emits
        ``cand[s, :counts[s]]``."""
        self._mirror("verify", int(seed), proposals, n_proposed)
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
                e.gen_config, e.compute_dtype, self.tp,
            )
            self.verify_steps += 1
            out = out.cpu().numpy()
            self.digest.update(out.tobytes())
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
        self._mirror("reset_lanes")
        for lane, fresh in zip(self.state, self._fresh_state()):
            if lane is not None:
                lane.copy_(fresh)

    def install(self, checkpoint: str, views=None) -> None:
        """A hot-swap's install: :meth:`InferenceEngine.install`, whose
        publish the followers' runtimes receive as their own call."""
        self.engine.install(checkpoint, views)

    def end_swap(self, rollback: bool) -> None:
        """End a hot-swap: :meth:`InferenceEngine.end_swap`."""
        self.engine.end_swap(rollback)

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
    tokens (its committed journal included after a replay) and, under
    the paged layout, its page-table content (one allocator reference
    per entry) and the pages its admission committed to the radix
    tree."""

    __slots__ = ("request", "tokens", "pages", "committed")

    def __init__(self, request: Request, pages=None, committed=None):
        self.request = request
        self.tokens: List[int] = []
        self.pages: List[int] = pages or []
        self.committed: List[int] = committed or []


class SlotScheduler:
    """The continuous-batching decode driver: one worker thread running
    the admit -> step -> harvest loop over the slot pool. Same
    ``submit`` / ``start`` / ``stop`` / ``queue_depth`` / ``drain`` /
    ``request_swap`` surface as the static
    :class:`~trlx_tpu_torch.serve.batcher.MicroBatcher`.

    ``run_supervisor`` (a RunSupervisor) is entered by the worker thread;
    ``draft`` injects the draft tier's proposer (otherwise built from
    ``serve.spec_draft_checkpoint`` under ``speculation: draft``)."""

    #: the loop's host spans (module docstring)
    ITERATION_SPAN = "serve/iteration"
    ADMIT_SPAN = "serve/admit"
    HARVEST_SPAN = "serve/harvest"

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
        #: the current admission scan's [requests, positions, needed,
        #: hit] (the ``serve/admit`` span's arguments)
        self._tally = [0, 0, 0, 0]
        self._queue = deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._final = False  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None
        self._free = list(range(self.runtime.num_slots))
        self._live: Dict[int, _LiveSlot] = {}
        self._step_counter = 0
        self._starved = False
        self._tracing = bool(cfg.request_tracing)
        self._slo_s = float(cfg.slo_ttft_ms) / 1000.0
        #: the per-step black box (serve.flight_recorder_steps; 0 = off),
        #: dumped on a stall, a poisoned step or a drain
        self.flight: Optional[FlightRecorder] = (
            FlightRecorder(cfg.flight_recorder_steps)
            if cfg.flight_recorder_steps > 0 else None
        )
        #: admissions / evictions since the flight recorder's last record
        self._fr_admitted = 0
        self._fr_evicted = 0
        # -- speculation: propose -> verify -> accept each step -------- #
        self._spec_mode = cfg.speculation
        self.spec_k = self.runtime.spec_k
        #: the lookup tier's per-slot state, dropped at harvest and replay
        self._speculators: Dict[int, object] = {}
        self._draft = draft
        if self._spec_mode == "draft" and draft is None \
                and cfg.spec_draft_checkpoint:
            from trlx_tpu_torch.serve.speculate import DraftProposer

            self._draft = DraftProposer.from_checkpoint(
                cfg.spec_draft_checkpoint, engine, self.spec_k)
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._fr_spec_proposed = 0
        self._fr_spec_accepted = 0
        #: slots that emitted in verify passes, and the tokens they emitted
        self._spec_slot_passes = 0
        self._spec_tokens = 0
        # -- crash-only lifecycle ------------------------------------- #
        self._draining = False  # guarded-by: _cond
        self._drain_deadline = 0.0
        self._drain_shed = 0  # requests the drain deadline ended
        self._drained = threading.Event()
        #: the worker-applied hot-swap: {"params", "label", "done",
        #: "result"}
        self._pending_swap: Optional[Dict] = None  # guarded-by: _cond
        self._last_step_ms = 0.0
        self._replayed_requests = 0
        # -- overload containment ------------------------------------- #
        #: per-tenant quotas; no serve.tenants = every check a no-op
        #: (guarded-by: _cond, like the queue it meters)
        self.tenants = TenantTable(cfg.tenants, self.max_queue)
        self._aging_rounds = int(cfg.priority_aging_rounds)
        #: brownout state machine (worker-written, HTTP-read: a stale
        #: read mis-times one clamp at most)
        self._brownout = False
        self._pressure_since = 0.0
        self._calm_since = 0.0
        self._brownout_max_new = int(cfg.brownout_max_new)
        self._brownout_after_s = float(cfg.brownout_after_s)
        self._brownout_recover_s = float(cfg.brownout_recover_s)

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

    def stop(self, final: bool = False) -> None:
        """Stop the worker and fail what is still queued or in flight; on
        a serve mesh, then end the followers' loops. Requests submitted
        after it wait for the next start(); with ``final`` (a server's
        shutdown, which no start() follows) they raise instead, so that a
        handler still running past the shutdown does not wait out its
        whole timeout."""
        if final:
            with self._cond:
                self._final = True
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.runtime.close()
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

    def submit(self, tokens: List[int], max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None,
               trace: Optional[RequestTrace] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[int] = None,
               tenant: Optional[str] = None) -> Request:
        """Enqueue one request. ValueError when no bucket (or the page
        pool) can ever hold it, QueueFull past the admission bound (half
        ``max_queue`` while degraded), :class:`QuotaExceeded` when the
        tenant's ``serve.tenants`` quota is spent, :class:`Draining`
        during a drain. ``seed`` is accepted for surface parity; the
        sampling stream is per step. ``deadline_ms`` bounds queueing (a
        request still queued past it is shed at the next admission scan);
        higher ``priority`` admits first (None: the tenant's default;
        queued requests age upward every ``serve.priority_aging_rounds``
        scans). Under brownout a best-effort tenant's ``max_new_tokens``
        is clamped to ``serve.brownout_max_new`` (``degraded``)."""
        if not tokens:
            raise ValueError("empty prompt: at least one token is required")
        if max_new_tokens is None:
            max_new_tokens = self.engine.default_max_new_tokens()
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        deadline_s = _validate_deadline(deadline_ms)
        tenant = DEFAULT_TENANT if not tenant else str(tenant)
        if priority is None:
            priority = self.tenants.priority_for(tenant)
        # brownout clamp BEFORE bucket rounding, so the clamped request
        # also reserves the smaller shape class (and fewer KV pages)
        browned_out = (
            self._brownout and self._brownout_max_new > 0
            and self.tenants.best_effort(tenant)
            and max_new_tokens > self._brownout_max_new
        )
        if browned_out:
            max_new_tokens = self._brownout_max_new
            telemetry.inc("serve/brownout_clamped")
            telemetry.inc("serve/brownout_clamped",
                          labels={"tenant": tenant})
        shape = self.engine.pick_shape(len(tokens), max_new_tokens)
        if self.cache is not None:
            need = self.engine.request_page_need(len(tokens), max_new_tokens)
            if need > self.runtime.num_pages:
                raise ValueError(
                    f"request needs {need} KV pages worst-case but the "
                    f"pool holds {self.runtime.num_pages}; raise "
                    f"serve.pages (or serve.page_size)"
                )
        if trace is None and self._tracing:
            trace = RequestTrace()
        req = Request(list(tokens), max_new_tokens, shape, seed=seed,
                      trace=trace, deadline_s=deadline_s,
                      priority=priority, tenant=tenant)
        req.degraded = browned_out
        if self.tenants.enabled:
            chaos.maybe_inject("serve_quota")
        with self._cond:
            if self._final:
                raise RuntimeError("serve slot scheduler stopped")
            if self._draining:
                telemetry.inc("serve/rejected")
                raise Draining(
                    "server is draining: admission is closed while "
                    "in-flight requests finish (serve.drain_timeout); "
                    "retry against another replica"
                )
            denied = self.tenants.try_admit(
                tenant,
                queued=sum(1 for r in self._queue if r.tenant == tenant),
                inflight=sum(1 for s in list(self._live.values())
                             if s.request.tenant == tenant),
                now=monotonic(),
            )
            if denied is not None:
                telemetry.inc("serve/rejected")
                telemetry.inc("serve/shed_quota")
                telemetry.inc("serve/shed_quota",
                              labels={"tenant": tenant})
                raise denied
            cap = self.max_queue
            if self._degraded():
                cap = max(1, self.max_queue // 2)
            telemetry.set_gauge("serve/admission_limit", cap)
            if len(self._queue) >= cap:
                telemetry.inc("serve/rejected")
                detail = " (halved: engine degraded)" \
                    if cap < self.max_queue else ""
                raise QueueFull(
                    f"serve queue is full ({cap} pending{detail}); "
                    f"retry with backoff (serve.max_queue bounds queueing "
                    f"delay — raise it to trade latency for acceptance)"
                )
            self._queue.append(req)
            telemetry.inc("serve/requests")
            telemetry.set_gauge("serve/queue_depth", len(self._queue))
            self._cond.notify_all()
        return req

    # -- overload ------------------------------------------------------- #

    def _degraded(self) -> bool:
        """The adaptive-admission signal: requests starved for slots or
        pages, the page pool pinned empty, or the last step over
        ``serve.degrade_step_ms``."""
        if self._starved:
            return True
        if self.cache is not None and self.cache.free_pages() == 0:
            return True
        limit_ms = float(self.engine.serve.degrade_step_ms)
        return bool(limit_ms > 0 and self._last_step_ms > limit_ms)

    def _update_brownout(self, now: float) -> None:
        """The hysteretic brownout state machine, advanced once per
        worker iteration: :meth:`_degraded` must hold continuously for
        ``serve.brownout_after_s`` to engage it and be absent for
        ``serve.brownout_recover_s`` to release it (gauge
        ``serve/brownout``, counter ``serve/brownout_entries``)."""
        if self._brownout_max_new <= 0:
            return
        if self._degraded():
            self._calm_since = 0.0
            if self._pressure_since == 0.0:
                self._pressure_since = now
            elif (not self._brownout
                  and now - self._pressure_since >= self._brownout_after_s):
                self._brownout = True
                telemetry.inc("serve/brownout_entries")
                telemetry.set_gauge("serve/brownout", 1)
        else:
            self._pressure_since = 0.0
            if not self._brownout:
                self._calm_since = 0.0
            elif self._calm_since == 0.0:
                self._calm_since = now
            elif now - self._calm_since >= self._brownout_recover_s:
                self._brownout = False
                telemetry.set_gauge("serve/brownout", 0)

    def pressure(self) -> Dict:
        """The published backpressure block (``/readyz``,
        ``/debug/state``): host counters only, read without a lock (a
        slightly stale view mis-times one shed at most)."""
        out = {
            "degraded": self._degraded(),
            "brownout": self._brownout,
            "starved": self._starved,
            "queue_depth": len(self._queue),
            "free_slots": len(self._free),
            "retry_after_s": self.retry_after_s(),
        }
        if self.cache is not None:
            out["pages_free"] = self.cache.free_pages()
        if self.spec_k > 0:
            out["spec_acceptance_rate"] = round(
                self._spec_acceptance_rate(), 4)
        return out

    def step_p50_s(self) -> float:
        """Recent decode-step p50 (``time/serve/slot_step``), the pacing
        term of ``Retry-After``; 50 ms before any step landed."""
        tel = telemetry.current()
        if tel is not None:
            hist = tel.registry.hists.get(f"time/{self.runtime.STEP_SPAN}")
            if hist is not None and hist.count:
                return max(hist.quantile(0.5), 1e-4)
        return 0.05

    def retry_after_s(self) -> int:
        """The 429 ``Retry-After`` hint: queue depth x recent step p50,
        never below 1 s."""
        estimate = len(self._queue) * self.step_p50_s()
        return max(1, int(-(-estimate // 1)))

    # -- worker --------------------------------------------------------- #

    def _occupancy(self) -> float:
        return len(self._live) / max(self.runtime.num_slots, 1)

    def _admit(self) -> bool:
        """Move queued requests into free slots, one prompt-class bucket
        at a time (the highest-priority request's class first, ties FIFO
        by ``seq``). Requests past their ``deadline_ms`` are shed here
        first (:class:`DeadlineExceeded`). Priority ages: the effective
        priority is ``priority + age // serve.priority_aging_rounds``,
        ``age`` counting the scans a request waited. A poisoned
        admission re-queues its batch for replay. Returns whether the
        scan took a batch off the queue; such a scan is one
        ``serve/admit`` span with the admission's tally, any other
        records none."""
        with telemetry.span(self.ADMIT_SPAN) as span:
            self._tally = [0, 0, 0, 0]
            took = self._admit_batches()
            requests, positions, needed, hit = self._tally
            span.set(requests=requests, positions=positions, needed=needed,
                     hit=hit)
            if not took:
                span.drop()
        return took

    def _admit_batches(self) -> bool:
        """:meth:`_admit`'s scan; returns whether it took a batch."""
        aging = self._aging_rounds
        took = False

        def by_prio(r):
            boost = r.age // aging if aging > 0 else 0
            return (-(r.priority + boost), r.seq)

        first_scan = True
        while True:
            with self._cond:
                if first_scan:
                    first_scan = False
                    for r in self._queue:
                        r.age += 1
                if self._queue:
                    survivors = shed_expired(list(self._queue), monotonic())
                    if len(survivors) != len(self._queue):
                        self._queue = deque(survivors)
                        telemetry.set_gauge("serve/queue_depth",
                                            len(self._queue))
                self._starved = bool(self._queue) and not self._free
                if not self._queue or not self._free:
                    return took
                P = min(self._queue, key=by_prio).shape[0]
                extents = self.engine.prefill_batch_sizes(P)
                same = sorted((r for r in self._queue if r.shape[0] == P),
                              key=by_prio)
                batch = same[:min(len(same), len(self._free), extents[-1])]
                for r in batch:
                    self._queue.remove(r)
                took = True
                telemetry.set_gauge("serve/queue_depth", len(self._queue))
            admitted_all = True
            with supervisor.phase("serve_admit"):
                try:
                    chaos.maybe_inject("serve_admit")
                    admitted_all = self._prefill_batch(batch, P, extents)
                except Exception as e:
                    # a poisoned admission RE-QUEUES its requests for
                    # replay (bounded by serve.max_replays); page-starved
                    # ones were already re-queued and left the batch
                    if self.flight is not None:
                        self.flight.dump(f"admission failure: {e!r}")
                    self._requeue_for_replay(batch, e)
                supervisor.beat()
            if not admitted_all:
                # page pool exhausted: the rest stay QUEUED until
                # harvests return pages — keep stepping the live slots
                self._starved = True
                return took

    def _spawn_speculator(self, slot: int, history: List[int]) -> None:
        """The lookup tier's per-slot state: an n-gram index over the
        request's own prompt and committed journal (bounded by
        ``serve.spec_index_max_keys``, dropped at harvest and replay)."""
        if self.spec_k <= 0 or self._spec_mode != "lookup":
            return
        from trlx_tpu_torch.serve.speculate import SlotSpeculator

        cfg = self.engine.serve
        self._speculators[slot] = SlotSpeculator(
            history, self.spec_k, ngram_max=int(cfg.spec_ngram_max),
            max_keys=int(cfg.spec_index_max_keys))

    def _stamp_admission(self, r: Request, Bp: int, P: int, at: float,
                         version: int) -> None:
        r.model_version = version
        if r.trace is not None:
            r.trace.admitted = at
            r.trace.bucket = (Bp, P)
            r.trace.prefill_start = at
            r.trace.model_version = version

    def _prefill_batch(self, batch: List[Request], P: int, extents) -> bool:
        """Prefill one admission batch; returns False when the paged
        allocator ran dry and part of the batch went back to the queue.
        A replayed request prefills its prompt plus its committed tokens
        and decodes only the budget it still has: greedy decode depends
        on the token prefix alone, so it resumes where it stopped."""
        if self.cache is not None:
            return self._prefill_batch_paged(batch, P, extents)
        Bp = next(b for b in extents if b >= len(batch))
        slots = [self._free.pop() for _ in batch]
        slot_ids = slots + [self.runtime.num_slots] * (Bp - len(batch))
        tokens, mask = self.engine.pad_batch(
            [r.tokens + r.committed for r in batch], (Bp, P, 0))
        max_new = [r.remaining_new_tokens() for r in batch]
        max_new += [1] * (Bp - len(batch))
        admit_at, version = monotonic(), self.engine.model_version
        for r in batch:
            self._stamp_admission(r, Bp, P, admit_at, version)
        try:
            self.runtime.prefill((Bp, P), tokens, mask, slot_ids, max_new)
        except Exception:
            self._free.extend(slots)  # nothing was admitted
            raise
        prefill_end = monotonic()
        self._note_prefill(len(batch), Bp * P, sum(
            min(len(r.tokens) + len(r.committed), P) for r in batch), 0)
        for r, s in zip(batch, slots):
            if r.trace is not None:
                r.trace.prefill_end = prefill_end
            live = _LiveSlot(r)
            live.tokens = list(r.committed)
            self._live[s] = live
            self._spawn_speculator(s, r.tokens + r.committed)
        self._fr_admitted += len(batch)
        telemetry.inc("serve/admissions", len(batch))
        for r in batch:
            telemetry.inc("serve/admissions", labels={"tenant": r.tenant})
        telemetry.set_gauge("serve/slot_occupancy", self._occupancy())
        return True

    def _prefill_batch_paged(self, batch: List[Request], P: int,
                             extents) -> bool:
        """Paged admission: radix-match each prompt (a replayed one with
        its committed tokens), reserve pages for the unmatched suffix +
        the remaining decode budget, map hit pages copy-free, and
        prefill ONLY the suffix. Requests the allocator cannot cover
        (even after LRU eviction) go back to the queue head in order.
        Returns False when that happened."""
        ps = self.runtime.page_size
        chaos.maybe_inject("serve_prefix_match")
        plans = []  # (request, toks, matched, pages, committed)
        deferred: List[Request] = []
        for i, r in enumerate(batch):
            toks = (r.tokens + r.committed)[-P:]
            matched = self.cache.match(toks)
            need = self.engine.request_page_need(
                len(toks), r.remaining_new_tokens()
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
                    if r.trace is not None:  # page starvation: re-queued
                        r.trace.queue_reentries += 1
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
        admit_at, version = monotonic(), self.engine.model_version
        for j, ((r, toks, matched, pages, _), s) in enumerate(
            zip(plans, slots)
        ):
            start = len(matched) * ps
            suf = toks[start:]
            tokens[j, :len(suf)] = suf  # right-padded suffix
            mask[j, :len(suf)] = 1
            page_tables[j, :len(pages)] = pages
            starts[j] = start
            max_new[j] = r.remaining_new_tokens()
            slot_ids[j] = s
            self._stamp_admission(r, Bp, P, admit_at, version)
            if r.trace is not None:
                r.trace.pages_reserved = len(pages)
                r.trace.prefix_blocks_hit = len(matched)
                r.trace.suffix_len = len(suf)
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
        prefill_end = monotonic()
        hit = sum(len(p[2]) for p in plans) * ps
        self._note_prefill(len(plans), Bp * P,
                           sum(len(p[1]) for p in plans) - hit, hit)
        saved = 0
        for (r, toks, matched, pages, committed), s in zip(plans, slots):
            if r.trace is not None:
                r.trace.prefill_end = prefill_end
            live = _LiveSlot(r, pages, committed)
            live.tokens = list(r.committed)
            self._live[s] = live
            self._spawn_speculator(s, r.tokens + r.committed)
            saved += len(matched) * ps
            self._prompt_tokens_total += len(toks)
            telemetry.observe("serve/pages_per_request", len(pages))
        self._fr_admitted += len(plans)
        self._prefix_tokens_saved += saved
        if saved:
            telemetry.inc("serve/prefix_tokens_saved", saved)
        telemetry.inc("serve/admissions", len(plans))
        for p in plans:
            telemetry.inc("serve/admissions", labels={"tenant": p[0].tenant})
        telemetry.set_gauge("serve/slot_occupancy", self._occupancy())
        telemetry.set_gauge("serve/pages_free", self.cache.free_pages())
        telemetry.set_gauge("serve/prefix_hit_rate", self._hit_rate())
        return not deferred

    def _note_prefill(self, requests: int, positions: int, needed: int,
                      hit: int) -> None:
        """One admitted batch's prefill: ``positions`` it ran (Bp x P,
        filler rows included), ``needed`` of them the real rows' uncached
        tokens, ``hit`` tokens served from the radix cache."""
        for i, n in enumerate((requests, positions, needed, hit)):
            self._tally[i] += n
        telemetry.inc("serve/prefill_positions", positions)
        telemetry.inc("serve/prefill_tokens_needed", needed)

    def _hit_rate(self) -> float:
        return self._prefix_tokens_saved / max(self._prompt_tokens_total, 1)

    def pool_stats(self) -> Dict:
        """Host view of the KV pool — the /healthz ``kv`` block. Under a
        tp mesh every process holds a head slice of EVERY page (the page
        tables are the same host data everywhere), so page counts stay
        global while ``pool_gb_per_device`` is this process's bytes;
        ``pool_gb`` is the whole pool's."""
        from trlx_tpu_torch.serve.layouts import tree_bytes_per_device

        rt = self.runtime
        kv_dtype = self.engine.serve.kv_dtype
        local = tree_bytes_per_device(rt.pool)
        tp = rt.tp
        shards = tp.size if tp is not None and tp.attn else 1
        stats = {
            "kv_layout": rt.kv_layout,
            "kv_dtype": kv_dtype,
            "kv_bytes_per_token": kv_bytes_per_token(self.engine.spec,
                                                     kv_dtype),
            "slots": rt.num_slots,
            "pool_gb": round(local * shards / 2**30, 6),
            "pool_gb_per_device": round(local / 2**30, 6),
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
        with telemetry.span(self.HARVEST_SPAN):
            self._harvest(plan, cand, counts, finished, proposed, accepted,
                          span)

    def _harvest(self, plan, cand, counts, finished, proposed: int,
                 accepted: int, span: str) -> None:
        """The bookkeeping on one step's results, on the host: the
        speculation tallies, each slot's tokens (and its trace's), the
        finished requests completed, their slots and pages freed, the
        gauges."""
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
            self._fr_spec_proposed += proposed
            self._fr_spec_accepted += accepted
            self._spec_slot_passes += int((counts > 0).sum())
            self._spec_tokens += int(counts.sum())
            telemetry.set_gauge("serve/spec_acceptance_rate",
                                self._spec_acceptance_rate())
        # the host already holds this step's results: tracing stamps
        # them with this one clock read and touches no device tensor
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
                if live.request.trace is not None:
                    for _ in range(c):
                        live.request.trace.note_token(done_at)
            if finished[slot]:
                req = live.request
                req.result = live.tokens
                req.latency_s = done_at - req.enqueued_at
                if req.trace is not None:
                    req.trace.harvested = done_at
                    req.trace.complete("slots", self._slo_s)
                else:
                    telemetry.observe("serve/request_latency",
                                      req.latency_s,
                                      labels={"path": "slots"})
                req.done.set()
                del self._live[slot]
                self._speculators.pop(slot, None)
                self._free.append(slot)
                if self.cache is not None:
                    # committed (trie-owned) pages stay cached at
                    # refcount 0; the rest return to the free list
                    self.cache.release_all(live.pages)
                self._fr_evicted += 1
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

    # -- crash-only recovery -------------------------------------------- #

    def _reset_cache(self) -> None:
        """A fresh allocator + radix tree. It runs whenever the lanes are
        reset, so every page mapping and every cached prefix whose
        content can no longer be trusted (a poisoned step, or KV
        computed under the weights before a swap) goes with them."""
        if self.cache is not None:
            self.cache = RadixCache(self.runtime.num_pages,
                                    self.runtime.page_size)
            telemetry.set_gauge("serve/pages_free", self.cache.free_pages())

    def _fail_live(self, error: BaseException) -> None:
        """Last-resort containment (a double fault, or replay off): fail
        every in-flight request, free all slots, reset lanes and prefix
        cache, keep the loop serving."""
        live = list(self._live.values())
        self._live.clear()
        self._speculators.clear()
        self._free = list(range(self.runtime.num_slots))
        telemetry.inc("serve/request_errors", len(live))
        # contain first, signal last: a waiter released by done.set()
        # must see the reset pool and cache, not a torn one
        self.runtime.reset_lanes()
        self._reset_cache()
        for s in live:
            s.request.error = error
            s.request.done.set()
        telemetry.set_gauge("serve/slot_occupancy", 0.0)

    def _requeue_for_replay(self, requests: List[Request],
                            error: BaseException) -> None:
        """Journal and re-queue: each request goes back to the queue head
        (original admission order) with its committed tokens, unless its
        ``serve.max_replays`` budget is spent or its prompt plus those
        tokens no longer fits the bucket lattice — those end with
        :class:`ReplayExhausted` (HTTP 503) and a reason."""
        max_replays = int(self.engine.serve.max_replays)
        survivors = []
        for req in requests:
            req.replays += 1
            if req.trace is not None:
                req.trace.replays = req.replays
                req.trace.queue_reentries += 1
            if req.replays > max_replays:
                telemetry.inc("serve/request_errors")
                req.error = ReplayExhausted(
                    f"request hit {max_replays} engine faults "
                    f"(serve.max_replays) and will not be replayed "
                    f"again; last fault: {error!r}"
                )
                req.done.set()
                continue
            try:
                # the committed prefix is part of the replay prompt, so
                # its admission class can grow — or grow past the
                # lattice, which ends the request with a reason
                req.shape = self.engine.pick_shape(
                    len(req.tokens) + len(req.committed),
                    req.remaining_new_tokens(),
                )
            except ValueError as e:
                telemetry.inc("serve/request_errors")
                req.error = ReplayExhausted(
                    f"cannot replay: prompt + {len(req.committed)} "
                    f"committed tokens no longer fit the bucket "
                    f"lattice ({e})"
                )
                req.done.set()
                continue
            survivors.append(req)
        if survivors:
            self._replayed_requests += len(survivors)
            telemetry.inc("serve/replays", len(survivors))
            with self._cond:
                for req in sorted(survivors, key=lambda r: r.seq,
                                  reverse=True):
                    self._queue.appendleft(req)
                telemetry.set_gauge("serve/queue_depth", len(self._queue))
                self._cond.notify_all()

    def _recover_step(self, error: BaseException) -> None:
        """The worker's first response to a step that raised: dump the
        flight recorder (the steps that led INTO the fault), reset lanes
        and cache, and re-queue — not fail — every in-flight request
        with its committed tokens. The ``serve_replay`` chaos seam fires
        before anything changes; a fault there, or in the reset, is a
        double fault and falls back to :meth:`_fail_live`.

        What this covers: an exception raised on the host around a step
        (a chaos injection, a host error, a graph launch that raises). A
        sticky CUDA error (an illegal address, a device-side assert)
        poisons the process's CUDA context, and no in-process reset
        clears it: when one tiny launch after the fault fails too, the
        process takes the watchdog's abort path instead of carrying on
        (:meth:`_abort_poisoned_context`, exit 70, a supervisor restarts
        the replica); a step that hangs is the watchdog's itself
        (``serve.stall_timeout``)."""
        if self.flight is not None:
            self.flight.dump(f"poisoned step: {error!r}")
        if self._device_poisoned():
            self._abort_poisoned_context(error)
            return
        try:
            chaos.maybe_inject("serve_replay")
        except Exception as twice:
            self._fail_live(twice)
            return
        live = list(self._live.values())
        self._live.clear()
        # speculation state derives from the per-slot histories about to
        # be journaled; re-admission rebuilds it
        self._speculators.clear()
        self._free = list(range(self.runtime.num_slots))
        try:
            self.runtime.reset_lanes()
            self._reset_cache()
        except Exception as twice:
            telemetry.inc("serve/request_errors", len(live))
            for s in live:
                s.request.error = twice
                s.request.done.set()
            telemetry.set_gauge("serve/slot_occupancy", 0.0)
            return
        for s in live:
            # journal BEFORE the requeue: live.tokens is everything
            # committed so far (the earlier journal included)
            s.request.committed = list(s.tokens)
        self._requeue_for_replay([s.request for s in live], error)
        telemetry.set_gauge("serve/slot_occupancy", 0.0)

    def _device_poisoned(self) -> bool:
        """Whether the CUDA context is unusable: after a sticky error
        every later CUDA call fails, so one tiny launch and its copy back
        tell (on the worker's own stream; False off the card)."""
        if self.engine.device.type != "cuda":
            return False
        try:
            torch.ones(1, device=self.engine.device).add_(1).cpu()
        except Exception:
            return True
        return False

    def _abort_poisoned_context(self, error: BaseException) -> None:
        """The serve watchdog's abort for a fault no reset can clear:
        flush telemetry and exit 70 (EX_SOFTWARE), through the run
        supervisor's exit function when one is armed, so a supervisor
        restarts a fresh replica."""
        print(f"[trlx_tpu_torch.serve] the CUDA context is poisoned "
              f"({error!r}): no in-process reset clears a sticky device "
              f"error; exiting 70 so a supervisor restarts the replica",
              file=sys.stderr, flush=True)
        tel = telemetry.current()
        if tel is not None:
            try:
                tel.write()
            except Exception as e:  # the exit must still happen
                print(f"[trlx_tpu_torch.serve] telemetry flush failed: "
                      f"{e!r}", file=sys.stderr, flush=True)
        getattr(self.run_supervisor, "exit_fn", os._exit)(70)

    # -- graceful drain ------------------------------------------------- #

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: admission flips to :class:`Draining` (HTTP
        429) while the worker keeps admitting ALREADY-queued requests and
        stepping until everything in flight finishes. What is still
        unfinished at the deadline (default ``serve.drain_timeout``)
        ends with :class:`DrainTimeout` (503). Dumps the flight recorder
        on entry. Returns True when nothing was shed; idempotent; stops
        the worker on the way out."""
        if timeout is None:
            timeout = float(self.engine.serve.drain_timeout)
        with self._cond:
            already = self._draining
            self._draining = True
            self._drain_deadline = monotonic() + float(timeout)
            self._cond.notify_all()
        if not already:
            telemetry.inc("serve/drains")
            if self.flight is not None:
                self.flight.dump("drain")
        if self._thread is None:
            # never started: nothing in flight can finish
            self._drain_expire()
        else:
            self._drained.wait(timeout=float(timeout) + 10.0)
        with self._cond:
            # trlx_tpu reads only the (by then empty) queue and slots,
            # so a deadline shed reported clean there; the shed counts
            clean = not self._queue and not self._live \
                and not self._drain_shed
        self.stop()
        return clean

    def _drain_expire(self) -> None:
        """The drain deadline passed: end everything still in flight with
        :class:`DrainTimeout` (on the worker, or inline when it never
        started)."""
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            telemetry.set_gauge("serve/queue_depth", 0)
        live = list(self._live.values())
        self._live.clear()
        self._speculators.clear()
        self._free = list(range(self.runtime.num_slots))
        victims = pending + [s.request for s in live]
        self._drain_shed += len(victims)
        if victims:
            telemetry.inc("serve/request_errors", len(victims))
        if live:
            self.runtime.reset_lanes()
            self._reset_cache()
        for req in victims:
            req.error = DrainTimeout(
                "server drain deadline (serve.drain_timeout) passed "
                "with the request still in flight; retry against "
                "another replica"
            )
            req.done.set()
        telemetry.set_gauge("serve/slot_occupancy", 0.0)
        self._drained.set()

    # -- live weight hot-swap ------------------------------------------- #

    def request_swap(self, params, label: str = "") -> Dict:
        """Hot-swap the serving weights to ``params`` (a hydra param
        tree; the engine strips it to decode views). Applied by the
        worker at a step boundary: admission pauses (``submit`` still
        accepts), live slots finish on the version that admitted them,
        then the worker resets the KV state, installs the candidate IN
        PLACE into the tensors the graphs captured, smoke-probes one
        prefill bucket through its existing graph, and commits
        (``serve/model_version`` bumps) or swaps the previous weights
        back. Zero recompiles either way. Blocks until applied; returns
        ``{"reloaded", "model_version", ...}``."""
        box = {"params": params, "label": label,
               "done": threading.Event(), "result": None}
        with self._cond:
            if self._pending_swap is not None:
                return {
                    "reloaded": False,
                    "model_version": self.engine.model_version,
                    "reason": "another reload is already in progress",
                }
            self._pending_swap = box
            self._cond.notify_all()
        if self._thread is None:
            self._apply_pending_swap()  # idle engine: swap inline
        else:
            box["done"].wait(
                timeout=float(self.engine.serve.request_timeout) + 30.0)
        if box["result"] is None:
            return {
                "reloaded": False,
                "model_version": self.engine.model_version,
                "reason": "reload timed out waiting for a step boundary",
            }
        return box["result"]

    def _apply_pending_swap(self) -> None:
        """The worker's half of :meth:`request_swap`; runs only with no
        live slot. A failure (shape or dtype drift, non-finite probe
        logits, a ``serve_reload`` chaos fault) swaps the previous
        weights back and the engine keeps serving version N."""
        with self._cond:
            box = self._pending_swap
        if box is None:
            return
        e = self.engine
        old_version = e.model_version
        installed = False
        try:
            chaos.maybe_inject("serve_reload")
            views = e.strip_for_serve(box["params"])
            e.validate_swap(views)
            # KV pages and cached prefixes were computed under the OLD
            # weights; the lanes are already empty (step boundary)
            self.runtime.reset_lanes()
            self._reset_cache()
            # the candidate's tensors now hold the previous weights
            self.runtime.install(box["label"], views)
            installed = True
            del views
            self._probe_swap()
        except Exception as err:
            if installed:
                self.runtime.end_swap(rollback=True)
            self.runtime.reset_lanes()
            self._reset_cache()
            telemetry.inc("serve/reload_failures")
            box["result"] = {
                "reloaded": False, "model_version": old_version,
                "reason": f"{type(err).__name__}: {err}",
            }
        else:
            self.runtime.end_swap(rollback=False)
            version = e.commit_version(box["label"] or None)
            telemetry.inc("serve/reloads")
            box["result"] = {
                "reloaded": True, "model_version": version,
                "previous_version": old_version,
            }
        with self._cond:
            self._pending_swap = None
        box["done"].set()

    def _probe_swap(self) -> None:
        """One-bucket smoke probe through the smallest prefill bucket's
        EXISTING graph (no new capture): prefill a dummy token into real
        slot 0 and require finite logits under the candidate weights.
        Reads ``state.logits[0]`` on the worker thread (a stream-ordered
        copy, no device-wide sync); the lanes are reset afterwards."""
        rt = self.runtime
        P, extents = self.engine.prompt_classes()[0]
        Bp = extents[0]
        tokens = np.full((Bp, P), self.engine.pad_token_id, np.int32)
        mask = np.zeros((Bp, P), np.int32)
        paged = rt.kv_layout == "paged"
        col = 0 if paged else -1  # paged prompts are right-padded
        tokens[:, col] = 0
        mask[:, col] = 1
        slot_ids = np.full((Bp,), rt.num_slots, np.int32)
        slot_ids[0] = 0  # ONE real row: the probe reads its logits
        page_tables = start = None
        if paged:
            page_tables = np.full((Bp, rt.max_pages), rt.num_pages, np.int32)
            need = self.engine.request_page_need(1, 1)
            # the cache was reset just before: pages 0..need-1 are free,
            # and the reset after the probe unmaps them again
            page_tables[0, :need] = np.arange(need, dtype=np.int32)
            start = np.zeros((Bp,), np.int32)
        rt.prefill((Bp, P), tokens, mask, slot_ids, np.ones((Bp,), np.int32),
                   page_tables=page_tables, start=start)
        finite = bool(torch.isfinite(rt.state.logits[0]).all().cpu())
        rt.reset_lanes()
        if not finite:
            raise ValueError(
                "smoke probe produced non-finite logits under the "
                "candidate checkpoint; rolling back"
            )

    # -- the flight recorder and debug state ---------------------------- #

    def _record_step(self, start: float, end: float) -> None:
        """One compact flight-recorder record per engine step (host
        counters only); the admission / eviction deltas reset here."""
        if self.flight is None:
            self._fr_admitted = self._fr_evicted = 0
            self._fr_spec_proposed = self._fr_spec_accepted = 0
            return
        rec = {
            "step": self._step_counter,
            "t": round(end, 4),
            "active": len(self._live),
            "finished": self._fr_evicted,
            "admitted": self._fr_admitted,
            "occupancy": round(self._occupancy(), 4),
            "step_ms": round((end - start) * 1000.0, 3),
        }
        if self.cache is not None:
            rec["pages_free"] = self.cache.free_pages()
        if self.spec_k > 0:
            rec["spec_proposed"] = self._fr_spec_proposed
            rec["spec_accepted"] = self._fr_spec_accepted
        self.flight.record(**rec)
        self._fr_admitted = self._fr_evicted = 0
        self._fr_spec_proposed = self._fr_spec_accepted = 0

    def dump_flight_recorder(self) -> None:
        """The watchdog's stall hook (``RunSupervisor.add_dump_fn``):
        print the ring to stderr beside the stack dump. Runs on the
        watchdog thread and reads host records only."""
        if self.flight is not None:
            self.flight.dump("watchdog stall")

    def debug_state(self) -> Dict:
        """Live engine state for ``GET /debug/state``: queue and slot
        map, the flight-recorder ring, the KV pool. Read from the HTTP
        thread without a lock and without touching a CUDA tensor: every
        container is copied under the GIL, so a view may be stale, never
        torn."""
        slots = {}
        for s, live in list(self._live.items()):
            req = live.request
            slots[str(s)] = {
                "trace_id": req.trace.trace_id
                if req.trace is not None else None,
                "prompt_len": len(req.tokens),
                "max_new_tokens": req.max_new_tokens,
                "tokens_emitted": len(live.tokens),
                "pages": len(live.pages),
                "tenant": req.tenant,
            }
        return {
            "scheduler": "slots",
            "step": self._step_counter,
            "queue_depth": len(self._queue),
            "free_slots": len(self._free),
            "starved": self._starved,
            "degraded": self._degraded(),
            "pressure": self.pressure(),
            "tenants": (self.tenants.snapshot(monotonic())
                        if self.tenants.enabled else {}),
            "draining": self._draining,
            "model_version": self.engine.model_version,
            "replayed_requests": self._replayed_requests,
            "last_step_ms": round(self._last_step_ms, 3),
            "slots": slots,
            "flight_recorder": (self.flight.snapshot()
                                if self.flight is not None else []),
            "flight_dumps": self.flight.dumps if self.flight else 0,
            "kv": self.pool_stats(),
            "mesh": self.engine.mesh_info(),
            "speculation": {
                "mode": self._spec_mode,
                "k": self.spec_k,
                "proposed": self._spec_proposed_total,
                "accepted": self._spec_accepted_total,
                "acceptance_rate": round(self._spec_acceptance_rate(), 4),
            },
        }

    def _run(self) -> None:
        with self.run_supervisor or contextlib.nullcontext():
            while not self._stop.is_set():
                # one snapshot of the cross-thread state per iteration
                # (the HTTP thread publishes swaps and drains under the
                # cond); _live and _free are the worker's own
                with self._cond:
                    swap_pending = self._pending_swap is not None
                    draining = self._draining
                    queue_empty = not self._queue
                self._update_brownout(monotonic())
                if swap_pending and not self._live:
                    # admission pauses so _live can empty; queued and
                    # in-flight requests finish on the ADMITTED version
                    self._apply_pending_swap()
                    continue
                stepped = self._turn(swap_pending, draining, queue_empty)
                if not stepped:
                    with self._cond:
                        if not self._queue and not self._stop.is_set() \
                                and self._pending_swap is None:
                            self._cond.wait(timeout=0.1)

    def _turn(self, swap_pending: bool, draining: bool,
              queue_empty: bool) -> bool:
        """One turn of the loop after its snapshot: admit (unless a swap
        is pending), the drain's checks, then a step when a slot is live.
        A turn that took an admission batch or stepped is one
        ``serve/iteration``; any other records no span. Returns whether
        it stepped."""
        with telemetry.span(self.ITERATION_SPAN) as turn:
            admitted = not swap_pending and self._admit()
            if draining:
                if not self._live and queue_empty:
                    self._drained.set()
                elif monotonic() >= self._drain_deadline:
                    self._drain_expire()
            if not self._live:
                if not admitted:
                    turn.drop()
                return False
            step_start = monotonic()
            try:
                self._step()
            except Exception as e:
                self._recover_step(e)
            else:
                end = monotonic()
                self._last_step_ms = (end - step_start) * 1000.0
                self._record_step(step_start, end)
            return True
