"""Serving under an open loop: requests arrive on a fixed schedule
(Poisson at the cell's ``rate``) and go to ``SlotScheduler.submit`` in
process, with the scheduler's worker running; no HTTP.

Each request is a system prompt shared with others (the radix prefix
cache's work) and a user turn of its own, decoded greedily to its length.
Every request carries a ``RequestTrace`` that also stamps the
benchmark's clock where the scheduler hands it each token. A request's
TTFT runs from when it was due, not from when it was sent; the ITL
sample is every gap between two tokens of a request. Set-up ends when the
load has run ``warm_seconds``; the sample is every request due in the
next ``--seconds``. A request refused, failed, or unfinished a minute
past the close is missing: it counts in ``failed``, and in the TTFT tail
with the time it was waited for.

The warm-up, the window and the tail each get their own requests. Their
arrivals, the system prompt each picks and their lengths come from the
cell's ``schedule_seed`` and are the same in every run (one fixed sample
of the traffic, as a recorded trace is: where a seed ordered them, the
order decided where the bursts fell, and with it the tails);
``--seed`` draws the tokens, the weights and the requests checked.

The check reads the program's own logits: for the requests it samples
(chosen from the seed before the load starts), each slot's carried
logits are copied on the device just before the step that emits a token
from them, and compared with the reference's after the window.
"""

import functools
import json
import threading
import time

import numpy as np
import torch

from perfbench import harness, traffic, weights, yardstick
from perfbench.probe import port_spec
from perfbench.reference import gpt
from perfbench.reference import serve as ref_serve

#: how long past the close a request due in the window is waited for
GRACE_S = 60.0


@functools.cache
def stamps_class():
    """A RequestTrace that also keeps the benchmark's clock at each token
    the scheduler hands over (its own ITL aggregate keeps no gaps), and
    calls ``on_token`` on the scheduler's thread."""
    from trlx_tpu_torch.serve.trace import RequestTrace

    class Stamps(RequestTrace):
        __slots__ = ("times", "steps", "on_token", "watch")

        def __init__(self, on_token, watch=None):
            super().__init__()
            self.times = []  # the benchmark's clock at each token
            self.steps = []  # the scheduler's clock of the step it came in
            self.on_token = on_token
            self.watch = watch  # its place in the checked sample, or None

        def note_token(self, now):
            super().note_token(now)
            self.times.append(time.perf_counter())
            self.steps.append(now)
            self.on_token()

    return Stamps


def paged_geometry(spec, slots: int, page_size: int, max_pages: int):
    """(S, H, Hkv, hd, page size, pages a slot, paged-decode calls a step)
    of the slot pool: one call a step on each layer that attends."""
    model = harness.arch(spec)
    widths = [w for w in (model.attention_width(spec, i)
                          for i in range(spec["n_layer"])) if w]
    H = spec["n_head"]
    return (slots, H, model.kv_heads(spec), widths[0] // H, page_size,
            max_pages, len(widths))


class Serve:
    def __init__(self, ctx):
        self.ctx = ctx
        self.sched = None
        self.grace = GRACE_S

    # -- traffic -------------------------------------------------------- #

    def schedule(self, seconds: float):
        """(due s, system prompt index, user turn, output length) of every
        request of the run: warm-up, window and a tail that keeps the load
        on while the window's last requests finish. Each of the three
        parts holds round(rate x its length) requests of its own, due
        within it, in the order the cell's ``schedule_seed`` gives."""
        ctx, t = self.ctx, self.ctx.traffic
        rate = ctx.cell["rate"]
        V = ctx.spec["vocab_size"]
        k = t["system_prompts"]
        system_len = traffic.quantiles(t["system_lengths"], k)
        self.system = traffic.token_rows(system_len, V,
                                         traffic.rng_for(ctx.seed, "system"))
        order = ctx.cell["schedule_seed"]
        out, start = [], 0.0
        parts = (ctx.cell["warm_seconds"], seconds, ctx.cell["tail_seconds"])
        for part, length in enumerate(parts):
            n = int(round(rate * length))
            if n == 0:
                start += length
                continue

            def rng(stream, seed=order):
                return traffic.rng_for(seed, f"{stream}.{part}")

            # the gaps sum to a little under n / rate: scaled to the part,
            # the last request is due before it ends
            due = traffic.arrivals(rate, n, rng("due")) * (rate * length / n)
            which = traffic.popularity(k, t["popularity"], n, rng("pick"))
            users = traffic.sizes(t["user_lengths"], n, rng("user"))
            outs = traffic.sizes(t["output_lengths"], n, rng("out"))
            turns = traffic.token_rows(users, V, rng("turns", ctx.seed))
            out += list(zip((start + due).tolist(), which.tolist(), turns,
                            outs.tolist()))
            start += length
        return out

    def sample(self, seconds: float):
        """The requests whose logits the check reads, by index: the run's
        first (its prefill finds the prefix cache empty), the window's
        longest answer, and a run of ``check_requests`` consecutive
        window arrivals from a point drawn from the seed (live in slots
        at the same time)."""
        warm = self.ctx.cell["warm_seconds"]
        window = [i for i, r in enumerate(self.requests)
                  if warm <= r[0] < warm + seconds]
        if not window:
            return [0] if self.requests else []
        n = min(self.ctx.cell["check_requests"], len(window))
        at = int(traffic.rng_for(self.ctx.seed, "check").integers(
            len(window) - n + 1))
        longest = max(window, key=lambda i: self.requests[i][3])
        return sorted({0, longest, *window[at:at + n]})

    # -- set-up --------------------------------------------------------- #

    def setup(self):
        from trlx_tpu_torch.data.configs import TRLConfig
        from trlx_tpu_torch.examples import ppo_tldr
        from trlx_tpu_torch.models.hf_import import convert_state_dict
        from trlx_tpu_torch.models.params import DecodeViews
        from trlx_tpu_torch.models.transformer import tree_map
        from trlx_tpu_torch.serve.engine import InferenceEngine, ServeConfig
        from trlx_tpu_torch.serve.slots import SlotScheduler
        from trlx_tpu_torch.utils import DTYPES

        ctx = self.ctx
        cfg = ppo_tldr.tldr_config()
        for section, values in ctx.cell["trainer"].items():
            cfg[section].update(values)
        cfg["model"]["model_spec"] = dict(ctx.spec)
        self.cfg_dict = json.loads(json.dumps(cfg))
        config = TRLConfig.from_dict(cfg)
        spec = port_spec(ctx.spec)
        dtype = DTYPES[config.model.compute_dtype]
        sd = weights.state_dict(ctx.spec, ctx.seed, ctx.device, dtype)
        embed, blocks, ln_f = convert_state_dict(sd, spec, dtype=None)
        del sd
        k = config.model.num_layers_unfrozen
        L = spec.n_layer
        views = DecodeViews(
            blocks=(tree_map(lambda x: x[:L - k], blocks),
                    tree_map(lambda x: x[L - k:], blocks)),
            embed=embed, ln_f=ln_f)
        self.engine = InferenceEngine(
            config, serve=ServeConfig(**ctx.cell["engine"]), views=views,
            device=ctx.device)
        del views, embed, blocks, ln_f
        self.sched = SlotScheduler(self.engine)
        self.sched.warmup()
        self.watch_steps()
        if ctx.tracer.on:  # the profiler's first start takes seconds
            ctx.tracer.warm()
        self.sched.start()
        self.start_load()

    def start_load(self):
        """Start the open loop and return when it has run
        ``warm_seconds``."""
        ctx = self.ctx
        self.trace_span = None
        self.requests = self.schedule(ctx.seconds)
        self.watched = {i: k for k, i in enumerate(self.sample(ctx.seconds))}
        self.start_capture()
        self.sent = [None] * len(self.requests)
        self.late = [0.0] * len(self.requests)
        self.stop = threading.Event()
        self.origin = time.perf_counter()
        self.sender = threading.Thread(target=self.send, daemon=True,
                                       name="perfbench-sender")
        self.sender.start()
        self.open = self.origin + ctx.cell["warm_seconds"]
        at, length = ctx.cell["trace_at"]
        self.trace_span = (self.open + at, self.open + at + length)
        self.traced = None
        time.sleep(max(0.0, self.open - time.perf_counter()))

    def send(self):
        """Submit each request when it is due (the open loop)."""
        for i, (due, which, turn, out) in enumerate(self.requests):
            at = self.origin + due
            while not self.stop.is_set():
                wait = at - time.perf_counter()
                if wait <= 0:
                    break
                self.stop.wait(min(wait, 0.05))
            if self.stop.is_set():
                return
            trace = stamps_class()(self.on_token, self.watched.get(i))
            prompt = self.system[which].tolist() + turn.tolist()
            try:
                req = self.sched.submit(prompt, max_new_tokens=int(out),
                                        trace=trace)
            except Exception as e:  # noqa: BLE001 - a refusal is a miss
                req = e
            self.late[i] = time.perf_counter() - at
            self.sent[i] = (prompt, trace, req)

    # -- the program's logits ------------------------------------------ #

    def start_capture(self):
        """A device buffer for the sampled requests' logits, a row for
        each token they can be served (a replay after a preemption takes
        more; past the buffer's end nothing is kept, and the check then
        finds positions it has no logits for)."""
        need = sum(self.requests[i][3] for i in self.watched)
        V = self.ctx.spec["vocab_size"]
        self.rows = torch.empty((need + need // 4 + 8, V),
                                dtype=torch.float32, device=self.ctx.device)
        self.row_of = []  # (place in the sample, position served)

    def watch_steps(self):
        """Before each decode step, on the scheduler's thread, copy the
        carried logits of every sampled live slot: the logits that step
        takes its token from (the prefill's for a request's first token).
        The copy is queued on the thread's stream ahead of the step."""
        sched = self.sched
        rt = sched.runtime
        inner = rt.step

        def step(seed):
            for slot, live in list(sched._live.items()):
                k = getattr(live.request.trace, "watch", None)
                if k is not None and len(self.row_of) < len(self.rows):
                    self.rows[len(self.row_of)].copy_(rt.state.logits[slot])
                    self.row_of.append((k, len(live.tokens)))
            return inner(seed)

        rt.step = step

    # -- window --------------------------------------------------------- #

    def on_token(self):
        """On the scheduler's thread, between its steps: start and stop
        the traced part (the thread that launches the device work is the
        one that may start and stop the profiler)."""
        tracer, span = self.ctx.tracer, self.trace_span
        if span is None or not tracer.on:
            return
        now = time.perf_counter()
        if not tracer.active and not tracer.done and now >= span[0]:
            if tracer.start():
                self.traced = [time.perf_counter(), None, time.monotonic(),
                               None]
        elif tracer.active and now >= self.traced[0] + span[1] - span[0]:
            tracer.stop()
            self.traced[1], self.traced[3] = time.perf_counter(), \
                time.monotonic()

    def window(self):
        ctx = self.ctx
        close = self.open + ctx.seconds
        time.sleep(max(0.0, close - time.perf_counter()))
        idx = [i for i, r in enumerate(self.requests)
               if self.open <= self.origin + r[0] < close]
        give_up = close + self.grace
        for i in idx:
            while self.sent[i] is None and time.perf_counter() < give_up:
                time.sleep(0.01)
            sent = self.sent[i]
            if sent is not None and not isinstance(sent[2], Exception):
                sent[2].done.wait(max(0.0, give_up - time.perf_counter()))
        end = time.perf_counter()
        self.stop.set()
        self.sender.join(timeout=30)
        if ctx.tracer.active:  # no token came after the traced part
            self.drain()
            ctx.tracer.stop()
            self.traced[1], self.traced[3] = time.perf_counter(), \
                time.monotonic()
        tel_step = self.step_median_ms()
        ttft, itl, failed, done = [], [], 0, []
        for i in idx:
            due = self.origin + self.requests[i][0]
            sent = self.sent[i]
            req = None if sent is None else sent[2]
            ok = (req is not None and not isinstance(req, Exception)
                  and req.done.is_set() and req.error is None
                  and sent[1].times)
            if not ok:
                failed += 1
                ttft.append(end - due)
                continue
            times = sent[1].times
            ttft.append(times[0] - due)
            itl += list(np.diff(times))
            done.append(i)
        self.done = done
        self.late_ms = 1e3 * max((self.late[i] for i in idx), default=0.0)
        traced = self.traced if self.traced and self.traced[1] else None
        readings = self.readings(idx, traced)
        readings["step_ms"] = tel_step
        metrics = {"ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95))}
        if itl:
            metrics["itl_p95_ms"] = 1e3 * float(np.percentile(itl, 95))
        return {"metrics": metrics, "attempted": len(idx), "failed": failed,
                "readings": readings}

    def step_median_ms(self):
        from trlx_tpu_torch import telemetry

        tel = telemetry.current()
        hist = None if tel is None else tel.registry.hists.get(
            "time/serve/slot_step")
        return None if hist is None else 1e3 * hist.quantile(0.5)

    def readings(self, idx, traced):
        """What the per-layer metrics read: queue times and prefix hits of
        the window's requests (their traces), and the decode steps and
        prefills inside the traced part."""
        ps = self.engine.serve.page_size
        queue, saved, prompt = [], 0, 0
        # queue times of the requests enqueued before a traced part: the
        # profiler's stop holds the scheduler up, and the queue with it
        before = float("inf") if traced is None else traced[2]
        for i in idx:
            sent = self.sent[i]
            if sent is None or isinstance(sent[2], Exception):
                continue
            tr = sent[1]
            if tr.admitted:
                if tr.enqueued < before:
                    queue.append(tr.admitted - tr.enqueued)
                saved += tr.prefix_blocks_hit * ps
                prompt += len(sent[0])
        out = {"queue_s": queue, "prefix_saved": saved,
               "prompt_tokens": prompt}
        if traced is None:
            return out
        m0, m1 = traced[2], traced[3]
        steps, flops = {}, 0
        spec = self.ctx.spec
        every = range(spec["n_layer"])
        for sent in self.sent:
            if sent is None or isinstance(sent[2], Exception):
                continue
            prompt_len, tr = len(sent[0]), sent[1]
            # the step that hands over token j (the first too: it is taken
            # from the prefill's logits) runs it through every block at
            # position prompt_len + j, over prompt_len + j + 1 keys
            for j, at in enumerate(tr.steps):
                if m0 <= at <= m1:
                    steps.setdefault(at, []).append(prompt_len + j + 1)
                    flops += yardstick.decode_flops(spec, every,
                                                    prompt_len + j, 1)
            if tr.admitted and m0 <= tr.prefill_start <= m1:
                flops += yardstick.prefill_flops(
                    spec, every, prompt_len, prompt_len - tr.suffix_len)
        out["paged_steps"] = list(steps.values())
        out["traced_flops"] = flops
        runtime = self.sched.runtime
        out["paged_geometry"] = paged_geometry(spec, runtime.num_slots, ps,
                                               runtime.max_pages)
        return out

    # -- check ---------------------------------------------------------- #

    def drain(self, timeout: float = 120.0) -> None:
        """Wait until the scheduler holds no request."""
        sched = self.sched
        give_up = time.perf_counter() + timeout
        while time.perf_counter() < give_up and (
                sched.queue_depth() or
                sched.free_slots() < sched.runtime.num_slots):
            time.sleep(0.05)

    def release(self):
        """Stop the scheduler; keep the sampled requests that finished,
        each with its prompt, its served tokens, and the program's logits
        at the positions that were captured (on the host); free the
        rest."""
        self.sched.stop()
        rows = self.rows[:len(self.row_of)].cpu()
        self.recorded = []
        for i, k in sorted(self.watched.items(), key=lambda x: x[1]):
            sent = self.sent[i]
            req = None if sent is None else sent[2]
            if req is None or isinstance(req, Exception) or \
                    not req.done.is_set() or req.error is not None:
                continue  # late or refused: the window's numbers count it
            at = [r for r, (kk, _) in enumerate(self.row_of) if kk == k]
            self.recorded.append({
                "prompt": sent[0], "served": list(req.result),
                "hit": sent[1].prefix_blocks_hit,
                "positions": [self.row_of[r][1] for r in at],
                "logits": rows[at]})
        self.sched = self.engine = self.sent = self.rows = None

    def reference(self, prec: gpt.Precision):
        from trlx_tpu_torch.utils import DTYPES

        ctx = self.ctx
        dtype = DTYPES[self.cfg_dict["model"]["compute_dtype"]]
        sd = weights.state_dict(ctx.spec, ctx.seed, ctx.device, dtype)
        return ref_serve.logits(
            sd, ctx.spec, [(r["prompt"], r["served"]) for r in self.recorded],
            prec, ctx.device)

    def gaps(self, ours, ref):
        """``logit_gap``: the widest gap of a served token's reference
        logit below the reference's best; ``logit_diff``: the widest
        difference of a logit from the reference's, over every position
        held. ``ours``: the recorded requests (the program: its served
        tokens and its logits, every position of each request required),
        or another precision's logits at every position (the control: its
        first-ranked tokens)."""
        gap = diff = 0.0
        for k, ref_logits in enumerate(ref):
            if torch.is_tensor(ours[k]):
                logits = ours[k].to(ref_logits.device)
                tokens = logits.argmax(-1).cpu().numpy()
                positions = list(range(len(ref_logits)))
            else:
                tokens = ours[k]["served"]
                positions = ours[k]["positions"]
                logits = ours[k]["logits"].to(ref_logits.device)
            gap = max(gap, float(ref_serve.gaps_of(ref_logits, tokens).max()))
            if sorted(set(positions)) != list(range(len(tokens))):
                diff = float("inf")  # a served token with no logits kept
                continue
            held = ref_logits[torch.as_tensor(positions,
                                              device=ref_logits.device)]
            diff = max(diff, float((logits - held).abs().max()))
        if not ref:
            gap = diff = float("inf")  # nothing to compare
        return {"logit_gap": gap, "logit_diff": diff}

    def check(self):
        gaps = self.gaps(self.recorded,
                         self.reference(gpt.Precision("float32")))
        limits = self.ctx.cell["limits"]
        return [(k, gaps[k], limits[k]) for k in limits]


def make(ctx):
    return Serve(ctx)
