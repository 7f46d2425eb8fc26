#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (trlx_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device — a CUDA card must be present (no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them.
2. build — compiles every kernel source under trlx_tpu_torch/csrc with
   nvcc for sm_90a, all at once (ptxas registers / shared memory /
   spills printed, and ptxas's note where it serialized wgmma).
3. kernel — the paged-decode kernel against its plain PyTorch version on
   the card: fp32 (GQA + sentinel pages, atol 1e-5), the int8 tier (atol
   1e-5), and the serving shape in bf16 with a fully masked free row that
   must come out finite (atol 1e-2 + rtol 1e-2 against the plain version
   in fp32 on the same bf16 inputs); then split-K at a 1024-token context
   (the planner's P > 1 partitions and the combine kernel; ragged lengths
   at and beside partition edges, dead partitions, a free row): bf16 MHA
   and bf16 GQA (H 8, Hkv 2) at atol 1e-2 + rtol 1e-2, fp32 GQA and the
   int8 tier at atol 1e-5, every row finite, P printed; then CUDA-event
   timings of kernel, plain version and the gather + SDPA yardstick at
   the serving shape and at a 1024-token context, each beside its bound:
   device time from CUDA-graph replay (the numbers in the kernels line)
   and the eager loop's time, which includes the host's launch cost; and
   the 1024-token time for each partition count beside the planner's.
   Then the bf16-query x int8-pool instance (what an int8 KV engine
   launches at bf16) against its plain version in float32 math at hd 64
   and hd 256, at the serving context and at 1024 tokens (atol 1e-2 +
   rtol 1e-2, every row finite), and timed at both serving shapes.
   Then the rollout decoder's step attention at the PPO TL;DR shape (B
   32, 576 keys, 16 heads of 256, bf16): the kernel over the dense cache
   viewed as pages of 16, 32 and 64, and the plain einsum attention with
   its copies, checked and timed beside the bound.
4. flash —the three flash-attention kernels against the dense oracle
   and its autograd: fp32 causal with left padding at T 52 and 576 and
   the non-causal form (O and lse on real rows atol 1e-5, dq / dk / dv
   atol 2e-4); the bf16 kernels (wgmma) at hd 16, 32, 64, 128 and 256,
   T 130 causal with a fully left-padded row and T 96 non-causal: the
   forward against its plain version (O on real rows at atol 1e-2 +
   rtol 1e-2, lse on real rows at atol 1e-3, every row finite), the
   backward pair against theirs; and bf16 at the training shape; each
   bf16 kernel against its plain version in fp32 math on the same inputs
   (atol 1e-2 + rtol 1e-2, outputs in q's dtype, every row finite); then
   kernel, plain-version and SDPA-yardstick times (CUDA-graph replay and
   eager) at the training shape (B 32, T 576, H 12, hd 64, bf16, causal)
   and at B 8, T 2048, each beside its bound, and the whole backward seam
   (dq, which computes D, then dk/dv in one graph) beside SDPA's backward.
   The build first shows every bf16 flash kernel's SASS (the forward
   and both backward kernels, hd 16-256) holds HGMMA (wgmma) and
   UTMALDG (TMA) and no HMMA (mma.sync), and that their shared memory
   (and the forward's consumers, stages and register split) is the
   wrappers' plan.
4b. sp and pp — sequence and pipeline parallelism with every rank in
   this process (the loopback exchange: NCCL refuses two ranks on one
   card). [sp]: ring attention (trlx_tpu_torch.ops.ring_attention) at
   bf16 over sp 2 and 4 at the PPO training shape (B 32, T 576, H 12,
   hd 64) and at gpt-j's heads (B 8, T 576, H 16, hd 256), left-padded:
   forward and backward, each block pair through the flash kernels
   (launches per call == sp (sp + 1) / 2 of each), against the same
   ring on the plain versions (atol 1e-2 + rtol 1e-2), the dense oracle
   in fp32 on the whole sequence and the one-call seam (O on live rows
   at atol 1e-2 + rtol 1e-2, gradients by relative L2 at 2e-2); the
   ring's time beside the seam's. [pp]: the GPipe schedule
   (trlx_tpu_torch.ops.pipeline_parallel) of the gpt2-width trunk (12
   seeded layers, B 32, T 576) at pp 2 and 4 in 4 microbatches, flash
   inside the stages (flash_fwd launches == 4 x 12), against the plain
   trunk (relative L2 on live rows: 1e-4 fp32, 2e-2 bf16), timed; and,
   inside phase 10c's world of one, ``train.mesh {dp: -1, sp: 1, pp:
   1}`` through the trainer: no ring, no pipeline, one fp32 update
   equal to the plain trainer's.
5. serve — the port's serving path at gpt2-124M width (12 layers, seeded
   random weights, bf16) behind its HTTP server: concurrent
   ``/generate`` requests with mixed ``max_new_tokens`` and a shared
   system prompt, ``/healthz``, kernel launches == layers x decode
   steps, radix prefix hits > 0; prints tok/s and latency. Decode and
   every prefill bucket run as CUDA-graph replays
   (trlx_tpu_torch.utils.aotjit; 7 graphs captured at warmup, their
   capture seconds and private-pool bytes printed), with
   ``compile/recompiles`` 0 in the registry and in ``/healthz``.
6. parity — the same requests through fp32 engines on the kernel path
   and on the plain path, with the same weights: identical greedy tokens.
   Then graphs against eager (``aotjit.CUDA_GRAPHS`` off, then on, in
   this process): the same requests at fp32 and bf16, greedy and sampled
   (each step re-seeded from serve.seed + step): identical tokens,
   paged-decode launches identical on both paths and == layers x steps,
   0 recompiles; the step's p50 / p95 on both paths.
   Then the serve tiers on the same 10 requests (``serve_tiers_phase``):
   ``scheduler: static`` (the micro-batcher, one ``generate`` graph per
   bucket) and ``kv_layout: contiguous``, each with fp32 greedy tokens
   equal to phase 6's; ``kv_dtype: int8`` on the kernel path at fp32
   (tokens equal to the int8 plain path's) and at bf16 (the bf16 q x
   int8 pool instance), paged-decode launches == layers x steps on the
   int8 pool, tokens against the bf16 KV runs; ``speculation: lookup``
   (spec_k 4) on the kernel path, fp32 tokens equal to speculation off,
   at bf16 the share identical and the first divergence with its logit
   margin; acceptance, tokens per slot per verify pass and step p50s
   printed; 0 recompiles in every run.
6c. serve mesh (``[serve-mesh]``) — first paged decode at the shapes a
   process of a tp serve mesh hands it (H = Hkv 6 and 3 at hd 64: gpt2
   under tp 2 and 4; 8 and 4 at hd 256: gpt-j), bf16 q over the bf16 and
   the int8 pool, 16 slots x 4 pages of 16 with a free row, against its
   plain version in float32 math (atol 1e-2 + rtol 1e-2, every row
   finite), and timed there (bf16 pool) beside its bound, the plain
   version and gather + SDPA. Then phase 5's lattice, requests and
   kernel path at fp32 on ``serve.mesh``: (a) ``{tp: 1}`` in a world
   of one process over NCCL behind the HTTP server, graphs on, the
   mesh's all-reduces captured inside the step and every prefill
   bucket: greedy tokens identical to phase 6's plain engine, paged
   decode launches == layers x steps, 0 recompiles, ``/healthz``'s
   ``mesh`` block ``{devices: 1, axes: {tp: 1}}``, the step p50 beside
   the plain engine's; (b) ``{tp: 2}`` and ``{tp: 4}`` with every rank a
   child process on this card (``chip_smoke.py --serve-mesh-child``):
   NCCL refuses two ranks on one card, so they join over gloo, which
   stages CUDA tensors through the host and cannot be captured: the
   runtime refuses graphs over it at construction (checked), so they
   run with graphs off; rank 0 serves the requests, the others follow:
   tokens identical to (a)'s, every rank's token digest equal, paged
   decode on each rank's 6- and 3-head shards (launches == layers x
   steps a rank), 0 recompiles. The kernels line counts the phase under
   ``serve_mesh`` and gains a ``paged_decode (tp shards)`` entry. Then
   the static leg, ``scheduler: static`` (the micro-batcher, one
   ``generate`` per bucket, dense attention: no kernel) at fp32, greedy,
   on the serve buckets: (a-static) ``{tp: 1}`` over NCCL through HTTP
   with graphs on (one captured decode step per bucket), then the plain
   static engine on the same requests; (b-static) ``{tp: 2}`` as two
   gloo ranks on this card, graphs off (refused over gloo at the
   micro-batcher's construction, checked), rank 0 flushing and rank 1
   following each ``decode``: tokens equal to the plain static engine's,
   0 recompiles, the ranks' static digests equal, the follower exiting
   0 after the stop; each with its wall time and a flush's p50.
7. train — the PPO main path at gpt2-124M width with
   examples/ppo_tldr.py's wiring (configs/ppo_tldr.yml's geometry: 12
   layers, 2 unfrozen, synthetic TL;DR documents left-padded to 512
   bytes + 64 generated tokens, batch 32, 4 PPO epochs, fused_attention,
   bf16, seeded random weights, byte tokenizer; the reward model built
   from the trainer's own trunk with a fresh head, scoring each rollout
   chunk on the card; the commit gate on, max_bad_steps 2; a step
   checkpoint every 4 passes, the newest 2 kept) through the registry,
   the pipeline, the orchestrator's make_experience and learn(): flash
   launches equal chunks x (L + k) + passes x L forwards and passes x k
   of each backward kernel, every logged loss, grad norm and KL is
   finite, every logged bad_step is 0, and step_4 and step_8 land with
   LATEST naming step_8; the rollouts replay one captured decode step
   (one signature, 0 recompiles); prints rollout and update time,
   samples/s and each save's time. Then, on that run directory:
   - serve from a checkpoint: the serve CLI's ``--checkpoint`` loader
     (newest step; the config from meta.json, made greedy by
     ``--config``) and an engine on the trainer's in-memory params give
     identical greedy tokens for two requests; paged decode launches
     layers x decode steps;
   - speculation draft: the same run directory's newest checkpoint as
     target and draft (fp32, greedy, 4 slots): acceptance 1.0, tokens
     equal to speculation off, 0 recompiles;
   - resume: a fresh trainer from seed 1 with ``resume_from: auto``
     restores iter_count == LATEST's step at construction, every tensor
     bit-identical; the next update of both trainers on the same batch
     is bit-identical again (params, mu, nu, count, generator state);
   - the commit gate: NaN rewards give bad_step 1 with params, moments
     and count bit-identical, the guarded step running under
     ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside it
     fails the run); the next clean batch commits;
   - graphs against eager: greedy rollout decode at the rollout shape,
     tokens and logprobs identical on both paths before and after one
     more update pass (which moved the logprobs: the graph read the new
     weights); the orchestrator's 64 rollouts timed on both paths.
   - the run floor: phase 7 runs supervised with configs/ppo_config.yml's
     block as shipped (stall_timeout 300, stall_grace 120,
     host_call_timeout 60, telemetry on) and learn() logs through
     ``tracker: "jsonl:<run dir>/metrics.jsonl"``: one record per
     logged iteration, each with ``time/*``, ``throughput/*`` (MFU in
     (0, 1)) and ``device/hbm_*`` (the peak equal to
     ``torch.cuda.max_memory_allocated()``); ``telemetry.json`` and
     ``trace.jsonl`` written, every ``fault/*`` counter 0; the first
     calls the watchdog saw printed. Then on the warm trainer: its
     update and rollout times with the supervisor on and off
     (alternated); the drills (a hung reward_fn attempt under a 1.5 s
     stall budget: learn() completes, fault/stalls, seam_timeouts and
     host_retries >= 1, the stack dump names 'reward_fn' and
     MainThread; every attempt hung: StallError, the checkpoint at the
     stall step restored bit-identically by a fresh trainer; a chaos
     SIGTERM: a preemption checkpoint; max_walltime: a checkpoint and a
     clean return; the guarded step with the telemetry payload inside an
     armed supervisor under set_sync_debug_mode "error"); a decode
     graph captured while an abandoned scoring seam launches on the card
     (first attempt), and again while it synchronises the whole device
     (the invalidated capture taken again); one cycle under
     ``TRLX_TPU_PROFILE_DIR`` whose Chrome trace names the three flash
     kernels' CUDA symbols and the decode graph's ``cudaGraphLaunch``.
   - the serve lifecycle (``[serve-lifecycle]``), in process on the run
     directory's newest step (bf16, greedy, the kernel path, phase 5's
     lattice and 16 slots): the 10 requests over HTTP, each with a
     ``trace_id``, ``serve/ttft`` and ``serve/itl`` observed, Prometheus
     text on ``Accept: text/plain``, ``/debug/slo`` and ``/debug/state``;
     a tenant over its 2-request bucket gets 429 with ``Retry-After``
     while the default tenant is served, and a ``deadline_ms`` that
     passes in the queue 503; a ``serve_decode`` fault at the third step
     replays every request (bf16: the divergence printed; an fp32 engine:
     tokens identical to the run without it); ``POST /admin/reload`` to
     the older step commits model_version 2 with every engine tensor at
     its address and 0 recompiles, its tokens those of a fresh engine on
     that step, and a ``serve_reload`` fault answers 409 with the tokens
     unchanged; ``POST /admin/drain`` with the requests in flight: 429
     for a new one, ``/readyz`` 503, every request answered whole, the
     drain clean; paged-decode launches == layers x steps; the step p50
     with tracing on and off; and two ``python -m trlx_tpu_torch.serve``
     children started with phase 7: a chaos hang under ``stall_timeout:
     2`` exits 70 with the flight recorder in its stall dump, a SIGTERM
     exits 0 after a clean drain.
   - the fleet (``[fleet]``, bench.py's bench_fleet on the port): a
     hard-linked copy of the run directory's newest step, bf16, greedy,
     16 slots, pages of 16, one bucket 8 x (64 + 32), the kernel path;
     96 requests (4 system prompts of 48 tokens + tails of 2-8,
     ``max_new_tokens`` 4 / 8 / 16, seed 17) through one engine (the
     direct leg, whose TTFT p95 is the fleet's SLO), then from 16 HTTP
     clients through ``trlx_tpu_torch.router`` over two in-process
     replicas with ``POST /admin/rollout`` once a quarter has landed:
     the rollout ok, ``model_version`` 2 on both, 0 lost, 0 recompiles,
     every request's tokens equal to the direct leg's, paged decode
     launches == layers x the replicas' steps; a replica stopped in the
     middle of a burst (every request 200 through failover, the replica
     revived and re-admitted); a rollout under ``checkpoint_verify:
     exc@1`` (409, the version kept, one replica admitting throughout,
     the copy quarantined); ``python -m trlx_tpu_torch.obs summarize
     --json`` on the router's access log counts ``router/requests``.
     Then ``[native]``: the host C++ library built, the byte tokenizer
     on 4096 texts and the ILQL loader on 320 rows through it, equal to
     the Python loops, both timed.
   - escalation, in child processes beside phases 8 and 10 (2 layers, T
     576): a hung ``ppo_update`` under ``stall_action: checkpoint_exit``
     exits 75 with a rescue checkpoint at step 4, which a third child
     with ``resume_from: auto`` continues to step 16; ``abort`` exits 70
     with none.
8. train parity — one train_step and one 2-pass train_multi at fp32 on
   the kernel path, each pass against the dense path's pass at the same
   parameters and on one rollout batch: loss and grad norm at rtol 1e-5,
   and the first step's per-leaf gradients by
   tests/test_golden_step.py's relative-L2 rule at 2e-3; the same rule on
   each pass's update is printed, with the dense gradient at the
   elements whose first Adam steps differ in sign.
9. ilql — the ILQL main path at configs/ilql_config.yml's width
   (gpt2-124M, full unfreeze, batch 80, bf16, fused_attention, seeded
   random weights, byte tokenizer) through the registry, the offline
   orchestrator and learn(): 320 pre-tokenized rows of 130-500 tokens
   (T 500, right-padded, terminal slots masked), one epoch of 4 updates
   with a target sync at step 2 and one eval of 64 bos prompts x 32
   tokens; flash launches equal layers x updates for each kernel, every
   loss finite; prints the update times, training tokens/s, the eval
   time, the peak device memory and the split of steps 2-4 (trunk
   forward, heads and loss, backward, optimizer) from the CUDA events
   the trainer's ``step_events`` records; supervised like phase 7, its
   ``telemetry.json`` and ``trace.jsonl`` written, fault counters 0.
   Then its eval sampler (the
   advantage-shifted step, captured at the step-0 eval) on both paths
   from one generator state: identical sampled tokens and generator
   state, timed. Then the trainer is saved,
   restored into a fresh trainer from seed 1 (every tensor
   bit-identical, the zero-size frozen leaves included) and both take
   one more update on the same batch, bit-identical again; save and
   restore times and bytes are printed for both trainers' checkpoints.
10. ilql parity — three fp32 train steps on the kernel path, each against
   the dense path at the same parameters (B 8, T 200, right-padded,
   terminal slots masked): loss and grad norm at rtol 1e-5, and every
   step's per-leaf gradients by phase 8's relative-L2 rule at 2e-3. Then
   the bf16 kernels at the shape the ILQL phase gave them (B 80, T 500,
   H 12, hd 64, the first batch's mask), each against its plain version
   (atol 1e-2 + rtol 1e-2, lse at atol 1e-3, every row finite), and
   their times there, each beside its bound (the causal pairs with a
   real key) and SDPA's.
10c. mesh (after phase 10) — the same policy (phase 7's seeded weights
   and rollout batch, fused attention) on a device mesh of one card —
   a world of one process over NCCL, ``build_mesh({"dp": -1, "fsdp":
   1, "tp": 1})`` passed as ``mesh=`` — against the same trainer
   without one. At fp32: one make_experience of 32 greedy rollouts
   (the reward model from the trainer's trunk, on the mesh too) and
   one learn() of 2 passes: every trainable leaf a DTensor, rollout
   tokens identical, the logged loss and pre-clip grad norm and the
   updated parameters at rtol 1e-5, the three flash kernels launched
   in the phase (counted), 0 recompiles; a checkpoint of the mesh
   trainer restored into a plain trainer (every tensor bit-identical)
   and the next update bit-identical on both. At bf16: one update from
   the same batch, loss and grad norm at rtol 1e-5. The update (2
   passes) and rollout (32) times with the mesh and without it,
   alternated, beside the card's line.
11. gpt-j-6B at its published width (vocab 50400, 28 layers, 16 heads of
   256, d_model 4096, d_ff 16384; ~6.05 B parameters), in a child
   process (``chip_smoke.py --gptj-child``) started right after the
   build, while this process holds next to nothing on the card, so its
   memory never meets the gpt2 phases'. Its weights are a seeded HF-layout GPT-J
   ``state_dict`` made on the card in bf16 and turned into the
   trainer's tree by the ported converter and
   ``hydra_params_from_trunk``:
   - configs/ppo_gptj_single_chip.yml as shipped (adafactor, 1 unfrozen
     layer, bf16 frozen storage, remat, B 8, 4 + 48 tokens, top_p 0.7,
     temperature 0.5, the byte tokenizer the ``gpt2`` path falls back
     to, a host reward), cut to 3 cycles, with ``continuous_rollouts``
     off, then on: finite losses, no step skipped by the commit gate, 0
     recompiles, the update and rollout times, ``device/hbm_peak_gb``
     beside ``_check_memory_fit``'s state estimate;
   - the trained policy served from its own tensors (8 requests, one
     bucket): paged decode at hd 256 inside the decode step's CUDA graph
     (launches == layers x steps), fp32 greedy tokens identical on the
     kernel and the plain gather path, the bf16 divergences printed
     with their fp32 top-2 logit gaps; then served again with
     ``weights_dtype: int8`` and ``kv_dtype: int8`` (paged decode, bf16
     q x int8 pool at hd 256, launches == layers x steps; ``serve/
     model_gb`` against bf16's; every response as long as bf16's; the
     first step's logit gap; step p50s; peak memory; the cost of the
     int8 projections' bf16 weight copies); then that engine hot-swapped
     to the trainer's params (re-quantized, installed in place): version
     2, every tensor at its address, 0 recompiles, the same tokens, the
     swap's time printed;
   - one PPO cycle at configs/ppo_tldr.yml's shape (512 + 64 tokens, 2
     unfrozen layers, fused_attention, bf16, B 8): the three flash
     kernels launch at hd 256 (chunks x (L + k) + passes x L forwards,
     passes x k of each backward kernel); then phase 8's fp32 kernel vs
     dense step at 2 layers (1 trainable) of the same width, at its
     tolerances.

The flash checks of phase 4 include ILQL's mask at T 500 (fp32 against
the dense oracle, bf16 against the plain versions) and, at gpt-j-6B's
head dim, the TL;DR shape (B 8, T 576, H 16, hd 256, left padding; bf16
against the plain versions, fp32 against the dense oracle), timed there
beside its bounds and SDPA; phase 3's include paged decode at gpt-j's
heads (16 slots, the serving context and 1024 tokens; bf16, fp32, int8)
timed at both, with each partition count. Then one ``{"kernels":
[...]}`` line (launches summed over the phases that drive each kernel,
and by phase; the hd-256 and the bf16 q x int8 pool instances as
entries of their own), the nvidia-smi line, and last ``{"ok": true,
"device": {...}}``.
"""

import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import signal
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from trlx_tpu_torch import native, ops, supervisor, telemetry
from trlx_tpu_torch.data.configs import ModelSpec, TRLConfig
from trlx_tpu_torch.examples import ilql_sentiments, ppo_tldr
from trlx_tpu_torch.models.generation import PAGE_SENTINEL as SENT
from trlx_tpu_torch.models.generation import RolloutDecoder, generate
from trlx_tpu_torch.models.hf_import import (
    convert_state_dict,
    hydra_params_from_trunk,
)
from trlx_tpu_torch.models.params import (
    decode_views_from_numpy,
    init_decode_views,
    init_hydra_numpy,
    init_ilql_numpy,
)
from trlx_tpu_torch.models.transformer import (
    NEG_INF,
    apply_blocks,
    attention_scores,
    causal_mask_bias,
    embed_tokens,
    layer_params,
    lm_logits,
    quantize_kv,
    tree_map,
)
from trlx_tpu_torch.models.transformer import _project as project
from trlx_tpu_torch.ops import _build
from trlx_tpu_torch.ops import flash_attention as fa
from trlx_tpu_torch.ops import paged_attention as pa
from trlx_tpu_torch.models.policy import (
    HydraPolicy,
    all_blocks,
    head_params_for_decode,
)
from trlx_tpu_torch.ops.pipeline_parallel import pp_apply_blocks_loopback
from trlx_tpu_torch.ops.ring_attention import ring_attention_loopback
from trlx_tpu_torch.ops.paged_attention import (
    decode_partitions,
    paged_decode_attention,
    paged_decode_attention_reference,
)
from trlx_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    MicroBatcher,
    ServeConfig,
    SlotScheduler,
)
from trlx_tpu_torch.serve.slots import SlotPoolRuntime
from trlx_tpu_torch.router import FleetRouter, RouterConfig
from trlx_tpu_torch.serve import __main__ as serve_cli
from trlx_tpu_torch.parallel import build_mesh, initialize_runtime
from trlx_tpu_torch.parallel.sharding import is_dtensor
from trlx_tpu_torch.trainers import build_optimizer
from trlx_tpu_torch.ops.sampling import SamplingParams
from trlx_tpu_torch.trainers.ilql_trainer import STEP_PARTS
from trlx_tpu_torch.supervisor import (
    RunSupervisor,
    SeamTimeout,
    StallError,
    chaos,
)
from trlx_tpu_torch.utils import DTYPES, aotjit
from trlx_tpu_torch.utils.checkpoint import (
    find_latest_checkpoint,
    restore_tensor_component,
    save_components,
)
from trlx_tpu_torch.utils.faults import retry_call
from trlx_tpu_torch.utils.profiling import annotate
from trlx_tpu_torch.utils.loading import (
    get_model,
    get_orchestrator,
    get_pipeline,
)

#: where the run's checkpoints go (inside the checkout, git-ignored),
#: removed when the run ends
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "ckpts", "chip_smoke")

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

#: gpt2-124M geometry from config, byte tokenizer, greedy decode
GPT2_SPEC = {"vocab_size": 50257, "n_layer": 12, "n_head": 12,
             "d_model": 768, "n_positions": 1024}
#: (batch, prompt_len, gen_len): the (16, 48) class of the serving legs
#: plus a (32, 32) class for prompts that carry a shared 16-token system
#: prompt — the radix cache only matches whole pages and always leaves a
#: suffix token, so a 16-token page is only hit by prompts of 17+
#: tokens. Every class spans 64 positions: 4 pages of 16 per slot.
SERVE_BUCKETS = [[8, 16, 48], [16, 16, 48], [16, 32, 32]]
SYSTEM_PROMPT = "You answer well."  # 16 bytes: one page
USER_PROMPTS = [
    ("Hi", 48), ("What is 2+2?", 40), ("Tell a story", 24), ("x", 8),
    (SYSTEM_PROMPT + " Who are you?", 32),
    (SYSTEM_PROMPT + " Name a fruit.", 20),
    (SYSTEM_PROMPT + " Count to 5.", 12),
    (SYSTEM_PROMPT + " Say hi.", 30),
    (SYSTEM_PROMPT + " Spell cat", 16),
    (SYSTEM_PROMPT + " Why?", 32),
]


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def config_dict(compute_dtype="bfloat16", sample=False):
    return {
        "model": {
            "model_path": "from-config", "tokenizer_path": "byte",
            "model_type": "JaxPPOTrainer", "num_layers_unfrozen": 2,
            "model_spec": dict(GPT2_SPEC), "compute_dtype": compute_dtype,
        },
        "train": {
            "n_ctx": 64, "epochs": 1, "total_steps": 4, "batch_size": 8,
            "grad_clip": 1.0, "lr_ramp_steps": 0, "lr_decay_steps": 4,
            "weight_decay": 1e-6, "learning_rate_init": 1e-3,
            "learning_rate_target": 1e-3, "log_interval": 10**9,
            "checkpoint_interval": 10**9, "eval_interval": 10**9,
            "pipeline": "PPOPipeline", "orchestrator": "PPOOrchestrator",
            "input_size": 4, "gen_size": 48, "seed": 0,
        },
        "method": {
            "name": "ppoconfig", "num_rollouts": 8, "chunk_size": 8,
            "ppo_epochs": 1,
            "gen_kwargs": {"max_length": 48, "top_k": 0, "top_p": 1.0,
                           "do_sample": sample},
        },
    }


# --------------------------------------------------------------------- #
# 1. device
# --------------------------------------------------------------------- #


def ptxas_summary(text):
    """One line per compiled kernel from ``nvcc -Xptxas -v`` output: its
    short name (kernel and template arguments, from the mangled symbol),
    registers and, where not zero, spill bytes; and a line for each of
    ptxas's notes that it serialized a kernel's wgmma instructions."""
    out, name, spill = [], "?", ""
    for ln in text.splitlines():
        if "serialized" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
        m = re.search(r"Compiling entry function '_Z\w*?\d+([a-z_]+_kernel)"
                      r"I(\w*?)EEv", ln)
        if m:
            args = m.group(2)
            kind = {"f": ["f32"], "1": ["bf16"]}.get(args[:1], [])
            args = kind + re.findall(r"Li(\d+)", args)
            name, spill = f"{m.group(1)}<{', '.join(args)}>", ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and (m.group(1) != "0" or m.group(2) != "0"):
            spill = f", spills {m.group(1)} / {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} registers{spill}")
    return out


def flash_sass():
    """Each bf16 flash kernel instance of the built libraries, the forward
    and both backward kernels (symbol -> counts of its SASS opcodes, from
    ``cuobjdump -sass``): HGMMA (wgmma), UTMALDG (a TMA tile load) and
    HMMA (mma.sync, which none may hold)."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = "".join(subprocess.run(
        [tool, "-sass", str(_build.library_path(name))],
        capture_output=True, text=True, check=True).stdout
        for name in ("flash_forward", "flash_backward"))
    out, counts = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : \S*?(flash_(?:fwd|bwd)_\w+?_kernel)"
                      r"ILi(\d+)E", ln)
        if m:
            counts = out[f"{m.group(1)}<{m.group(2)}>"] = dict.fromkeys(
                ("HGMMA", "UTMALDG", "HMMA"), 0)
        elif "Function :" in ln:
            counts = None
        elif counts is not None:
            for op in counts:
                counts[op] += bool(re.search(rf"\b{op}\b", ln))
    return out


def paged_sass():
    """Each function of the paged-decode library (symbol -> counts of its
    SASS opcodes, from ``cuobjdump -sass``): UTMALDG (a TMA box load),
    UBLKCP (a bulk copy) and SYNCS (an mbarrier arrive or wait)."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run(
        [tool, "-sass", str(_build.library_path("paged_decode"))],
        capture_output=True, text=True, check=True).stdout
    out, counts = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            counts = out[m.group(1)] = dict.fromkeys(
                ("UTMALDG", "UBLKCP", "SYNCS"), 0)
        elif counts is not None:
            for op in counts:
                counts[op] += bool(re.search(rf"\b{op}\b", ln))
    return out


def check_paged_build():
    """The paged-decode library holds one kernel per instance (5 dtype
    pairs x 5 head dims x 3 head groups) and no other function (no
    combine kernel), each loading K/V by TMA (UTMALDG) or bulk copies
    (UBLKCP) and waiting on mbarriers (SYNCS); and the partition plan and
    least shared memory of each timed shape."""
    sass = paged_sass()
    per = {k: f"{c['UTMALDG']} / {c['UBLKCP']} / {c['SYNCS']}"
           for k, c in sass.items()}
    log("build", f"paged_decode SASS (cuobjdump -sass; UTMALDG / UBLKCP / "
                 f"SYNCS): {len(sass)} functions; e.g. " + "; ".join(
                     f"{k}: {v}" for k, v in sorted(per.items())[:3]))
    assert len(sass) == 75, sorted(sass)
    for k, c in sass.items():
        assert "paged_decode_kernel" in k and "combine" not in k, k
        assert (c["UTMALDG"] or c["UBLKCP"]) and c["SYNCS"], (k, c)
    for label, S, H, hd, max_pages, int8, _ in PAGED_SHAPES.values():
        P, per_p = decode_partitions(S, H, max_pages, 16)
        least = pa.shared_memory_bytes(
            H, H, hd, 16, per_p, torch.int8 if int8 else torch.bfloat16)
        log("build", f"paged_decode {label} (S {S}, H {H}, hd {hd}"
                     f"{', int8' if int8 else ''}): P={P} x {per_p} pages, "
                     f"{least} B of shared memory a block with a ring of "
                     f"one stage (the kernel deepens it)")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# 3. kernel checks and timings
# --------------------------------------------------------------------- #


def kernel_case(dev, seed=0):
    """tests/test_paged_kernel.py's _kernel_case geometry, fp32."""
    rng = np.random.default_rng(seed)
    S, H, Hkv, hd = 3, 4, 2, 16
    num_pages, page_size, max_pages = 10, 4, 3
    T = max_pages * page_size
    q = rng.standard_normal((S, H, hd))
    k = rng.standard_normal((num_pages, page_size, Hkv, hd))
    v = rng.standard_normal((num_pages, page_size, Hkv, hd))
    pt = np.asarray([[1, 3, SENT], [0, SENT, SENT], [5, 6, 7]], np.int32)
    lengths = np.asarray([6, 3, 12])
    bias = np.where(np.arange(T)[None, :] < lengths[:, None], 0.0, NEG_INF)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return (f32(q), f32(k), f32(v), torch.tensor(pt, device=dev),
            f32(bias))


def serving_case(dev, seed, S=16, H=12, Hkv=12, hd=64, page_size=16,
                 max_pages=4, lengths=None, free_row=None, copies=1,
                 dtype=torch.bfloat16):
    """Decode inputs (q and pools in ``dtype``, bf16 by default) at a
    serving geometry: each slot owns its own pages (shuffled), ragged
    lengths, sentinels past each slot's pages, and optionally one free
    row (all sentinel, all masked). ``copies`` distinct K/V pools (to
    time with a cold L2)."""
    rng = np.random.default_rng(seed)
    T = max_pages * page_size
    if lengths is None:
        lengths = rng.integers(1, T + 1, S)
    lengths = np.asarray(lengths)
    num_pages = S * max_pages
    perm = rng.permutation(num_pages).astype(np.int32)
    pt = np.full((S, max_pages), SENT, np.int32)
    for s in range(S):
        used = -(-int(lengths[s]) // page_size)
        pt[s, :used] = perm[s * max_pages:s * max_pages + used]
    bias = np.where(np.arange(T)[None, :] < lengths[:, None], 0.0, NEG_INF)
    if free_row is not None:
        pt[free_row] = SENT
        bias[free_row] = NEG_INF
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q = randn(S, H, hd)
    pools = [(randn(num_pages, page_size, Hkv, hd),
              randn(num_pages, page_size, Hkv, hd)) for _ in range(copies)]
    return (q, pools, torch.tensor(pt, device=dev),
            torch.tensor(bias, dtype=torch.float32, device=dev))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_kernel(dev):
    """The correctness checks; returns the largest error seen."""
    q, k, v, pt, bias = kernel_case(dev)
    out = paged_decode_attention(q, k, v, pt, bias)
    ref = paged_decode_attention_reference(q, k, v, pt, bias)
    torch.cuda.synchronize()
    err32 = max_err(out, ref)
    log("kernel", f"fp32 GQA+sentinels max_abs_err={err32:.3e} "
                  f"(atol 1e-5)")
    assert err32 <= 1e-5, "fp32 kernel disagrees with its plain version"

    q, k, v, pt, bias = kernel_case(dev, seed=1)
    kq, vq = quantize_kv(k), quantize_kv(v)
    out = paged_decode_attention(q, kq, vq, pt, bias)
    ref = paged_decode_attention_reference(q, kq, vq, pt, bias)
    torch.cuda.synchronize()
    err8 = max_err(out, ref)
    log("kernel", f"int8 tier max_abs_err={err8:.3e} (atol 1e-5)")
    assert err8 <= 1e-5, "int8 kernel disagrees with its plain version"

    q, ((k, v),), pt, bias = serving_case(dev, seed=2, free_row=5)
    out = paged_decode_attention(q, k, v, pt, bias)
    ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), "non-finite kernel output"
    errb = max_err(out, ref)
    bad = (out.float() - ref).abs() > 1e-2 + 1e-2 * ref.abs()
    log("kernel", f"bf16 serving shape (free row 5 finite) "
                  f"max_abs_err={errb:.3e} (atol 1e-2 + rtol 1e-2)")
    assert not bad.any(), "bf16 kernel disagrees with its plain version"
    return max(err32, err8, errb, check_split(dev))


def check_bf16_int8(dev):
    """The bf16-query x int8-pool instance the engine launches under
    ``kv_dtype: int8`` at bf16, against its plain version in float32
    math on the same inputs (atol 1e-2 + rtol 1e-2, every row finite):
    hd 64 (the serving shape, 16 slots x 4 pages of 16, row 5 free; and
    a 1024-token context, split-K, SPLIT_LENGTHS[16], row 14 free) and
    hd 256 (gpt-j's heads, the same two contexts). Returns the largest
    error at each head dim."""
    worst = {64: 0.0, 256: 0.0}
    for hd, H in ((64, 12), (256, 16)):
        for ctx, max_pages, lengths, free in (
                ("serving", 4, None, 5),
                ("1024-token", 64, SPLIT_LENGTHS[16], FREE_ROW[16])):
            q, ((k, v),), pt, bias = serving_case(
                dev, seed=80 + hd + max_pages, H=H, Hkv=H, hd=hd,
                max_pages=max_pages, lengths=lengths, free_row=free)
            kq, vq = quantize_kv(k), quantize_kv(v)
            out = paged_decode_attention(q, kq, vq, pt, bias)
            ref = paged_decode_attention_reference(q.float(), kq, vq, pt,
                                                   bias)
            torch.cuda.synchronize()
            assert out.dtype == torch.bfloat16
            assert torch.isfinite(out.float()).all(), f"non-finite hd {hd}"
            err = max_err(out, ref)
            worst[hd] = max(worst[hd], err)
            bad = (out.float() - ref).abs() > 1e-2 + 1e-2 * ref.abs()
            P, per = decode_partitions(16, H, max_pages, 16)
            log("kernel", f"bf16 q x int8 pool S=16 H=Hkv={H} hd={hd} "
                          f"{ctx} context (row {free} free): P={P} x {per} "
                          f"pages, max_abs_err={err:.3e} (atol 1e-2 + rtol "
                          f"1e-2 against float32 math; every row finite)")
            assert not bad.any(), \
                f"bf16 x int8 kernel (hd {hd}, {ctx}) disagrees"
    return worst


#: ragged lengths at a 1024-token context (pages of 16) for 16 and 8
#: slots: ending inside partitions, at their edges (352 and 704 for the
#: 16-slot planner's P = 3, multiples of 128 for the 8-slot P = 8) and
#: one token either side, short rows whose later partitions are dead,
#: and full rows; the slot at FREE_ROW[S] is a free row instead
SPLIT_LENGTHS = {
    16: [1, 16, 17, 127, 351, 352, 353, 500, 703, 704, 705, 1000, 1023,
         1024, 0, 1024],
    8: [1, 127, 128, 129, 640, 1023, 0, 1024],
}
FREE_ROW = {16: 14, 8: 6}


def check_split(dev):
    """Split-K paged decode at a 1024-token context against the plain
    version on the same inputs: bf16 MHA at the timed geometry and bf16
    GQA (H 8, Hkv 2), each with a free row, at atol 1e-2 + rtol 1e-2
    against float32 math; float32 (GQA, hd 128) and the int8 tier (float32
    q) at atol 1e-5. Every row must be finite. Returns the largest error
    seen."""
    worst = 0.0
    cases = (
        ("bf16 MHA", dict(S=16, H=12, Hkv=12, hd=64), torch.bfloat16, None),
        ("bf16 GQA", dict(S=8, H=8, Hkv=2, hd=64), torch.bfloat16, None),
        ("fp32 GQA", dict(S=8, H=8, Hkv=2, hd=128), torch.float32, None),
        ("int8 tier", dict(S=8, H=4, Hkv=2, hd=64), torch.float32, "int8"),
    )
    for i, (label, geo, dtype, tier) in enumerate(cases):
        S = geo["S"]
        lengths = SPLIT_LENGTHS[S]
        q, ((k, v),), pt, bias = serving_case(
            dev, seed=20 + i, max_pages=64, lengths=lengths,
            free_row=FREE_ROW[S], dtype=dtype, **geo)
        if tier == "int8":
            k, v = quantize_kv(k), quantize_kv(v)
        P, per = decode_partitions(S, geo["Hkv"], 64, 16)
        out = paged_decode_attention(q, k, v, pt, bias)
        ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
        torch.cuda.synchronize()
        assert out.dtype == q.dtype
        assert torch.isfinite(out.float()).all(), f"non-finite {label}"
        err = max_err(out, ref)
        worst = max(worst, err)
        if dtype == torch.bfloat16:
            ok = not ((out.float() - ref).abs()
                      > 1e-2 + 1e-2 * ref.abs()).any()
            tol = "atol 1e-2 + rtol 1e-2"
        else:
            ok, tol = err <= 1e-5, "atol 1e-5"
        log("kernel", f"split-K {label} S={S} H={geo['H']} Hkv={geo['Hkv']} "
                      f"hd={geo['hd']} 1024-token context, lengths "
                      f"{lengths} (row {FREE_ROW[S]} free): P={P} x {per} "
                      f"pages, max_abs_err={err:.3e} ({tol}; every row "
                      f"finite)")
        assert ok, f"split-K {label} disagrees with its plain version"
    return worst


def time_ms(fn, args_list, iters):
    """Mean ms per EAGER call over ``iters`` calls cycling ``args_list``
    (so a pool set larger than L2 is read cold), CUDA events, after
    warmup. Includes the host's launch cost where that exceeds the
    device's work."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fns, args_list, iters):
    """Device ms per call of each function: ``iters`` calls cycling
    ``args_list`` captured into one CUDA graph per function, so no host
    launch cost is timed. The graphs replay in turns (forward, then
    reversed) and each reading is the mean of its two replays."""
    # the warm-up's stream reuses no block the caching allocator holds
    # for another stream: hand back what the eager timings left cached
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for fn in fns:
            for a in args_list[:3]:
                fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for fn in fns:
        g = torch.cuda.CUDAGraph()
        with aotjit.collector_paused(), torch.cuda.graph(g):
            for i in range(iters):
                fn(*args_list[i % len(args_list)])
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    total = [0.0] * len(fns)
    order = list(range(len(fns)))
    for turn in (order, order[::-1]):
        for i in turn:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[i].replay()
            stop.record()
            torch.cuda.synchronize()
            total[i] += start.elapsed_time(stop) / iters
    del graphs
    return [t / 2 for t in total]


def library_attention(q, k_pages, v_pages, pt, bias):
    """The yardstick: clamp-gather to logical order (an int8 pool's codes
    and scales, dequantized to q's dtype), then one
    scaled_dot_product_attention call (the port never calls this)."""
    S, H, hd = q.shape
    int8 = isinstance(k_pages, tuple)
    num_pages, ps, Hkv, _ = (k_pages[0] if int8 else k_pages).shape
    ctx = pt.long().clamp(0, num_pages - 1)

    def gather(pages):
        if int8:
            return (pages[0][ctx].to(q.dtype)
                    * pages[1][ctx][..., None].to(q.dtype))
        return pages[ctx]

    k = gather(k_pages).reshape(S, -1, Hkv, hd).transpose(1, 2)
    v = gather(v_pages).reshape(S, -1, Hkv, hd).transpose(1, 2)
    gqa = {"enable_gqa": True} if Hkv != H else {}
    out = F.scaled_dot_product_attention(
        q[:, :, None, :], k, v,
        attn_mask=bias[:, None, None, :].to(q.dtype), **gqa,
    )
    return out[:, :, 0, :]


def bound(q, k_pages, pt, bias):
    """Least time the card could take (ms): bytes each input needs read
    once (K/V of the pages holding any unmasked position) and the output
    written once, over HBM bandwidth, vs the score + weighted-sum FLOPs
    of those positions over the bf16 peak."""
    S, H, hd = q.shape
    int8 = isinstance(k_pages, tuple)
    _, ps, Hkv, _ = (k_pages[0] if int8 else k_pages).shape
    live_pages = int((bias.reshape(S, -1, ps) > NEG_INF / 2).any(-1).sum())
    # an int8 row is hd one-byte codes and one float32 scale
    row = hd + 4 if int8 else hd * k_pages.element_size()
    kv = 2 * live_pages * ps * Hkv * row
    io = 2 * q.numel() * q.element_size() + pt.numel() * 4 \
        + bias.numel() * 4
    flops = 4 * H * hd * live_pages * ps
    by_bytes = (kv + io) / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), kv + io


def time_kernel(dev, label, max_pages, iters, H=12, hd=64, int8=False,
                S=16):
    """Kernel / plain / yardstick times at a full-length bf16 geometry
    (``S`` slots, H heads of ``hd``, MHA; ``int8``: bf16 q over an int8
    pool), cycling enough pool copies to exceed the 50 MB L2."""
    pool_bytes = 2 * S * max_pages * 16 * H * (hd + 4 if int8 else 2 * hd)
    copies = max(1, math.ceil(120e6 / pool_bytes))
    q, pools, pt, bias = serving_case(
        dev, seed=3, S=S, max_pages=max_pages, lengths=[max_pages * 16] * S,
        copies=copies, H=H, Hkv=H, hd=hd,
    )
    if int8:
        pools = [(quantize_kv(k), quantize_kv(v)) for k, v in pools]
        label += " (bf16 q, int8 pool)"
    args = [(q, k, v, pt, bias) for k, v in pools]
    fns = (paged_decode_attention, paged_decode_attention_reference,
           library_attention)
    eager = [time_ms(fn, args, iters) for fn in fns]
    ms, plain, lib = graph_ms(fns, args, iters)
    b_ms, b_by, nbytes = bound(q, pools[0][0], pt, bias)
    log("kernel", f"{label}: S={S} H=Hkv={H} hd={hd} ps=16 max_pages="
                  f"{max_pages} bf16, {nbytes / 1e6:.2f} MB, {copies} pool "
                  f"copies cycled; device (CUDA graph): kernel "
                  f"{ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
                  f"gather+SDPA {lib * 1e3:.2f} us; eager loop: kernel "
                  f"{eager[0] * 1e3:.2f} us, plain {eager[1] * 1e3:.2f} us, "
                  f"gather+SDPA {eager[2] * 1e3:.2f} us; bound "
                  f"{b_ms * 1e3:.3f} us ({b_by})")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": b_ms, "bound_by": b_by, "eager_ms": eager[0],
            "eager_plain_ms": eager[1], "eager_library_ms": eager[2]}


def sweep_partitions(dev, iters=200, counts=(1, 2, 3, 4, 6, 8), H=12,
                     hd=64, max_pages=64):
    """Device time of paged decode at a full context of ``max_pages``
    pages of 16 (the time_kernel geometry) for each partition count, in
    one call, so the planner's choice stands beside the others."""
    pool_bytes = 2 * 16 * max_pages * 16 * H * hd * 2
    q, pools, pt, bias = serving_case(
        dev, seed=3, max_pages=max_pages, lengths=[max_pages * 16] * 16,
        copies=max(1, math.ceil(120e6 / pool_bytes)), H=H, Hkv=H, hd=hd)
    args = [(q, k, v, pt, bias) for k, v in pools]
    # the partition counts that cut the pages into parts with none empty
    counts = [P for P in counts
              if P <= max_pages and (P - 1) * -(-max_pages // P) < max_pages]
    fns = [lambda *a, P=P: pa._launch(*a, partitions=P) for P in counts]
    times = graph_ms(fns, args, iters)
    chosen = decode_partitions(16, H, max_pages, 16)[0]
    log("kernel", f"H={H} hd={hd} {max_pages * 16}-token context by "
                  f"partition count P (device, CUDA graph): " + ", ".join(
                      f"P={P} {t * 1e3:.2f} us"
                      for P, t in zip(counts, times))
        + f"; the planner picks P={chosen}")
    return dict(zip(counts, times))


#: paged decode's timed shapes, bf16 q, full-length rows, pages of 16:
#: key -> (label, slots, H = Hkv, hd, max_pages, int8 pool, iterations);
#: the tp shards (SHARD_SHAPES) are added at the serving context
PAGED_SHAPES = {
    "serving": ("serving shape", 16, 12, 64, 4, False, 500),
    "ctx1024": ("1024-token context", 16, 12, 64, 64, False, 200),
    "gptj_serving": ("gpt-j serving shape", 16, 16, 256, 4, False, 500),
    "gptj_ctx1024": ("gpt-j 1024-token context", 16, 16, 256, 64, False,
                     200),
    "int8_serving": ("serving shape", 16, 12, 64, 4, True, 500),
    "gptj_int8_serving": ("gpt-j serving shape", 16, 16, 256, 4, True, 500),
    "stream4096": ("one 4096-token stream", 1, 12, 64, 256, False, 200),
}


def check_partitions(dev):
    """Every partition count P = 1 to 8 (the cluster's blocks) at a
    1024-token context (16 slots, SPLIT_LENGTHS[16], row 14 free) and
    one slot's 4096-token stream beside a free slot (H = Hkv 12, hd 64),
    bf16, against the plain version in float32 math (atol 2e-3 + rtol
    1e-2: these rows average hundreds to thousands of values, so most
    outputs are a few hundredths, and one bf16 rounding of such a value
    is about 1e-4; every row finite); the stream also at the planner's P.
    Returns the largest error."""
    worst = 0.0
    long = serving_case(dev, seed=40, max_pages=64, lengths=SPLIT_LENGTHS[16],
                        free_row=FREE_ROW[16])
    stream = serving_case(dev, seed=41, S=2, max_pages=256,
                          lengths=[4096, 0], free_row=1)
    for label, (q, ((k, v),), pt, bias) in (("1024-token", long),
                                            ("4096-token stream", stream)):
        ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
        errs = {}
        for P in (None, 1, 2, 3, 4, 5, 6, 7, 8):
            out = pa._launch(q, k, v, pt, bias, partitions=P)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), (label, P)
            errs[P or "planner"] = max_err(out, ref)
            bad = (out.float() - ref).abs() > 2e-3 + 1e-2 * ref.abs()
            assert not bad.any(), f"paged decode {label} P={P} disagrees"
        worst = max(worst, *errs.values())
        log("kernel", f"partition sweep, {label} context, bf16: max_abs_err "
                      + ", ".join(f"P={P} {e:.3e}" for P, e in errs.items())
                      + " (atol 2e-3 + rtol 1e-2 against float32 math; "
                        "every row finite)")
    return worst


def check_graph_replay(dev):
    """The kernel captured in a CUDA graph after a scatter into the pool
    (the serve step's order; a cluster launch through cudaLaunchKernelEx
    with its tensor maps passed by value): a replay equals the eager call
    bit for bit, and after the scatter's source changes a second replay
    reads the new pool."""
    q, ((k, v),), pt, bias = serving_case(dev, seed=43, free_row=5)
    rows = torch.arange(0, k.shape[0], 2, device=dev)
    src = torch.randn((rows.numel(),) + tuple(k.shape[1:]), device=dev,
                      dtype=k.dtype)

    def step():
        k.index_copy_(0, rows, src)
        return paged_decode_attention(q, k, v, pt, bias)

    eager = step().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with aotjit.collector_paused(), torch.cuda.graph(graph):
        out = step()
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, eager)
    src.copy_(torch.randn_like(src))
    graph.replay()
    fresh = step()
    torch.cuda.synchronize()
    moved = not torch.equal(fresh, eager)
    log("kernel", f"CUDA graph (scatter, then the kernel): replay == eager "
                  f"bit for bit {same}; after the pool changed, the replay "
                  f"== eager on the new pool {torch.equal(out, fresh)} "
                  f"(output moved {moved})")
    assert same and moved and torch.equal(out, fresh), "graph replay"
    del graph


def time_paged_shapes(dev):
    """time_kernel at every timed shape: PAGED_SHAPES and the tp shards
    at the serving context."""
    shapes = dict(PAGED_SHAPES)
    for H, hd in SHARD_SHAPES:
        shapes[f"H{H}_hd{hd}"] = ("tp shard serving shape", 16, H, hd, 4,
                                  False, 500)
    return {key: time_kernel(dev, label, max_pages, iters, H=H, hd=hd,
                             int8=int8, S=S)
            for key, (label, S, H, hd, max_pages, int8, iters)
            in shapes.items()}


#: the PPO TL;DR rollout's decode attention at gpt-j width: B rows of a
#: dense cache of S = P + 64 keys, H = Hkv heads of hd, bf16, timed at
#: the step that writes key P + 32
ROLLOUT_SHAPE = dict(B=32, S=576, H=16, hd=256, P=512)
#: the page sizes the rollout decoder may view its cache in
ROLLOUT_PAGES = (16, 32, 64)


def rollout_case(dev, seed, full, copies=2):
    """(q [B, H, hd], ``copies`` dense (K, V) caches [B, S, H, hd], the
    step's bias [B, 1, 1, S]) at ROLLOUT_SHAPE, bf16, as the rollout
    decoder holds them: every key live (``full``) or the cell's prompts
    (192-512 tokens left-padded to P), keys past the step masked."""
    B, S, H, hd, P = (ROLLOUT_SHAPE[k] for k in ("B", "S", "H", "hd", "P"))
    rng = np.random.default_rng(seed)
    lengths = np.full(B, P) if full else rng.integers(192, P + 1, B)
    keys = np.arange(S)[None, :]
    last = S - 1 if full else P + 32
    live = (keys >= P - lengths[:, None]) & (keys <= last)
    bias = torch.tensor(np.where(live, 0.0, NEG_INF), dtype=torch.float32,
                        device=dev)[:, None, None, :]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q = randn(B, H, hd)
    caches = [(randn(B, S, H, hd), randn(B, S, H, hd))
              for _ in range(copies)]
    return q, caches, bias


def time_rollout_decode(dev, iters=50):
    """The rollout decoder's step attention at ROLLOUT_SHAPE: the kernel
    over the dense cache viewed as pages of each of ROLLOUT_PAGES (the
    decoder's page table), and the plain ``attention_scores`` the step
    ran before (its einsums, and the head-major copies of K and V they
    make, included); each against the plain version in float32 math on
    the same inputs (atol 1e-2 + rtol 1e-2, every row finite), timed by
    CUDA-graph replay over two caches (604 MB, past the L2) beside the
    bound of the pages with a live key, with every key live and with
    the cell's left-padded prompts. Returns {case: {ps or "plain":
    {"us", "bound_us"}}}."""
    B, S, H, hd = (ROLLOUT_SHAPE[k] for k in ("B", "S", "H", "hd"))
    out = {}
    for case, full in (("full", True), ("padded", False)):
        q, caches, bias = rollout_case(dev, seed=7, full=full)
        bias_row = bias.reshape(B, S).contiguous()
        k0, v0 = caches[0]
        ref = attention_scores(q.float()[:, None], k0.float(), v0.float(),
                               bias)[:, 0]
        fns, keys, bounds = [], [], []
        for ps in ROLLOUT_PAGES:
            pt = torch.arange(B * (S // ps), dtype=torch.int32,
                              device=dev).view(B, S // ps)

            def kernel(q, k, v, pt=pt, ps=ps):
                pages = (-1, ps, H, hd)
                return paged_decode_attention(q, k.view(pages),
                                              v.view(pages), pt, bias_row)

            got = kernel(q, k0, v0)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), ps
            bad = (got.float() - ref).abs() > 1e-2 + 1e-2 * ref.abs()
            assert not bad.any(), f"rollout decode, pages of {ps}, {case}"
            fns.append(kernel)
            keys.append(ps)
            bounds.append(bound(q, k0.view(-1, ps, H, hd), pt, bias_row)[0])

        def plain(q, k, v):
            return attention_scores(q[:, None], k, v, bias)[:, 0]

        err = max_err(plain(q, k0, v0), ref)
        assert err < 5e-2, f"rollout plain attention, {case}: {err}"
        fns.append(plain)
        keys.append("plain")
        bounds.append(bounds[0])
        times = graph_ms(fns, [(q, k, v) for k, v in caches], iters)
        out[case] = {key: {"us": t * 1e3, "bound_us": b * 1e3}
                     for key, t, b in zip(keys, times, bounds)}
        log("kernel", f"rollout decode, {case} rows (B {B}, {S} keys, H = "
                      f"Hkv {H}, hd {hd}, bf16; device, CUDA graph): "
                      + ", ".join(f"pages of {key} {t * 1e3:.2f} us "
                                  f"(bound {b * 1e3:.2f})"
                                  for key, t, b in zip(keys[:-1], times,
                                                       bounds))
                      + f"; plain attention_scores with its copies "
                        f"{times[-1] * 1e3:.2f} us")
    return out


def paged_phase(dev):
    """Phase 3: every paged-decode check against the plain version (the
    partition sweep and a graph replay included), then every timed shape
    (PAGED_SHAPES and the tp shards), the rollout decoder's attention
    (time_rollout_decode) and the partition sweeps' times. Returns
    (largest errors, times by shape key, sweeps)."""
    errs = {"kernel": check_kernel(dev), "gptj": check_paged_gptj(dev),
            "int8": check_bf16_int8(dev), "shards": check_shards(dev),
            "partitions": check_partitions(dev)}
    check_graph_replay(dev)
    times = time_paged_shapes(dev)
    times["rollout"] = time_rollout_decode(dev)
    sweeps = {"ctx1024": sweep_partitions(dev),
              "gptj_serving": sweep_partitions(dev, H=16, hd=256,
                                               max_pages=4),
              "gptj_ctx1024": sweep_partitions(dev, H=16, hd=256,
                                               max_pages=64)}
    return errs, times, sweeps


def paged_decode_only(times_only=False):
    """``chip_smoke.py --paged-decode``: phases 1-3 for paged decode
    alone (its build, checks and times), then one JSON line of the times;
    the quick card run while the kernel changes. ``--paged-times``
    (``times_only``): the build and the timed shapes alone, through the
    public wrapper only, so this script times an earlier tree's kernel
    too (run from that tree's root) beside the current one in one call.
    ``--rollout-decode`` (``times_only="rollout"``): the build and the
    rollout decoder's attention alone (time_rollout_decode)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log("device", f"{card}; torch {torch.__version__} cuda "
                  f"{torch.version.cuda}")
    for name, entry in _build.build(("paged_decode",)).items():
        log("build", f"{name}: {entry['seconds']:.2f}s nvcc")
        for ln in ptxas_summary(str(entry["log"])):
            log("build", f"  {ln}")
    if times_only == "rollout":
        print(json.dumps({"card": card,
                          "rollout": time_rollout_decode("cuda")}))
        return 0
    if times_only:
        print(json.dumps({"card": card, "times": time_paged_shapes("cuda")}))
        return 0
    check_paged_build()
    errs, times, sweeps = paged_phase("cuda")
    print(json.dumps({"card": card, "errs": errs, "times": times,
                      "sweeps": sweeps}))
    return 0


# --------------------------------------------------------------------- #
# 4. flash attention: checks and timings
# --------------------------------------------------------------------- #

FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: the whole backward seam (dq, which computes D, then dk/dv) timed
#: beside SDPA's backward
SEAM = "flash_bwd (seam)"
#: the source of each flash kernel on the bf16 training path
FLASH_SOURCES = {
    "flash_fwd": "trlx_tpu_torch/csrc/flash_forward.cu",
    "flash_bwd_dq": "trlx_tpu_torch/csrc/flash_backward.cu",
    "flash_bwd_dkv": "trlx_tpu_torch/csrc/flash_backward.cu",
}
FLASH_REPLACES = {
    "flash_fwd": "trlx_tpu/ops/pallas_attention.py:42",
    "flash_bwd_dq": "trlx_tpu/ops/pallas_attention.py:204",
    "flash_bwd_dkv": "trlx_tpu/ops/pallas_attention.py:265",
}


def flash_case(dev, B, T, H, hd, pads=(), dtype=torch.float32, seed=0,
               lengths=None):
    """q, k, v, dO [B, T, H, hd] and the [B, T] int32 mask with ``pads``
    left-pad tokens per row, or with ``lengths`` the ILQL layout: row i
    right-padded past ``lengths[i]`` tokens and its terminal slot
    (``lengths[i] - 1``) zeroed. dO is 0 on pad rows, as the trainer's
    losses (which never read pad rows) make it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn((B, T, H, hd), generator=gen, device=dev)
                  for _ in range(4))
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    g = g * mask[:, :, None, None]
    if lengths is not None:
        mask.zero_()
        g = torch.randn((B, T, H, hd), generator=gen, device=dev)
        for i, n in enumerate(lengths):
            mask[i, :n - 1] = 1
            g[i, n:] = 0
    return tuple(x.to(dtype) for x in (q, k, v, g)) + (mask,)


def live_rows(mask):
    """[B, T] query rows that see at least one real key: all but a left
    pad (which the kernels give a different finite average)."""
    return mask.cumsum(1) > 0


def flash_errors(q, k, v, g, mask, causal):
    """The kernels (through the autograd seam) against the dense oracle
    and its autograd in fp32 on the same inputs: (out, reference out,
    {kernel: max abs error}, kernel leaves, reference leaves); O and lse
    compare on live rows."""
    real = live_rows(mask)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, mask, causal)
    out.backward(g)
    _, lse = fa.flash_fwd(q, k, v, mask, causal)
    refs = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = fa.flash_attention_reference(*refs, mask, causal)
    ref.backward(g.float())
    _, lse_ref = fa.flash_fwd_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), "non-finite flash output"
    for x in leaves:
        assert torch.isfinite(x.grad.float()).all(), "non-finite gradient"
    errs = {
        "flash_fwd": max(
            max_err(out.detach()[real], ref.detach()[real]),
            max_err(lse.permute(0, 2, 1)[real],
                    lse_ref.permute(0, 2, 1)[real])),
        "flash_bwd_dq": max_err(leaves[0].grad, refs[0].grad),
        "flash_bwd_dkv": max(max_err(leaves[1].grad, refs[1].grad),
                             max_err(leaves[2].grad, refs[2].grad)),
    }
    return out.detach(), ref.detach(), errs, leaves, refs


def ratio(a, b):
    """Largest |a - b| / (1e-2 + 1e-2 |b|), in float32; <= 1 passes."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (1e-2 + 1e-2 * b.abs())).max().item()


def bf16_backward_check(q, k, v, g, mask, causal):
    """The bf16 backward kernels against their plain versions on the same
    bf16 q, k, v, dO, O and lse (the forward kernel's): ({dq, dk, dv:
    ratio}, {kernel: max abs error}). Every output must be finite and in
    q's dtype, and the dq kernel's D must equal softmax_jacobian_diag at
    atol 1e-5 (its error counts as dq's when larger)."""
    out, lse = fa.flash_fwd(q, k, v, mask, causal)
    dq, dD = fa.flash_bwd_dq(q, k, v, g, out, lse, mask, causal)
    got = dict(zip(("dq", "dk", "dv"), (
        dq, *fa.flash_bwd_dkv(q, k, v, g, lse, dD, mask, causal))))
    dq_ref, d_ref = fa.flash_bwd_dq_reference(q, k, v, g, out, lse, mask,
                                              causal)
    want = dict(zip(("dq", "dk", "dv"), (
        dq_ref,
        *fa.flash_bwd_dkv_reference(q, k, v, g, lse, d_ref, mask, causal))))
    torch.cuda.synchronize()
    for n, x in got.items():
        assert x.dtype == q.dtype, f"{n} in {x.dtype}, not {q.dtype}"
        assert torch.isfinite(x.float()).all(), f"non-finite bf16 {n}"
    d_err = max_err(dD, d_ref)
    assert d_err <= 1e-5, f"the dq kernel's D disagrees: {d_err:.3e}"
    errs = {"flash_bwd_dq": max(max_err(got["dq"], want["dq"]), d_err),
            "flash_bwd_dkv": max(max_err(got[n], want[n])
                                 for n in ("dk", "dv"))}
    return {n: ratio(got[n], want[n]) for n in got}, errs


def bf16_forward_check(q, k, v, mask, causal):
    """The bf16 forward kernel against its plain version on the same bf16
    inputs: (O ratio on real rows, lse max abs error on real rows, O max
    abs error on real rows). Every row of O and lse must be finite."""
    real = live_rows(mask)
    out, lse = fa.flash_fwd(q, k, v, mask, causal)
    ref, lse_ref = fa.flash_fwd_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype, f"O in {out.dtype}, not {q.dtype}"
    assert torch.isfinite(out.float()).all(), "non-finite bf16 O"
    assert torch.isfinite(lse).all(), "non-finite bf16 lse"
    lse_err = max_err(lse.permute(0, 2, 1)[real], lse_ref.permute(0, 2, 1)[real])
    return ratio(out[real], ref[real]), lse_err, max_err(out[real], ref[real])


#: ILQL-layout rows for the flash checks at T 500 (the store-global
#: longest row, then ragged ones ending inside and at 64-row tiles)
ILQL_CHECK_LENGTHS = [500, 130, 257, 449]


def check_flash(dev):
    """fp32 (causal with left padding at T 52, 576 and 130, non-causal)
    at atol 1e-5 (O, lse) / 2e-4 (gradients); bf16 backward kernels at hd
    16 / 32 / 64 / 128, T 130 causal with a fully left-padded row and T 96
    non-causal; ILQL's right-padded, terminal-holed mask at T 500 in fp32
    (against the dense oracle) and bf16; and the whole bf16 path at the
    training shape, at
    atol 1e-2 + rtol 1e-2 (O on real rows, dq, dk, dv), each kernel
    against its plain version on the same inputs. Returns the largest
    error seen per kernel."""
    worst = dict.fromkeys(FLASH_NAMES, 0.0)
    for B, T, H, hd, pads, causal in (
            (4, 52, 2, 16, (0, 5, 11, 17), True),
            (4, 576, 2, 64, (0, 5, 11, 17), True),
            (2, 130, 3, 128, (0, 70), True),
            (2, 48, 2, 32, (0, 9), False)):
        case = flash_case(dev, B, T, H, hd, pads, seed=T)
        _, _, errs, _, _ = flash_errors(*case, causal)
        log("flash", f"fp32 B{B} T{T} H{H} hd{hd} pads {list(pads)} "
                     f"causal={causal}: " + ", ".join(
                         f"{n} {e:.3e}" for n, e in errs.items())
            + " (atol 1e-5 fwd, 2e-4 grads)")
        assert errs["flash_fwd"] <= 1e-5, "flash forward disagrees (fp32)"
        assert errs["flash_bwd_dq"] <= 2e-4, "flash dq disagrees (fp32)"
        assert errs["flash_bwd_dkv"] <= 2e-4, "flash dk/dv disagrees (fp32)"
        worst = {n: max(worst[n], errs[n]) for n in worst}
    # the bf16 kernels (tensor cores) at every head dim the wrappers
    # take: the forward rounds P to bf16 before P V (2^-9 relative), the
    # backward splits P and dS into bf16 hi + lo pairs (2^-17), and every
    # output is rounded once to bf16
    for hd in fa.HEAD_DIMS:
        for B, T, H, pads, causal in ((3, 130, 2, (0, 130, 17), True),
                                      (2, 96, 2, (0, 9), False)):
            case = flash_case(dev, B, T, H, hd, pads, torch.bfloat16,
                              seed=T + hd)
            o_ratio, lse_err, o_err = bf16_forward_check(
                *case[:3], case[4], causal)
            log("flash", f"bf16 forward B{B} T{T} H{H} hd{hd} pads "
                         f"{list(pads)} causal={causal} vs its plain "
                         f"version: O max_abs_err {o_err:.3e}, largest "
                         f"|err| / (1e-2 + 1e-2 |ref|) {o_ratio:.3f} (<= 1 "
                         f"passes), lse max_abs_err {lse_err:.3e} (atol "
                         f"1e-3); every row finite")
            assert o_ratio <= 1.0, f"bf16 flash forward O disagrees (hd {hd})"
            assert lse_err <= 1e-3, f"bf16 flash forward lse disagrees (hd {hd})"
            worst["flash_fwd"] = max(worst["flash_fwd"], o_err)
            ratios, errs = bf16_backward_check(*case, causal)
            log("flash", f"bf16 backward B{B} T{T} H{H} hd{hd} pads "
                         f"{list(pads)} causal={causal}, each kernel vs "
                         f"its plain version: " + ", ".join(
                             f"{n} {e:.3e}" for n, e in errs.items())
                + "; largest |err| / (1e-2 + 1e-2 |ref|): " + ", ".join(
                    f"{n} {r:.3f}" for n, r in ratios.items())
                + " (<= 1 passes; every row finite)")
            for name, r in ratios.items():
                assert r <= 1.0, f"bf16 flash {name} disagrees (hd {hd})"
            worst = {n: max(worst[n], errs.get(n, 0.0)) for n in worst}
    # ILQL's layout: right padding and a masked terminal slot (a hole in
    # the key mask, not a prefix), T 500 not a multiple of the 64-row tile
    for dtype, B, H, lengths in ((torch.float32, 4, 2, ILQL_CHECK_LENGTHS),
                                 (torch.bfloat16, 3, 2,
                                  ILQL_CHECK_LENGTHS[1:])):
        case = flash_case(dev, B, 500, H, 64, dtype=dtype, seed=77,
                          lengths=lengths)
        if dtype == torch.float32:
            _, _, errs, _, _ = flash_errors(*case, True)
            log("flash", f"fp32 ILQL mask B{B} T500 H{H} hd64, lengths "
                         f"{lengths} (terminal slots masked): " + ", ".join(
                             f"{n} {e:.3e}" for n, e in errs.items())
                + " (atol 1e-5 fwd, 2e-4 grads)")
            assert errs["flash_fwd"] <= 1e-5, "ILQL-mask forward (fp32)"
            assert errs["flash_bwd_dq"] <= 2e-4, "ILQL-mask dq (fp32)"
            assert errs["flash_bwd_dkv"] <= 2e-4, "ILQL-mask dk/dv (fp32)"
        else:
            o_ratio, lse_err, o_err = bf16_forward_check(
                *case[:3], case[4], True)
            ratios, errs = bf16_backward_check(*case, True)
            errs["flash_fwd"] = o_err
            log("flash", f"bf16 ILQL mask B{B} T500 H{H} hd64, lengths "
                         f"{lengths}, each kernel vs its plain version: "
                         + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                         + f"; ratio O {o_ratio:.3f}, " + ", ".join(
                             f"{n} {r:.3f}" for n, r in ratios.items())
                         + f" (<= 1 passes), lse max_abs_err {lse_err:.3e} "
                           f"(atol 1e-3); every row finite")
            assert o_ratio <= 1.0 and lse_err <= 1e-3, "ILQL-mask bf16 fwd"
            for name, r in ratios.items():
                assert r <= 1.0, f"ILQL-mask bf16 {name} disagrees"
        worst = {n: max(worst[n], errs[n]) for n in worst}
    B, T = 32, 576
    pads = list(range(0, 512, 16))  # 0 ... 496 left-pad tokens
    case = flash_case(dev, B, T, 12, 64, pads, torch.bfloat16, seed=9)
    out, ref, seam_errs, leaves, refs = flash_errors(*case, True)
    real = case[-1].bool()
    # each kernel against its plain version on the same inputs (the bf16
    # q, k, v, dO and the forward's lse and D), outputs in q's dtype as
    # the seam returns them
    ratios, errs = bf16_backward_check(*case, True)
    ratios = {"O": ratio(out[real], ref[real]), **ratios}
    errs = {"flash_fwd": seam_errs["flash_fwd"], **errs}
    # the seam against float32 autograd also carries D = rowsum(dO O)
    # over the bf16-rounded O, as trlx_tpu/ops/pallas_attention.py:356
    # computes it: printed, not held to the kernels' tolerance
    seam = {f"d{x}": ratio(a.grad, b.grad)
            for x, a, b in zip("qkv", leaves, refs)}
    log("flash", f"bf16 B{B} T{T} H12 hd64 causal, left pads 0..496, each "
                 f"kernel vs its plain version on the same inputs: "
                 + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                 + "; largest |err| / (1e-2 + 1e-2 |ref|): "
                 + ", ".join(f"{n} {r:.3f}" for n, r in ratios.items())
                 + " (<= 1 passes; every row finite). Seam vs float32 "
                 "autograd: " + ", ".join(
                     f"{n} {e:.3e}" for n, e in seam_errs.items()
                     if n != "flash_fwd")
                 + ", ratio " + ", ".join(f"{n} {r:.3f}"
                                          for n, r in seam.items()))
    for name, r in ratios.items():
        assert r <= 1.0, f"bf16 flash {name} disagrees"
    return {n: max(worst[n], errs[n]) for n in worst}


def check_flash_at(dev, label, B, T, lengths, H=12, hd=64):
    """The bf16 kernels at a main-path shape with ILQL's layout (see
    flash_case), each against its plain version on the same inputs: O
    and dq / dk / dv at atol 1e-2 + rtol 1e-2, lse at atol 1e-3, every
    row finite. Returns {kernel: max abs error}."""
    case = flash_case(dev, B, T, H, hd, dtype=torch.bfloat16, seed=T + 3,
                      lengths=lengths)
    o_ratio, lse_err, o_err = bf16_forward_check(*case[:3], case[4], True)
    ratios, errs = bf16_backward_check(*case, True)
    errs = {"flash_fwd": o_err, **errs}
    log("flash", f"bf16 {label} B{B} T{T} H{H} hd{hd} causal, each kernel "
                 f"vs its plain version: " + ", ".join(
                     f"{n} {e:.3e}" for n, e in errs.items())
        + f"; largest |err| / (1e-2 + 1e-2 |ref|): O {o_ratio:.3f}, "
        + ", ".join(f"{n} {r:.3f}" for n, r in ratios.items())
        + f" (<= 1 passes), lse max_abs_err {lse_err:.3e} (atol 1e-3); "
          f"every row finite")
    assert o_ratio <= 1.0, f"bf16 flash forward O disagrees ({label})"
    assert lse_err <= 1e-3, f"bf16 flash forward lse disagrees ({label})"
    for name, r in ratios.items():
        assert r <= 1.0, f"bf16 flash {name} disagrees ({label})"
    del case
    torch.cuda.empty_cache()
    return errs


#: gpt-j-6B at configs/ppo_tldr.yml's shape: B 8, T 512 + 64, 16 heads of
#: 256; left padding as the TL;DR prompts have it
GPTJ_FLASH = dict(B=8, T=576, H=16, hd=256)
GPTJ_PADS = [0, 5, 64, 100, 255, 300, 449, 511]


def check_flash_gptj(dev):
    """The flash kernels at gpt-j-6B's head dim on the TL;DR shape
    (:data:`GPTJ_FLASH`, causal, left padding): bf16, each kernel against
    its plain version on the same inputs (O, dq, dk, dv at atol 1e-2 +
    rtol 1e-2, lse at atol 1e-3, every row finite); fp32 against the
    dense oracle and its autograd (O and lse at 1e-5, gradients at
    2e-4). Returns {kernel: max abs error}."""
    g = GPTJ_FLASH
    label = f"B{g['B']} T{g['T']} H{g['H']} hd{g['hd']} causal, left pads " \
        f"{GPTJ_PADS}"
    case = flash_case(dev, g["B"], g["T"], g["H"], g["hd"], GPTJ_PADS,
                      torch.bfloat16, seed=256)
    o_ratio, lse_err, o_err = bf16_forward_check(*case[:3], case[4], True)
    ratios, errs = bf16_backward_check(*case, True)
    errs["flash_fwd"] = o_err
    log("flash", f"gpt-j bf16 {label}, each kernel vs its plain version: "
                 + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                 + f"; largest |err| / (1e-2 + 1e-2 |ref|): O "
                 f"{o_ratio:.3f}, " + ", ".join(
                     f"{n} {r:.3f}" for n, r in ratios.items())
                 + f" (<= 1 passes), lse max_abs_err {lse_err:.3e} (atol "
                   f"1e-3); every row finite")
    assert o_ratio <= 1.0 and lse_err <= 1e-3, "gpt-j bf16 flash forward"
    for name, r in ratios.items():
        assert r <= 1.0, f"gpt-j bf16 flash {name} disagrees"
    del case
    case = flash_case(dev, g["B"], g["T"], g["H"], g["hd"], GPTJ_PADS,
                      seed=257)
    errs32 = flash_errors(*case, True)[2]
    log("flash", f"gpt-j fp32 {label} vs the dense oracle and autograd: "
                 + ", ".join(f"{n} {e:.3e}" for n, e in errs32.items())
                 + " (atol 1e-5 fwd, 2e-4 grads)")
    assert errs32["flash_fwd"] <= 1e-5, "gpt-j flash forward (fp32)"
    assert errs32["flash_bwd_dq"] <= 2e-4, "gpt-j flash dq (fp32)"
    assert errs32["flash_bwd_dkv"] <= 2e-4, "gpt-j flash dk/dv (fp32)"
    del case
    torch.cuda.empty_cache()
    return {n: max(errs[n], errs32[n]) for n in FLASH_NAMES}


def check_paged_gptj(dev):
    """Paged decode at gpt-j-6B's heads (H = Hkv = 16, hd 256) against
    its plain version: 16 slots at the serving context (4 pages of 16,
    ragged, row 5 free; one partition) and at a 1024-token context
    (split-K, the ragged lengths of SPLIT_LENGTHS[16], row 14 free): bf16
    at atol 1e-2 + rtol 1e-2 against float32 math, float32 and the int8
    tier at atol 1e-5, every row finite. Returns the largest error."""
    worst = 0.0
    for ctx, max_pages, lengths, free in (
            ("serving", 4, None, 5),
            ("1024-token", 64, SPLIT_LENGTHS[16], FREE_ROW[16])):
        for i, (tier, dtype) in enumerate((("bf16", torch.bfloat16),
                                           ("fp32", torch.float32),
                                           ("int8", torch.float32))):
            q, ((k, v),), pt, bias = serving_case(
                dev, seed=60 + i + max_pages, H=16, Hkv=16, hd=256,
                max_pages=max_pages, lengths=lengths, free_row=free,
                dtype=dtype)
            if tier == "int8":
                k, v = quantize_kv(k), quantize_kv(v)
            out = paged_decode_attention(q, k, v, pt, bias)
            ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
            torch.cuda.synchronize()
            assert out.dtype == q.dtype
            assert torch.isfinite(out.float()).all(), f"non-finite {tier}"
            err = max_err(out, ref)
            worst = max(worst, err)
            if tier == "bf16":
                ok = not ((out.float() - ref).abs()
                          > 1e-2 + 1e-2 * ref.abs()).any()
                tol = "atol 1e-2 + rtol 1e-2"
            else:
                ok, tol = err <= 1e-5, "atol 1e-5"
            P, per = decode_partitions(16, 16, max_pages, 16)
            log("kernel", f"gpt-j paged decode {tier} S=16 H=Hkv=16 hd=256 "
                          f"{ctx} context (row {free} free): P={P} x {per} "
                          f"pages, max_abs_err={err:.3e} ({tol}; every row "
                          f"finite)")
            assert ok, f"gpt-j paged decode {tier} {ctx} disagrees"
    return worst


def flash_bounds(B, T, H, hd, elem, causal=True, key_mask=None):
    """Least time (ms) and what bounds it, per kernel: the bytes the
    function must move (its inputs q, k, v, dO once each in ``elem``
    bytes, and O for dq, which computes D; the int32 mask and the
    float32 lse / D rows, D written by dq and read by dk/dv; its outputs
    once in the inputs' dtype, as the seam returns them: O, dq, or dk
    and dv) over HBM bandwidth, vs the multiply-adds of the (query, key)
    pairs causality leaves — T (T + 1) / 2 per head for full-length
    rows; with ``key_mask``, per row the real keys at or before each
    query — over the bf16 peak: QK^T and PV in the forward, QK^T, dO V^T
    and dS K for dq, and those two plus P^T dO and dS^T Q for dk/dv; for
    the whole backward seam (dq and dk/dv) the five products once each
    and D kept out of memory."""
    n = B * T * H * hd
    row, mask = 4 * B * H * T, 4 * B * T
    if key_mask is not None:  # causal pairs with a real key
        macs = H * int(key_mask.long().cumsum(1).sum()) * hd
    else:
        pairs = T * (T + 1) // 2 if causal else T * T
        macs = B * H * pairs * hd
    work = {
        "flash_fwd": (4 * n * elem + mask + row, 2 * 2 * macs),
        # q, k, v, dO and O in, dq out; lse in, D out
        "flash_bwd_dq": (6 * n * elem + mask + 2 * row, 2 * 3 * macs),
        "flash_bwd_dkv": (6 * n * elem + mask + 2 * row, 2 * 4 * macs),
        # the whole backward: q, k, v, dO, O and lse in, dq, dk, dv out;
        # QK^T, dO V^T, dS K, P^T dO and dS^T Q once each
        SEAM: (8 * n * elem + mask + row, 2 * 5 * macs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / BF16_FLOPS * 1e3
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations",
                     nbytes, flops)
    return out


def time_flash(dev, label, B, T, H=12, hd=64, iters=10, lengths=None):
    """Kernel / plain version / SDPA yardstick at a full-length causal bf16
    shape: device time from CUDA-graph replay and the eager loop's time.
    The yardstick is one scaled_dot_product_attention call with the same
    additive [B, 1, T, T] mask for the forward, and its backward (dq, dk
    and dv together) for both backward kernels; the port never calls it.
    Autograd's backward alone cannot be captured (its graph was recorded
    outside the capture), so the backward's time is SDPA forward +
    backward captured together less the forward's, both measured here.
    The seam line times what ``FlashAttention.backward`` launches, dq
    (which computes D = rowsum(dO * O)) then dk/dv, in one graph beside
    the same SDPA backward. ``lengths`` gives ILQL's layout (see
    flash_case), and the bound counts the (query, key) pairs with a real
    key."""
    q, k, v, g, mask = flash_case(dev, B, T, H, hd, (), torch.bfloat16,
                                  seed=T + 1, lengths=lengths)
    o, lse = fa.flash_fwd(q, k, v, mask)
    dD = fa.softmax_jacobian_diag(g, o)

    def seam(dq, dkv):
        grad_q, d = dq(q, k, v, g, o, lse, mask)
        return grad_q, dkv(q, k, v, g, lse, d, mask)
    bias = causal_mask_bias(mask).to(torch.bfloat16)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gs = g.transpose(1, 2)
    fns = {
        "flash_fwd": (
            lambda: fa.flash_fwd(q, k, v, mask),
            lambda: fa.flash_fwd_reference(q, k, v, mask),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=bias)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, g, o, lse, mask),
            lambda: fa.flash_bwd_dq_reference(q, k, v, g, o, lse, mask),
            None),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, g, lse, dD, mask),
            lambda: fa.flash_bwd_dkv_reference(q, k, v, g, lse, dD, mask),
            lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias),
                (qs, ks, vs), gs)),
        SEAM: (
            lambda: seam(fa.flash_bwd_dq, fa.flash_bwd_dkv),
            lambda: seam(fa.flash_bwd_dq_reference,
                         fa.flash_bwd_dkv_reference),
            None),
    }
    bounds = flash_bounds(B, T, H, hd, 2,
                          key_mask=None if lengths is None else mask)
    out = {}
    for name, (kernel, plain, lib) in fns.items():
        timed = [f for f in (kernel, plain, lib) if f is not None]
        eager = [time_ms(f, [()], iters) for f in timed]
        graph = graph_ms(timed, [()], iters)
        if lib is None:  # the SDPA backward covers dq and dk/dv together
            eager.append(None)
            graph.append(None)
        b_ms, b_by, nbytes, flops = bounds[name]
        out[name] = {"ms": graph[0], "plain_ms": graph[1],
                     "library_ms": graph[2], "bound_ms": b_ms,
                     "bound_by": b_by, "eager_ms": eager[0],
                     "eager_plain_ms": eager[1],
                     "eager_library_ms": eager[2], "bytes": nbytes,
                     "flops": flops}
    for key in ("library_ms", "eager_library_ms"):
        bwd = out["flash_bwd_dkv"][key] - out["flash_fwd"][key]
        for name in ("flash_bwd_dq", "flash_bwd_dkv", SEAM):
            out[name][key] = bwd
    for name, t in out.items():
        lib = "fwd" if name == "flash_fwd" else "bwd (dq+dk+dv)"
        log("flash", f"{label} B{B} T{T} H{H} hd{hd} bf16 causal {name}: "
                     f"{t['bytes'] / 1e6:.1f} MB, {t['flops'] / 1e9:.2f} "
                     f"GFLOP; device (CUDA graph): kernel "
                     f"{t['ms'] * 1e3:.1f} us, plain "
                     f"{t['plain_ms'] * 1e3:.1f} us, SDPA {lib} "
                     f"{t['library_ms'] * 1e3:.1f} us; eager: kernel "
                     f"{t['eager_ms'] * 1e3:.1f} us, plain "
                     f"{t['eager_plain_ms'] * 1e3:.1f} us, SDPA {lib} "
                     f"{t['eager_library_ms'] * 1e3:.1f} us; bound "
                     f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
    return out


# --------------------------------------------------------------------- #
# 4b. sequence and pipeline parallelism in one process
# --------------------------------------------------------------------- #

#: [sp]: the PPO training shape and gpt-j's heads at the TL;DR length,
#: over sp 2 and 4 (chunks of 288 and 144 positions, both at or above
#: the flash seam's 128-token floor)
SP_SHAPES = (("PPO training shape", dict(B=32, T=576, H=12, hd=64),
              list(range(0, 512, 16))),
             ("gpt-j heads", dict(B=8, T=576, H=16, hd=256), GPTJ_PADS))
SP_SIZES = (2, 4)
#: relative L2 of the ring's bf16 gradients against float32 autograd of
#: the dense oracle (and against the one-call seam's): each block pair's
#: dq, dk and dv are rounded to bf16 once before the float32 sums
SP_GRAD_RTOL = 2e-2
#: [pp]: GPipe of the gpt2-width trunk (12 layers) in 4 microbatches, at
#: the PPO training batch
PP_SIZES, PP_MICRO, PP_B, PP_T = (2, 4), 4, 32, 576


def rel_l2(a, b):
    """||a - b|| / ||b|| in float32."""
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def ring_run(q, k, v, g, mask, sp, plain=False):
    """The loopback ring's output and (dq, dk, dv) for upstream ``g``:
    block pairs through the kernels, or with ``plain`` through their
    plain versions (the same ring in float32 math)."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = ring_attention_loopback(*leaves, mask, sp,
                                  min_fused_t=10**9 if plain else None)
    out.backward(g)
    return out.detach(), [x.grad for x in leaves]


def seam_run(q, k, v, g, mask):
    """The one-call flash seam on the whole sequence: output and grads."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, mask)
    out.backward(g)
    return out.detach(), [x.grad for x in leaves]


def sp_phase(dev):
    """[sp]: the loopback ring (every sp rank in this process) at bf16,
    forward and backward, at each of SP_SHAPES and SP_SIZES, left-padded
    as the rollouts are (dO 0 on pad rows): the kernels' launches per
    call == sp (sp + 1) / 2 of each (the pairs on and below the
    diagonal); the ring against the same ring on the plain versions
    (O on live rows, dq / dk / dv at atol 1e-2 + rtol 1e-2, as phase 4
    holds each kernel), against the dense oracle in float32 on the whole
    sequence (O on live rows at atol 1e-2 + rtol 1e-2; gradients by
    relative L2 at SP_GRAD_RTOL) and against the one-call seam (the
    same); every output finite. Times the ring's forward + backward
    against the seam's on the whole sequence (eager, CUDA events).
    Returns {"launches": per kernel summed over the calls, "errs": per
    kernel, "runs": [...]}."""
    launches = dict.fromkeys(FLASH_NAMES, 0)
    errs = dict.fromkeys(FLASH_NAMES, 0.0)
    runs = []
    for label, shape, pads in SP_SHAPES:
        B, T, H, hd = shape["B"], shape["T"], shape["H"], shape["hd"]
        q, k, v, g, mask = flash_case(dev, B, T, H, hd, pads[:B],
                                      torch.bfloat16, seed=T + H)
        real = live_rows(mask)
        refs = [x.detach().float().requires_grad_() for x in (q, k, v)]
        ref = fa.flash_attention_reference(*refs, mask)
        ref.backward(g.float())
        seam_out, seam_grads = seam_run(q, k, v, g, mask)
        for sp in SP_SIZES:
            sync(dev)
            ops.reset_launches()
            out, grads = ring_run(q, k, v, g, mask, sp)
            sync(dev)
            got = {n: ops.LAUNCHES[n] for n in FLASH_NAMES}
            want = sp * (sp + 1) // 2
            if dev == "cuda":  # the CPU runs the plain versions
                assert got == dict.fromkeys(FLASH_NAMES, want), \
                    (label, sp, got)
            launches = {n: launches[n] + got[n] for n in FLASH_NAMES}
            assert torch.isfinite(out.float()).all(), "non-finite ring O"
            for x in grads:
                assert torch.isfinite(x.float()).all(), "non-finite ring grad"
            p_out, p_grads = ring_run(q, k, v, g, mask, sp, plain=True)
            kern = {"O": ratio(out[real], p_out[real]),
                    **{f"d{n}": ratio(a, b)
                       for n, a, b in zip("qkv", grads, p_grads)}}
            dense = {"O": ratio(out[real], ref.detach()[real]),
                     **{f"d{n}": rel_l2(a, b.grad)
                        for n, a, b in zip("qkv", grads, refs)}}
            seam = {"O": ratio(out[real], seam_out[real]),
                    **{f"d{n}": rel_l2(a, b)
                       for n, a, b in zip("qkv", grads, seam_grads)}}
            for what, r in kern.items():
                assert r <= 1.0, f"[sp] {label} sp {sp}: {what} vs plain"
            for table in (dense, seam):
                assert table["O"] <= 1.0, f"[sp] {label} sp {sp}: O"
                for what in ("dq", "dk", "dv"):
                    assert table[what] <= SP_GRAD_RTOL, \
                        f"[sp] {label} sp {sp}: {what} {table[what]:.3e}"
            e = {"flash_fwd": max_err(out[real], p_out[real]),
                 "flash_bwd_dq": max_err(grads[0], p_grads[0]),
                 "flash_bwd_dkv": max(max_err(grads[1], p_grads[1]),
                                      max_err(grads[2], p_grads[2]))}
            errs = {n: max(errs[n], e[n]) for n in FLASH_NAMES}
            ring_ms = seam_ms = float("nan")
            if dev == "cuda":
                ring_ms = time_ms(lambda: ring_run(q, k, v, g, mask, sp),
                                  [()], 5)
                seam_ms = time_ms(lambda: seam_run(q, k, v, g, mask), [()],
                                  5)
            runs.append({"label": label, "sp": sp, **shape,
                         "launches": got, "vs_plain": kern,
                         "vs_dense": dense, "vs_seam": seam,
                         "ring_ms": ring_ms, "seam_ms": seam_ms})
            log("sp", f"{label} B{B} T{T} H{H} hd{hd} bf16, sp {sp} "
                      f"(chunks of {T // sp}): launches {got} == "
                      f"sp (sp + 1) / 2 = {want} each; vs the plain ring "
                      f"(ratio, <= 1) " + ", ".join(
                          f"{n} {r:.3f}" for n, r in kern.items())
                + "; vs the dense oracle in fp32 O ratio "
                  f"{dense['O']:.3f}, grads rel L2 " + ", ".join(
                      f"{n} {dense[n]:.2e}" for n in ("dq", "dk", "dv"))
                + f"; vs the one-call seam O ratio {seam['O']:.3f}, grads "
                  "rel L2 " + ", ".join(
                      f"{n} {seam[n]:.2e}" for n in ("dq", "dk", "dv"))
                + f" (<= {SP_GRAD_RTOL}); forward + backward "
                  f"{ring_ms:.3f} ms ring vs {seam_ms:.3f} ms seam "
                  f"(eager, one process holds every rank)")
        del q, k, v, g, refs, ref, seam_grads
        release(dev)
    return {"launches": launches, "errs": errs, "runs": runs}


def pp_phase(dev):
    """[pp]: the loopback GPipe (every stage in this process) of the
    gpt2-124M-width trunk — all 12 seeded blocks, B 32, T 576 with left
    padding, the embeddings' hidden states — at pp 2 and 4 in
    PP_MICRO microbatches, the flash kernels inside the stages, against
    the plain trunk (``apply_blocks`` with the same seam on the whole
    batch): at fp32 by relative L2 on live rows at 1e-4 (the
    microbatches' matmuls may sum in another order), at bf16 at 2e-2;
    flash_fwd launches == microbatches x layers, no backward kernel
    (the schedule keeps no gradient). Times the schedule against the
    plain trunk (eager, CUDA events). Returns {"launches", "runs"}."""
    from trlx_tpu_torch.models.transformer import positions_from_mask

    spec = TRLConfig.from_dict(config_dict()).model.resolve_spec()
    tree = init_hydra_numpy(spec, 0, seed=0)["frozen_base"]
    L, B, T = spec.n_layer, PP_B, PP_T
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, spec.vocab_size, (B, T), generator=gen,
                           device=dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    for i, p in enumerate(range(0, 16 * B, 16)):
        mask[i, :p] = 0
    real = live_rows(mask)
    positions = positions_from_mask(mask)
    attn = fa.make_flash_attention_fn()
    launches = dict.fromkeys(FLASH_NAMES, 0)
    runs = []
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        blocks = tree_map(lambda x: torch.from_numpy(x).to(dev, dtype),
                          tree["blocks"])
        embed = tree_map(lambda x: torch.from_numpy(x).to(dev, dtype),
                         tree["embed"])
        with torch.no_grad():
            h = embed_tokens(embed, spec, tokens, positions, dtype)
            plain = apply_blocks(blocks, spec, h, mask, positions,
                                 attention_fn=attn)
        for pp in PP_SIZES:
            sync(dev)
            ops.reset_launches()
            out = pp_apply_blocks_loopback(blocks, pp, spec, h, mask,
                                           positions, n_micro=PP_MICRO,
                                           attention_fn=attn)
            sync(dev)
            got = {n: ops.LAUNCHES[n] for n in FLASH_NAMES}
            want = {"flash_fwd": PP_MICRO * L, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}
            if dev == "cuda":  # the CPU runs the plain versions
                assert got == want, ("[pp]", pp, got, want)
            launches = {n: launches[n] + got[n] for n in FLASH_NAMES}
            assert torch.isfinite(out.float()).all(), "non-finite [pp]"
            err = rel_l2(out[real], plain[real])
            assert err <= rtol, f"[pp] pp {pp} {dtype}: rel L2 {err:.3e}"
            pp_ms = plain_ms = float("nan")
            if dev == "cuda":
                with torch.no_grad():
                    pp_ms = time_ms(lambda: pp_apply_blocks_loopback(
                        blocks, pp, spec, h, mask, positions,
                        n_micro=PP_MICRO, attention_fn=attn), [()], 3)
                    plain_ms = time_ms(lambda: apply_blocks(
                        blocks, spec, h, mask, positions,
                        attention_fn=attn), [()], 3)
            runs.append({"pp": pp, "dtype": str(dtype), "rel_l2": err,
                         "launches": got, "pp_ms": pp_ms,
                         "plain_ms": plain_ms})
            log("pp", f"GPipe of the gpt2-width trunk ({L} layers, "
                      f"{L // pp} a stage) B{B} T{T} {dtype}, pp {pp}, "
                      f"{PP_MICRO} microbatches, flash inside the stages: "
                      f"launches {got} == {want}; vs the plain trunk rel "
                      f"L2 {err:.2e} on live rows (<= {rtol}); "
                      f"{pp_ms:.2f} ms pipelined vs {plain_ms:.2f} ms "
                      f"plain (eager, one process holds every stage)")
        del blocks, embed, h, plain
        release(dev)
    return {"launches": launches, "runs": runs}


# --------------------------------------------------------------------- #
# 5. serve over HTTP
# --------------------------------------------------------------------- #


def build_engine(views, device, compute_dtype, attention, sample=False):
    serve = ServeConfig(buckets=[list(b) for b in SERVE_BUCKETS],
                        slots=16, page_size=16, attention=attention,
                        max_queue=256, request_timeout=600.0)
    return InferenceEngine(
        TRLConfig.from_dict(config_dict(compute_dtype, sample)),
        serve=serve, views=views, device=device)


def graph_stats(graphs):
    """Count, capture seconds and private-pool bytes of captured graphs
    (trlx_tpu_torch.utils.aotjit: memory reserved before and after each
    capture)."""
    return {"graphs": len(graphs),
            "capture_s": sum(g.seconds for g in graphs),
            "pool_bytes": sum(g.pool_bytes for g in graphs)}


def recompiles():
    return telemetry.current().registry.counters["compile/recompiles"]


def post(url, payload, timeout=600):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def check_counts(results, eos):
    """Each response returns exactly its own count (or stops early on
    the tokenizer's eos, which then ends it)."""
    for (prompt, max_new), tokens in results:
        ended = bool(tokens) and tokens[-1] == eos
        assert len(tokens) == max_new or (ended and len(tokens) < max_new), (
            f"{prompt!r}: {len(tokens)} tokens for max_new_tokens="
            f"{max_new}")


def serve_phase(views, device, requests=USER_PROMPTS):
    """The main path: engine -> HTTP server -> concurrent /generate.
    Returns the responses' tokens and the run's numbers."""
    telemetry.start()
    engine = build_engine(views, device, "bfloat16", "pallas")
    ops.reset_launches()
    server = InferenceServer(engine, host="127.0.0.1", port=0)
    t0 = time.perf_counter()
    server.start()
    warm_s = time.perf_counter() - t0
    base = f"http://127.0.0.1:{server.port}"
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            bodies = list(pool.map(
                lambda r: post(f"{base}/generate",
                               {"prompt": r[0], "max_new_tokens": r[1]}),
                requests,
            ))
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["paged_decode"]
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok", health
    finally:
        server.stop()
    steps = server.scheduler.runtime.steps
    n_layer = engine.spec.n_layer
    results = [(r, b["tokens"]) for r, b in zip(requests, bodies)]
    check_counts(results, engine.tokenizer.eos_token_id)
    registry = telemetry.current().registry
    hits = registry.counters.get("serve/prefix_tokens_saved", 0.0)
    # host-clock spans that close after the results reach the host; the
    # first call of each span is the warmup's and is left out
    step = registry.hists["time/serve/slot_step"]
    prefills = [h for name, h in registry.hists.items()
                if name.startswith("time/serve/prefill")]
    if device == "cuda":
        assert launches == n_layer * steps, (
            f"kernel launches {launches} != {n_layer} layers x {steps} "
            f"decode steps")
        assert launches > 0
    assert hits > 0, "no radix prefix hit"
    assert recompiles() == 0, f"serve recompiled {recompiles()} times"
    assert health["recompiles"] == 0, health
    generated = sum(len(t) for _, t in results)
    lat = sorted(b["latency_ms"] for b in bodies)
    return {
        "results": results, "launches": launches, "steps": steps,
        "prefix_tokens_saved": hits, "warmup_s": warm_s, "wall_s": wall,
        "tokens": generated, "tok_per_s": generated / wall,
        "latency_p50_ms": lat[len(lat) // 2], "latency_max_ms": lat[-1],
        "kv": health["kv"],
        "step_p50_ms": step.quantile(0.5) * 1e3,
        "step_p95_ms": step.quantile(0.95) * 1e3,
        "step_count": len(step.window),
        "prefill_s": sum(h.total - h.first for h in prefills),
        "prefill_calls": sum(len(h.window) for h in prefills),
        "graphs": graph_stats(server.scheduler.runtime.graphs()),
    }


# --------------------------------------------------------------------- #
# 6. greedy parity: kernel path vs plain path at fp32
# --------------------------------------------------------------------- #


def run_scheduler(engine, requests):
    sched = SlotScheduler(engine)
    sched.warmup()
    reqs = [sched.submit(engine.encode_prompt(p), max_new_tokens=n)
            for p, n in requests]
    sched.start()  # everything queued first: one admission order
    try:
        return [r.wait(timeout=600).result for r in reqs], sched
    finally:
        sched.stop()


@torch.no_grad()
def logit_gap(engine, tokens):
    """Top-1 minus top-2 next-token logit after ``tokens``, from one dense
    fp32 forward without a cache (how near a tie a divergence sits)."""
    ids = torch.tensor([tokens], device=engine.device)
    pos = torch.arange(len(tokens), device=engine.device)[None]
    h = embed_tokens(engine.embed, engine.spec, ids, pos,
                     engine.compute_dtype)
    bias = causal_mask_bias(torch.ones_like(ids))
    for seg in engine.blocks:
        h = apply_blocks(seg, engine.spec, h, bias, pos)
    top2 = lm_logits(engine.embed, engine.ln_f, engine.spec, h)[0, -1]
    top2 = top2.topk(2).values
    return float(top2[0] - top2[1])


def parity_phase(views, device, requests=USER_PROMPTS):
    out = {}
    for attention in ("pallas", "jnp"):
        telemetry.start()
        engine = build_engine(views, device, "float32", attention)
        out[attention], _ = run_scheduler(engine, requests)
    for i, (a, b) in enumerate(zip(out["pallas"], out["jnp"])):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = logit_gap(engine, engine.encode_prompt(requests[i][0])
                            + a[:j])
            log("parity", f"request {i} diverges at token {j}: "
                          f"{a[j]} vs {b[j]}, top-2 logit gap {gap:.3e}")
    assert out["pallas"] == out["jnp"], "kernel path != plain path (fp32)"
    return out


# --------------------------------------------------------------------- #
# 6b. CUDA graphs against the eager path: serving
# --------------------------------------------------------------------- #


def with_graphs(on, fn, *args):
    """``fn(*args)`` with trlx_tpu_torch.utils.aotjit's switch set to
    ``on`` (off: the eager path on the card), restored after."""
    aotjit.CUDA_GRAPHS = on
    try:
        return fn(*args)
    finally:
        aotjit.CUDA_GRAPHS = True


def serve_ab_phase(views, device, requests=USER_PROMPTS):
    """The slot scheduler with graphs off (eager) and on, in one process,
    at fp32 and bf16, greedy and sampled (every step re-seeded from
    serve.seed + step, so both paths draw from the same streams): the
    same tokens, paged-decode launches equal on both paths and to layers
    x steps, ``compile/recompiles`` 0. The graphs are captured on this
    thread (warmup) and replayed on the scheduler's worker thread."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for sample in (False, True):
            runs = {}
            for graphs in (False, True):
                telemetry.start()
                engine = build_engine(views, device, dtype, "pallas",
                                      sample=sample)
                ops.reset_launches()
                tokens, sched = with_graphs(graphs, run_scheduler, engine,
                                            requests)
                step = telemetry.current().registry.hists[
                    "time/serve/slot_step"]
                runs[graphs] = {
                    "tokens": tokens, "steps": sched.runtime.steps,
                    "launches": ops.LAUNCHES["paged_decode"],
                    "recompiles": recompiles(),
                    "step_p50_ms": step.quantile(0.5) * 1e3,
                    "step_p95_ms": step.quantile(0.95) * 1e3,
                    "graphs": graph_stats(sched.runtime.graphs()),
                }
            eager, graph = runs[False], runs[True]
            what = f"serve {dtype} {'sampled' if sample else 'greedy'}"
            assert eager["tokens"] == graph["tokens"], \
                f"{what}: graph tokens != eager tokens"
            assert eager["launches"] == graph["launches"], (what, runs)
            if device == "cuda":
                assert graph["launches"] == \
                    engine.spec.n_layer * graph["steps"] > 0, (what, graph)
            assert eager["recompiles"] == graph["recompiles"] == 0, runs
            assert graph["graphs"]["graphs"] == (
                7 if device == "cuda" else 0), graph["graphs"]
            for r in runs.values():
                del r["tokens"]
            out[f"{dtype}_{'sampled' if sample else 'greedy'}"] = runs
    return out


# --------------------------------------------------------------------- #
# 6c. the serve tiers: static, contiguous, int8 KV, speculation
# --------------------------------------------------------------------- #


def tier_engine(views, device, compute_dtype, **serve):
    """An engine at phase 5's lattice (16 slots, pages of 16) with the
    given serve knobs (greedy)."""
    cfg = ServeConfig(**{"buckets": [list(b) for b in SERVE_BUCKETS],
                         "slots": 16, "page_size": 16, "max_queue": 256,
                         "request_timeout": 600.0, **serve})
    return InferenceEngine(TRLConfig.from_dict(config_dict(compute_dtype)),
                           serve=cfg, views=views, device=device)


def run_static(engine, requests):
    """The static micro-batcher: every bucket warmed (a graph each on the
    card), all requests queued, then the worker started."""
    batcher = MicroBatcher(engine)
    engine.warmup()
    reqs = [batcher.submit(engine.encode_prompt(p), max_new_tokens=n)
            for p, n in requests]
    batcher.start()
    try:
        return [r.wait(timeout=600).result for r in reqs], batcher
    finally:
        batcher.stop()


def p50_ms(name):
    """Steady-state p50 (ms) of telemetry span ``name``, or None."""
    h = telemetry.current().registry.hists.get(f"time/{name}")
    return None if h is None or not h.count else h.quantile(0.5) * 1e3


def makespan_s():
    """The longest request latency of the run (all requests were queued
    before the worker started, so: the time to serve them all)."""
    hists = telemetry.current().registry.hists
    lat = [x for name, h in hists.items()
           if name.startswith("serve/request_latency")
           for x in [h.first, *h.window] if x is not None]
    return max(lat) if lat else None


def tier_run(views, device, dtype, requests=USER_PROMPTS, **serve):
    """One engine with ``serve`` knobs through its scheduler on
    ``requests``: tokens, paged-decode launches (reset just before),
    steps, verify passes, the speculation counters, step p50s, graphs
    and recompiles."""
    telemetry.start()
    engine = tier_engine(views, device, dtype, **serve)
    ops.reset_launches()
    if serve.get("scheduler") == "static":
        tokens, _ = run_static(engine, requests)
        steps = verify = 0
        graphs = engine.graphs()
        step = [p50_ms(engine.span_name(b)) for b in engine.buckets]
        sched = None
    else:
        tokens, sched = run_scheduler(engine, requests)
        steps, verify = sched.runtime.steps, sched.runtime.verify_steps
        graphs = sched.graphs()
        step = p50_ms(SlotPoolRuntime.STEP_SPAN)
    counters = telemetry.current().registry.counters
    out = {
        "tokens": tokens, "launches": ops.LAUNCHES["paged_decode"],
        "steps": steps, "verify_steps": verify,
        "proposed": counters.get("serve/spec_proposed", 0.0),
        "accepted": counters.get("serve/spec_accepted", 0.0),
        "fallbacks": counters.get("serve/spec_fallbacks", 0.0),
        "step_p50_ms": step,
        "verify_p50_ms": p50_ms(SlotPoolRuntime.VERIFY_SPAN),
        "makespan_s": makespan_s(),
        "graphs": graph_stats(graphs), "recompiles": recompiles(),
        "layers": engine.spec.n_layer,
        "model_gb": telemetry.current().registry.gauges["serve/model_gb"],
        "kv": sched.pool_stats() if sched is not None else None,
    }
    assert out["recompiles"] == 0, f"{serve}: {out['recompiles']} recompiles"
    return out, engine


def divergence(tokens, reference, engine, requests):
    """Share of requests whose tokens equal ``reference``'s, and the
    first divergence (request, token index, the two tokens, the top-2
    logit margin there from one dense forward on ``engine``)."""
    same = sum(a == b for a, b in zip(tokens, reference))
    first = None
    for i, (a, b) in enumerate(zip(tokens, reference)):
        if a != b:
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            margin = logit_gap(engine, engine.encode_prompt(requests[i][0])
                               + b[:j])
            first = {"request": i, "token": j,
                     "tokens": [a[j] if j < len(a) else None,
                                b[j] if j < len(b) else None],
                     "margin": margin}
            break
    return {"identical": f"{same}/{len(tokens)}", "first": first}


def serve_tiers_phase(views, device, fp32):
    """The serve features of this slice at gpt2-124M width on phase 5's
    10 requests, against ``fp32`` (phase 6's fp32 greedy tokens, the same
    on the kernel and the plain path): the static micro-batcher, the
    contiguous layout, the int8 KV tier on the kernel path (fp32 against
    the int8 plain path, and bf16 — the bf16-query x int8-pool kernel
    instance), and lookup speculation (fp32 tokens identical; at bf16
    the share identical to speculation off and the first divergence
    with its margin; the proposals these requests' histories give are
    printed, the verify pass's graph captured at warmup either way).
    0 recompiles everywhere."""
    out = {}
    out["paged"], _ = tier_run(views, device, "float32")
    assert out["paged"]["tokens"] == fp32, "paged fp32 run drifted"
    out["static"], _ = tier_run(views, device, "float32", scheduler="static")
    assert out["static"]["tokens"] == fp32, \
        "static scheduler != slot scheduler (fp32 greedy)"
    if device == "cuda":
        assert out["static"]["graphs"]["graphs"] == len(SERVE_BUCKETS)
    out["contiguous"], _ = tier_run(views, device, "float32",
                                    kv_layout="contiguous")
    assert out["contiguous"]["tokens"] == fp32, \
        "contiguous layout != paged layout (fp32 greedy)"
    for dtype in ("float32", "bfloat16"):
        run, _ = tier_run(views, device, dtype, kv_dtype="int8",
                          attention="pallas")
        if device == "cuda":
            assert run["launches"] == run["layers"] * run["steps"] > 0, run
        assert run["kv"]["kv_dtype"] == "int8"
        out[f"int8_{dtype}"] = run
    out["int8_plain"], engine = tier_run(views, device, "float32",
                                         kv_dtype="int8", attention="jnp")
    assert out["int8_float32"]["tokens"] == out["int8_plain"]["tokens"], \
        "int8 KV: kernel path != plain path (fp32 greedy)"
    out["int8_float32"]["vs_bf16_kv"] = divergence(
        out["int8_float32"]["tokens"], fp32, engine, USER_PROMPTS)
    out["bf16"], engine = tier_run(views, device, "bfloat16",
                                   attention="pallas")
    out["int8_bfloat16"]["vs_bf16_kv"] = divergence(
        out["int8_bfloat16"]["tokens"], out["bf16"]["tokens"], engine,
        USER_PROMPTS)
    for dtype in ("float32", "bfloat16"):
        run, engine = tier_run(views, device, dtype, attention="pallas",
                               speculation="lookup", spec_k=4)
        if device == "cuda":
            assert run["launches"] == run["layers"] * run["steps"], run
            # 6 prefill graphs, the step's and the verify pass's
            assert run["graphs"]["graphs"] == 8, run["graphs"]
        # speculation ran: proposals verified, none lost to a fallback
        assert run["fallbacks"] == 0, f"lookup {dtype}: {run['fallbacks']}" \
            f" proposal faults fell back to plain steps"
        assert run["proposed"] > 0 and run["verify_steps"] > 0, run
        out[f"lookup_{dtype}"] = run
    assert out["lookup_float32"]["tokens"] == fp32, \
        "lookup speculation changed the fp32 greedy tokens"
    out["lookup_bfloat16"]["vs_off"] = divergence(
        out["lookup_bfloat16"]["tokens"], out["bf16"]["tokens"], engine,
        USER_PROMPTS)
    for run in out.values():
        run["tokens_total"] = sum(len(t) for t in run.pop("tokens"))
    return out


def log_tiers(t, card):
    st, ct = t["static"], t["contiguous"]
    log("serve-tiers", f"scheduler static (fp32, {st['graphs']['graphs']} "
                       f"bucket graphs): greedy tokens == the slot "
                       f"scheduler's; decode span p50 per bucket "
                       f"{[round(x, 2) if x else x for x in st['step_p50_ms']]}"
                       f" ms, all 10 requests in "
                       f"{st['makespan_s'] * 1e3:.1f} ms; kv_layout "
                       f"contiguous (fp32): tokens == paged, step p50 "
                       f"{ct['step_p50_ms']:.2f} ms, all 10 in "
                       f"{ct['makespan_s'] * 1e3:.1f} ms; the paged "
                       f"slot scheduler (fp32, plain path) step p50 "
                       f"{t['paged']['step_p50_ms']:.2f} ms, all 10 in "
                       f"{t['paged']['makespan_s'] * 1e3:.1f} ms; 0 "
                       f"recompiles ({card})")
    for dtype in ("float32", "bfloat16"):
        r = t[f"int8_{dtype}"]
        log("serve-tiers", f"kv_dtype int8, attention pallas, {dtype}: "
                           f"paged decode launched {r['launches']} == "
                           f"{r['layers']} layers x {r['steps']} steps on "
                           f"the int8 pool ({r['kv']['kv_bytes_per_token']}"
                           f" B/token vs bf16's "
                           f"{t['bf16']['kv']['kv_bytes_per_token']}); "
                           f"step p50 {r['step_p50_ms']:.2f} ms; tokens vs "
                           f"bf16 KV {r['vs_bf16_kv']}" + (
                               "; == the int8 plain path"
                               if dtype == "float32" else
                               f"; bf16 KV step p50 "
                               f"{t['bf16']['step_p50_ms']:.2f} ms")
            + f" ({card})")
    log("serve-tiers", f"all 10 requests: bf16 KV (bf16, kernel path) "
                       f"{t['bf16']['makespan_s'] * 1e3:.1f} ms, int8 KV "
                       f"{t['int8_bfloat16']['makespan_s'] * 1e3:.1f} ms; "
                       f"lookup speculation at bf16 "
                       f"{t['lookup_bfloat16']['makespan_s'] * 1e3:.1f} ms "
                       f"({card})")
    for dtype in ("float32", "bfloat16"):
        r = t[f"lookup_{dtype}"]
        sp = r["kv"]["speculation"]
        log("serve-tiers", f"speculation lookup (spec_k 4), {dtype}: "
                           f"{r['proposed']:.0f} proposed, "
                           f"{r['accepted']:.0f} accepted (acceptance "
                           f"{sp['acceptance_rate']:.4f}), "
                           f"{r['verify_steps']} verify passes + "
                           f"{r['steps']} plain steps for "
                           f"{r['tokens_total']} tokens, "
                           f"{sp['tokens_per_slot_pass']:.3f} tokens per "
                           f"slot per verify pass; verify p50 "
                           f"{r['verify_p50_ms']:.2f} ms, plain step p50 "
                           f"{r['step_p50_ms']:.2f} ms; "
                           f"{r['graphs']['graphs']} graphs, 0 recompiles, "
                           f"{r['fallbacks']:.0f} fallbacks; "
                           + ("tokens == speculation off"
                              if dtype == "float32" else
                              f"vs speculation off {r['vs_off']}")
            + f" ({card})")


# --------------------------------------------------------------------- #
# 6c. the tp serve mesh
# --------------------------------------------------------------------- #

#: (H, hd) of the heads one process of a tp serve mesh hands paged
#: decode: gpt2-124M (12 heads of 64) and gpt-j-6B (16 of 256) under tp 2
#: and tp 4
SHARD_SHAPES = ((6, 64), (3, 64), (8, 256), (4, 256))


def check_shards(dev):
    """Paged decode at the shard shapes (:data:`SHARD_SHAPES`, H = Hkv,
    16 slots x 4 pages of 16, ragged, row 5 free), bf16 q over the bf16
    and the int8 pool, against its plain version in float32 math on the
    same inputs (atol 1e-2 + rtol 1e-2, every row finite). Returns the
    largest error."""
    worst = 0.0
    for H, hd in SHARD_SHAPES:
        for tier in ("bf16", "int8"):
            q, ((k, v),), pt, bias = serving_case(
                dev, seed=90 + H + hd, H=H, Hkv=H, hd=hd, free_row=5)
            if tier == "int8":
                k, v = quantize_kv(k), quantize_kv(v)
            out = paged_decode_attention(q, k, v, pt, bias)
            ref = paged_decode_attention_reference(q.float(), k, v, pt, bias)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), \
                f"non-finite shard H {H} hd {hd} {tier}"
            err = max_err(out, ref)
            worst = max(worst, err)
            bad = (out.float() - ref).abs() > 1e-2 + 1e-2 * ref.abs()
            log("kernel", f"tp shard shape S=16 H=Hkv={H} hd={hd} bf16 q x "
                          f"{tier} pool (row 5 free): max_abs_err={err:.3e} "
                          f"(atol 1e-2 + rtol 1e-2 against float32 math; "
                          f"every row finite)")
            assert not bad.any(), \
                f"paged decode at shard H {H} hd {hd} {tier} disagrees"
    return worst


def mesh_serve_engine(views, device, mesh, scheduler="slots"):
    """Phase 5's lattice (16 slots, pages of 16, the kernel path) at
    fp32, greedy, on ``serve.mesh``, under ``scheduler``."""
    serve = ServeConfig(buckets=[list(b) for b in SERVE_BUCKETS],
                        slots=16, page_size=16, attention="pallas",
                        max_queue=256, request_timeout=600.0, mesh=mesh,
                        scheduler=scheduler)
    return InferenceEngine(TRLConfig.from_dict(config_dict("float32")),
                           serve=serve, views=views, device=device)


def record_heads(runtime):
    """The (q heads, pool heads, hd) paged decode is called with on this
    process, recorded by a wrapper around the runtime's seam (the eager
    path calls it every step)."""
    seen = set()
    fn = runtime.paged_decode_fn

    def seam(q, k_pages, v_pages, pt, bias):
        k = k_pages[0] if isinstance(k_pages, tuple) else k_pages
        seen.add((q.shape[1], k.shape[2], q.shape[2]))
        return fn(q, k_pages, v_pages, pt, bias)

    runtime.paged_decode_fn = seam
    return seen


def serve_mesh_one(views, device, fp32):
    """(a): ``serve.mesh {tp: 1}`` in a world of one process over NCCL
    through HTTP, graphs on: the decode step and every prefill bucket
    captured with the mesh's all-reduces inside."""
    import torch.distributed as dist

    initialize_runtime(f"tcp://127.0.0.1:{free_port()}", 1, 0, device)
    try:
        out = _serve_mesh_one(views, device, fp32)
    finally:
        release(device)
        dist.destroy_process_group()
    telemetry.start()
    plain = mesh_serve_engine(views, device, None)
    tokens, _ = run_scheduler(plain, USER_PROMPTS)
    out["plain_step_p50_ms"] = p50_ms("serve/slot_step")
    assert tokens == fp32, "the plain fp32 engine's tokens moved"
    del plain
    release(device)
    return out


def _serve_mesh_one(views, device, fp32):
    telemetry.start()
    engine = mesh_serve_engine(views, device, {"tp": 1})
    assert engine.tp is not None
    server = InferenceServer(engine, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    rt = server.scheduler.runtime
    try:
        health = http(f"{base}/healthz")[2]
        sync(device)
        ops.reset_launches()
        steps0 = rt.steps
        tokens = serve_ordered(server.scheduler, engine)
        sync(device)
        launches = ops.LAUNCHES["paged_decode"]
        steps = rt.steps - steps0
        with ThreadPoolExecutor(len(USER_PROMPTS)) as pool:
            bodies = list(pool.map(
                lambda r: post(f"{base}/generate",
                               {"prompt": r[0], "max_new_tokens": r[1]}),
                USER_PROMPTS))
        gauges = http(f"{base}/metrics")[2]["gauges"]
    finally:
        server.stop()
    graphs = graph_stats(rt.graphs())
    n_layer = engine.spec.n_layer
    assert tokens == fp32, "serve.mesh {tp: 1} tokens != the plain engine's"
    check_counts([(r, b["tokens"]) for r, b in zip(USER_PROMPTS, bodies)],
                 engine.tokenizer.eos_token_id)
    if device == "cuda":
        assert launches == n_layer * steps and launches > 0, (
            f"paged decode launches {launches} != {n_layer} x {steps} "
            f"steps")
    assert recompiles() == 0, f"recompiled {recompiles()} times"
    mesh = health["mesh"]
    assert {k: mesh[k] for k in ("devices", "axes", "weights")} == {
        "devices": 1, "axes": {"tp": 1}, "weights": "fsdp"}, mesh
    assert gauges["serve/mesh_devices"] == 1
    if device == "cuda":
        assert graphs["graphs"] == len(rt._prefill_fns) + 1, graphs
    return {"tokens_equal": True, "launches": launches, "steps": steps,
            "step_p50_ms": p50_ms("serve/slot_step"), "graphs": graphs,
            "mesh": mesh, "kv": health["kv"],
            "http_tokens_equal": [b["tokens"] for b in bodies] == fp32}


def serve_mesh_child(world, rank, port, out_path, device="cuda",
                     scheduler="slots"):
    """(b): one rank of a ``{tp: world}`` serve mesh, every rank on this
    card (NCCL refuses two ranks on one card, so the group is gloo, which
    moves CUDA tensors through the host): graphs off, since a gloo
    collective cannot be captured. Rank 0 serves the 10 requests through
    ``scheduler``; the others follow. Writes what it saw as JSON."""
    from trlx_tpu_torch.serve.follower import follow

    world, rank = int(world), int(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_runtime(f"tcp://127.0.0.1:{port}", world, rank, "cpu")
    telemetry.start()
    spec = TRLConfig.from_dict(config_dict()).model.resolve_spec()
    engine = mesh_serve_engine(init_decode_views(spec, seed=0,
                                                 num_layers_unfrozen=2),
                               device, {"tp": world}, scheduler)
    if scheduler == "static":
        return static_mesh_child(engine, rank, out_path, device)
    out = {"rank": rank, "refused": None}
    if device == "cuda":
        # graphs over gloo are refused at construction, never replayed
        # eager in silence
        try:
            SlotPoolRuntime(engine)
        except RuntimeError as e:
            out["refused"] = str(e)
        assert out["refused"], "graphs over gloo were not refused"
    aotjit.CUDA_GRAPHS = False
    ops.reset_launches()
    if engine.channel.leader:
        sched = SlotScheduler(engine)
        rt = sched.runtime
        seen = record_heads(rt)
        sched.warmup()
        reqs = [sched.submit(engine.encode_prompt(p), max_new_tokens=n)
                for p, n in USER_PROMPTS]
        sched.start()
        try:
            out["tokens"] = [r.wait(timeout=600).result for r in reqs]
            out["kv"] = sched.pool_stats()
        finally:
            sched.stop()
        out["step_p50_ms"] = p50_ms("serve/slot_step")
        out["mesh"] = engine.mesh_info()
    else:
        rt = SlotPoolRuntime(engine)
        seen = record_heads(rt)
        out["rc"] = follow(rt)
    sync(device)
    out.update(launches=ops.LAUNCHES["paged_decode"], steps=rt.steps,
               digest=rt.digest.hexdigest(), heads=sorted(seen),
               layers=engine.spec.n_layer, recompiles=recompiles())
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def flush_p50_ms(engine):
    """Steady-state p50 (ms) of the static path's flushes: every bucket's
    decode span past its first call (warmup's), or None."""
    hists = telemetry.current().registry.hists
    times = [x for b in engine.buckets
             for x in getattr(hists.get(f"time/{engine.span_name(b)}"),
                              "window", ())]
    return float(np.median(times)) * 1e3 if times else None


def static_mesh_child(engine, rank, out_path, device):
    """(b-static): one rank of the static leg. Rank 0 builds the
    micro-batcher (refused with graphs on over gloo, then built with them
    off), warms every bucket and flushes the 10 requests queued at once;
    rank 1 follows each ``decode`` until the batcher's stop. Writes its
    tokens (rank 0), static digest, recompiles, follower exit code and
    times as JSON."""
    from trlx_tpu_torch.serve.follower import follow

    out = {"rank": rank, "refused": None}
    if device == "cuda":
        try:
            engine.check_graph_transport()
        except RuntimeError as e:
            out["refused"] = str(e)
        assert out["refused"], "graphs over gloo were not refused"
    aotjit.CUDA_GRAPHS = False
    ops.reset_launches()
    start = time.perf_counter()
    if engine.channel.leader:
        tokens, _ = run_static(engine, USER_PROMPTS)
        out["tokens"] = tokens
        out["flush_p50_ms"] = flush_p50_ms(engine)
    else:
        out["rc"] = follow(engine)
    sync(device)
    out.update(wall_s=time.perf_counter() - start,
               digest=engine.digest.hexdigest(), recompiles=recompiles(),
               launches=dict(ops.LAUNCHES))
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def serve_mesh_static_one(views, device):
    """(a-static): ``serve.mesh {tp: 1}``, ``scheduler: static``, a world
    of one process over NCCL through HTTP, graphs on (a decode step
    captured per bucket, the mesh's all-reduces inside); then the plain
    static engine on the same requests."""
    import torch.distributed as dist

    start = time.perf_counter()
    initialize_runtime(f"tcp://127.0.0.1:{free_port()}", 1, 0, device)
    try:
        telemetry.start()
        engine = mesh_serve_engine(views, device, {"tp": 1}, "static")
        assert engine.tp is not None
        server = InferenceServer(engine, host="127.0.0.1", port=0).start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            health = http(f"{base}/healthz")[2]
            tokens = serve_ordered(server.scheduler, engine)
            with ThreadPoolExecutor(len(USER_PROMPTS)) as pool:
                bodies = list(pool.map(
                    lambda r: post(f"{base}/generate",
                                   {"prompt": r[0], "max_new_tokens": r[1]}),
                    USER_PROMPTS))
            flush = flush_p50_ms(engine)
        finally:
            server.stop()
        out = {"tokens": tokens, "flush_p50_ms": flush,
               "graphs": graph_stats(engine.graphs()),
               "recompiles": recompiles(), "mesh": health["mesh"],
               "scheduler": health["scheduler"],
               "http_tokens_equal": [b["tokens"] for b in bodies] == tokens}
        check_counts([(r, b["tokens"]) for r, b in zip(USER_PROMPTS,
                                                         bodies)],
                     engine.tokenizer.eos_token_id)
        del server, engine
    finally:
        release(device)
        dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - start
    telemetry.start()
    plain = mesh_serve_engine(views, device, None, "static")
    out["plain_tokens"], _ = run_static(plain, USER_PROMPTS)
    out["plain_flush_p50_ms"] = flush_p50_ms(plain)
    del plain
    release(device)
    return out


def serve_mesh_static_phase(views, device, card):
    """The static leg of ``[serve-mesh]``: (a-static) and (b-static) at
    ``{tp: 2}``, each checked against the plain static engine's tokens.
    Returns the leg's numbers."""
    one = serve_mesh_static_one(views, device)
    plain = one["plain_tokens"]
    assert one["tokens"] == plain, \
        "static serve.mesh {tp: 1} tokens != the plain static engine's"
    assert one["recompiles"] == 0, f"recompiled {one['recompiles']} times"
    assert one["scheduler"] == "static" and one["mesh"]["devices"] == 1
    if device == "cuda":
        assert one["graphs"]["graphs"] == len(SERVE_BUCKETS), one["graphs"]
    log("serve-mesh", f"(a-static) scheduler: static on serve.mesh "
                      f"{{tp: 1}}, a world of one over NCCL through HTTP: "
                      f"fp32 greedy tokens == the plain static engine's on "
                      f"the 10 requests (the HTTP burst's equal too: "
                      f"{one['http_tokens_equal']}); "
                      f"{one['graphs']['graphs']} CUDA graphs (a decode "
                      f"step a bucket, the mesh's all-reduces inside), 0 "
                      f"recompiles; leg wall {one['wall_s']:.2f} s; flush "
                      f"p50 {one['flush_p50_ms']:.2f} ms on the mesh, "
                      f"{one['plain_flush_p50_ms']:.2f} ms plain ({card})")
    ranks = serve_mesh_world(2, device, scheduler="static")
    lead = ranks[0]
    assert lead["tokens"] == plain, "static tp 2 tokens != the plain engine's"
    for r in ranks:
        assert r["digest"] == lead["digest"], \
            f"static tp 2 rank {r['rank']}'s tokens diverged"
        assert r["recompiles"] == 0, r
        assert r.get("rc", 0) == 0, r
        assert device != "cuda" or "gloo" in r["refused"], r
    wall = max(r["wall_s"] for r in ranks)
    log("serve-mesh", f"(b-static) scheduler: static on serve.mesh "
                      f"{{tp: 2}}, 2 gloo ranks on this card (graphs "
                      f"refused over gloo at construction; run with graphs "
                      f"off): fp32 greedy tokens == the plain static "
                      f"engine's, the ranks' static digests equal, the "
                      f"follower exited 0 after the stop, 0 recompiles; "
                      f"leg wall {wall:.2f} s (warmup of "
                      f"{len(SERVE_BUCKETS)} buckets included); flush p50 "
                      f"{lead['flush_p50_ms']:.2f} ms (host-staged "
                      f"all-reduces) ({card})")
    return {"one": {k: v for k, v in one.items()
                    if k not in ("tokens", "plain_tokens")},
            "tp2": {"wall_s": wall, "flush_p50_ms": lead["flush_p50_ms"],
                    "digest_equal": True}}


def serve_mesh_world(world, device, timeout=600, scheduler="slots"):
    """(b) at ``{tp: world}``: the ranks as child processes on this card;
    their reports."""
    port = free_port()
    outs = [os.path.join(CKPT_ROOT, f"serve_mesh_{scheduler}_{world}_{r}"
                                    f".json")
            for r in range(world)]
    os.makedirs(CKPT_ROOT, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve-mesh-child",
         str(world), str(r), str(port), outs[r], device, scheduler],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (f"serve-mesh rank {r} of {world} exited "
                                   f"{p.returncode}:\n{logs[r][-6000:]}")
    reports = []
    for path in outs:
        with open(path) as f:
            reports.append(json.load(f))
    return reports


def serve_mesh_phase(views, device, fp32, card):
    """``[serve-mesh]``: (a) a world of one over NCCL through HTTP, graphs
    on; (b) tp 2 and tp 4 with every rank on this card. Returns the
    phase's numbers."""
    one = serve_mesh_one(views, device, fp32)
    log("serve-mesh", f"(a) serve.mesh {{tp: 1}}, a world of one over NCCL "
                      f"through HTTP: fp32 greedy tokens == the plain "
                      f"engine's on the 10 requests (the HTTP burst's "
                      f"equal too: {one['http_tokens_equal']}); "
                      f"{one['graphs']['graphs']} CUDA graphs captured "
                      f"with the mesh's all-reduces inside (2 a layer in "
                      f"the step), 0 recompiles; paged decode launches "
                      f"{one['launches']} == layers x {one['steps']} "
                      f"steps; /healthz mesh {one['mesh']}; step p50 "
                      f"{one['step_p50_ms']:.2f} ms on the mesh, "
                      f"{one['plain_step_p50_ms']:.2f} ms plain ({card})")
    worlds = {}
    for world in (2, 4):
        ranks = serve_mesh_world(world, device)
        lead = ranks[0]
        assert lead["tokens"] == fp32, f"tp {world} tokens != (a)'s"
        H = GPT2_SPEC["n_head"] // world
        hd = GPT2_SPEC["d_model"] // GPT2_SPEC["n_head"]
        for r in ranks:
            assert r["digest"] == lead["digest"], \
                f"tp {world} rank {r['rank']}'s tokens diverged"
            if device == "cuda":
                assert r["launches"] == r["layers"] * r["steps"] > 0, r
            assert r["heads"] == [[H, H, hd]], r["heads"]
            assert r["recompiles"] == 0, r
            assert r.get("rc", 0) == 0, r
            assert device != "cuda" or "gloo" in r["refused"], r
        worlds[world] = {
            "launches": sum(r["launches"] for r in ranks),
            "launches_per_rank": lead["launches"], "steps": lead["steps"],
            "heads": H, "step_p50_ms": lead["step_p50_ms"],
            "kv": lead["kv"], "mesh": lead["mesh"]}
        log("serve-mesh", f"(b) serve.mesh {{tp: {world}}}, {world} gloo "
                          f"ranks on this card (graphs refused over gloo at "
                          f"construction, which cannot be captured; run "
                          f"with graphs off): fp32 greedy tokens == (a)'s, "
                          f"every "
                          f"rank's token digest equal, paged decode on "
                          f"{H}-head shards (hd {hd}) {lead['launches']} "
                          f"launches a rank == layers x {lead['steps']} "
                          f"steps; pool {lead['kv']['pool_gb_per_device']}"
                          f" GB a rank of {lead['kv']['pool_gb']} GB; step "
                          f"p50 {lead['step_p50_ms']:.2f} ms (host-staged "
                          f"all-reduces) ({card})")
    static = serve_mesh_static_phase(views, device, card)
    return {"one": one, "worlds": worlds, "static": static,
            "launches": one["launches"] + sum(w["launches"]
                                              for w in worlds.values())}


# --------------------------------------------------------------------- #
# 7. train: the PPO main path at gpt2-124M width
# --------------------------------------------------------------------- #


def train_config_dict(compute_dtype="bfloat16", fused=True, ppo_epochs=4):
    """examples/ppo_tldr.py's config (configs/ppo_tldr.yml through the
    port example's dict, no pyyaml on the card machine) at gpt2-124M
    width: 2 unfrozen layers, 512 prompt + 64 generated tokens, batch
    32, 64 rollouts in chunks of 32, ``ppo_epochs`` PPO epochs; the byte
    tokenizer, seeded random weights; one epoch of 8 passes, stats every
    4, eval and checkpoints beyond the run."""
    cfg = ppo_tldr.tldr_config()
    cfg["model"].update(model_path="from-config", tokenizer_path="byte",
                        model_spec=dict(GPT2_SPEC),
                        compute_dtype=compute_dtype, fused_attention=fused)
    cfg["train"].update(epochs=1, total_steps=8, log_interval=4,
                        eval_interval=10**9, checkpoint_interval=10**9)
    cfg["method"].update(ppo_epochs=ppo_epochs)
    return cfg


#: configs/ppo_config.yml's run-supervisor and telemetry block, as
#: shipped (no pyyaml on the card machine)
SUPERVISED = {"stall_timeout": 300, "stall_grace": 120,
              "host_call_timeout": 60, "max_walltime": 0,
              "telemetry": True, "telemetry_dir": "",
              "telemetry_flush_every": 0}


def tldr_config_dict(run_dir, seed=0):
    """:func:`train_config_dict` in bf16 with fused attention, the commit
    gate on (``max_bad_steps`` 2) and a step checkpoint every 4 passes
    under ``run_dir``, the newest 2 kept; supervised with
    :data:`SUPERVISED`, and logging through ``train.tracker`` to
    ``<run_dir>/metrics.jsonl``."""
    cfg = train_config_dict()
    cfg["train"].update(checkpoint_interval=4, keep_checkpoints=2,
                        max_bad_steps=2, checkpoint_dir=run_dir, seed=seed,
                        tracker=f"jsonl:{run_dir}/metrics.jsonl",
                        **SUPERVISED)
    return cfg


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def rounded(seconds):
    """A dict of seconds rounded to ms, for printing."""
    return {k: round(v, 3) for k, v in seconds.items()}


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_run_floor(run_dir, records, device, peak_gb):
    """What a supervised learn() leaves: ``telemetry.json`` and
    ``trace.jsonl`` in ``run_dir``, every ``fault/*`` counter at 0, and
    per-iteration records that carry ``time/*``, ``throughput/*`` (MFU
    in (0, 1) on the card) and the ``device/hbm_*`` gauges, whose peak
    is ``torch.cuda.max_memory_allocated()`` at the learn's exit."""
    with open(os.path.join(run_dir, "telemetry.json")) as f:
        summary = json.load(f)
    trace = read_jsonl(os.path.join(run_dir, "trace.jsonl"))
    faults = {k: v for k, v in summary["counters"].items()
              if k.startswith("fault/")}
    assert faults and not any(faults.values()), faults
    last = records[-1]
    want = ["throughput/samples_per_sec", "throughput/tokens_per_sec"]
    if device == "cuda":
        want += ["throughput/mfu", "device/hbm_in_use_gb",
                 "device/hbm_peak_gb", "device/hbm_limit_gb",
                 "device/hbm_utilization"]
        assert 0 < last["throughput/mfu"] < 1, last["throughput/mfu"]
        assert summary["gauges"]["device/hbm_peak_gb"] == peak_gb, \
            (summary["gauges"]["device/hbm_peak_gb"], peak_gb)
    missing = [k for k in want if k not in last]
    assert not missing and any(k.startswith("time/") for k in last), \
        missing
    return {"summary": summary, "trace_events": len(trace),
            "trace_names": sorted({e["name"] for e in trace}),
            "last": last}


def train_phase(tree, device, run_dir):
    """registry -> pipeline -> orchestrator.make_experience -> learn(),
    with the reward model built from the trainer's own trunk scoring on
    the device, every launch counter at 0 just before and read just
    after. Supervised as configs/ppo_config.yml ships it; learn() gets no
    log_fn, so its stats go to the jsonl tracker, one record per logged
    iteration. Two step checkpoints land in ``run_dir``; every logged
    ``bad_step`` is 0; ``telemetry.json`` and ``trace.jsonl`` land there
    too (:func:`check_run_floor`)."""
    cfg = TRLConfig.from_dict(tldr_config_dict(run_dir))
    spec, m = cfg.model.resolve_spec(), cfg.method
    trainer = get_model(cfg.model.model_type)(cfg, device=device,
                                              params=tree)
    reward_model = ppo_tldr.build_reward_model(cfg, trainer)
    pipeline = get_pipeline(cfg.train.pipeline)(
        ppo_tldr.synthetic_documents(64), trainer.tokenizer, cfg)
    orch = get_orchestrator(cfg.train.orchestrator)(
        trainer, pipeline, reward_fn=reward_model, chunk_size=m.chunk_size)
    ops.reset_launches()
    t0 = time.perf_counter()
    info = orch.make_experience(m.num_rollouts)
    trainer.learn()
    torch.cuda.synchronize() if device == "cuda" else None
    wall = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() / 2**30
               if device == "cuda" else 0.0)
    all_launches = dict(ops.LAUNCHES)
    launches = {n: all_launches[n] for n in FLASH_NAMES}
    L, k = spec.n_layer, trainer.policy.k
    chunks = m.num_rollouts // m.chunk_size
    passes = trainer.iter_count
    want = {"flash_fwd": chunks * (L + k) + passes * L,
            "flash_bwd_dq": passes * k, "flash_bwd_dkv": passes * k}
    if device == "cuda":
        assert launches == want, f"flash launches {launches} != {want}"
    records = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    train_logs = [entry for entry in records if "loss" in entry]
    assert len(records) == len(train_logs) == passes // m.ppo_epochs, \
        records
    assert np.isfinite(info["mean_kl"]) and np.isfinite(info["mean_score"])
    for entry in train_logs:
        for key in ("loss", "pg_loss", "vf_loss", "grad_norm", "approx_kl"):
            assert np.isfinite(entry[key]), (key, entry)
        assert entry["bad_step"] == 0.0, entry
    steps = sorted(e for e in os.listdir(run_dir) if e.startswith("step_"))
    assert steps == ["step_4", "step_8"], steps
    # the rollouts replay one captured decode step: one signature, no
    # recompile
    assert recompiles() == 0, f"PPO recompiled {recompiles()} times"
    assert trainer.decoder.step.signatures() == 1
    with open(os.path.join(run_dir, "LATEST")) as f:
        assert f.read() == "step_8"
    floor = check_run_floor(run_dir, train_logs, device, peak_gb)
    sup = trainer.supervisor
    assert (sup.stall_timeout, sup.stall_grace) == (300, 120)
    assert sup.stalls == 0 and not sup.escalated
    hists = telemetry.current().registry.hists
    batch = trainer.store._stacked().map(lambda x: x[:cfg.train.batch_size])
    save = hists["time/checkpoint_save"]
    return {
        "trainer": trainer, "orch": orch, "launches": launches,
        "all_launches": all_launches, "want": want, "chunks": chunks,
        "passes": passes, "wall_s": wall, "info": info, "logs": train_logs,
        "rollout_s": hists["time/rollout"].total,
        "update_s": hists["time/ppo_update"].total,
        "samples_per_sec": train_logs[-1]["samples_per_sec"],
        "batch": batch, "checkpoints": steps,
        "save_ms": [save.first * 1e3] + [t * 1e3 for t in save.window],
        "checkpoint_bytes": dir_bytes(os.path.join(run_dir, "step_8")),
        "graphs": graph_stats(trainer.decoder.step.graphs()),
        "first_call_s": dict(sup.first_call_s), "peak_gb": peak_gb,
        "mfu": floor["last"].get("throughput/mfu"),
        "trace_events": floor["trace_events"],
        "trace_names": floor["trace_names"],
    }


def leaves_of(trainer):
    """Every tensor a trainer restores: params, then optimizer state."""
    return [x for tree in (trainer.params, trainer.opt_state)
            for _, x in named_leaves(tree)]


def assert_same_state(a, b, what):
    """Bit-identical params, optimizer state (count, mu, nu) and sampling
    generator state; zero-size leaves included."""
    pairs = list(zip(named_leaves(a.params) + named_leaves(a.opt_state),
                     named_leaves(b.params) + named_leaves(b.opt_state)))
    assert len(pairs) == len(leaves_of(b))
    for (name, x), (_, y) in pairs:
        assert x.shape == y.shape and x.dtype == y.dtype \
            and torch.equal(x, y), f"{what}: {name} differs"
    assert torch.equal(a.generator.get_state(), b.generator.get_state()), \
        f"{what}: generator state differs"
    return len(pairs), sum(x.numel() == 0 for (_, x), _ in pairs)


def resume_phase(trainer, batch, device, run_dir):
    """A fresh trainer from another seed with ``resume_from: auto``
    restores LATEST at construction; its next update on ``batch`` equals
    the original trainer's next update from the same state, bit for bit
    (params, mu, nu, count, generator state)."""
    cfg = TRLConfig.from_dict(tldr_config_dict(run_dir, seed=1))
    cfg.train.resume_from = "auto"
    t0 = time.perf_counter()
    fresh = get_model(cfg.model.model_type)(cfg, device=device)
    sync(device)
    restore_s = time.perf_counter() - t0
    with open(os.path.join(run_dir, "LATEST")) as f:
        latest = int(f.read().split("_")[1])
    assert fresh.iter_count == trainer.iter_count == latest, \
        (fresh.iter_count, trainer.iter_count, latest)
    assert fresh.kl_ctl.value == trainer.kl_ctl.value
    n, empty = assert_same_state(trainer, fresh, "restored state")
    ops.reset_launches()
    stats = [t.train_step(batch) for t in (trainer, fresh)]
    sync(device)
    launches = {name: ops.LAUNCHES[name] for name in FLASH_NAMES}
    for st in stats:
        assert float(st["bad_step"]) == 0.0, st
    assert float(stats[0]["loss"]) == float(stats[1]["loss"])
    assert_same_state(trainer, fresh, "next update")
    del fresh
    torch.cuda.empty_cache() if device == "cuda" else None
    return {"restore_s": restore_s, "step": latest, "leaves": n,
            "zero_size_leaves": empty, "launches": launches}


def gate_phase(trainer, batch, device):
    """The commit gate on the card: a batch with NaN rewards gives
    ``bad_step`` 1 and leaves params, moments and count bit-identical; the
    guarded step runs under ``torch.cuda.set_sync_debug_mode("error")``,
    so a host sync inside it fails the phase. The next clean batch
    commits."""
    before = [x.detach().clone() for x in leaves_of(trainer)]
    count = int(trainer.opt_state["count"])
    poisoned = batch.map(lambda x: x)
    poisoned.rewards = torch.full_like(batch.rewards, float("nan"))
    sync(device)
    ops.reset_launches()
    if device == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        stats = trainer.train_step(poisoned)
    finally:
        if device == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    sync(device)
    launches = {name: ops.LAUNCHES[name] for name in FLASH_NAMES}
    assert float(stats["bad_step"]) == 1.0, stats
    assert not np.isfinite(float(stats["loss"]))
    for x, y in zip(before, leaves_of(trainer)):
        assert torch.equal(x, y), "a skipped step changed the state"
    assert int(trainer.opt_state["count"]) == count
    stats = trainer.train_step(batch)
    assert float(stats["bad_step"]) == 0.0, stats
    assert int(trainer.opt_state["count"]) == count + 1
    moved = sum(not torch.equal(x, y)
                for x, y in zip(before, leaves_of(trainer)))
    assert moved > 0
    if device == "cuda":
        assert all(launches[name] > 0 for name in FLASH_NAMES), launches
    return {"launches": launches, "moved_leaves": moved,
            "sync_checked": device == "cuda"}


def greedy_run_config(run_dir):
    """(the run directory's newest checkpoint, the config embedded in its
    meta.json, that config with greedy sampling)."""
    with open(os.path.join(run_dir, "LATEST")) as f:
        latest = os.path.join(run_dir, f.read())
    with open(os.path.join(latest, "meta.json")) as f:
        meta_config = json.load(f)["config"]
    greedy = dict(meta_config)
    greedy["method"] = {**greedy["method"],
                        "gen_kwargs": {"max_length": 64, "do_sample": False}}
    return latest, meta_config, greedy


def serve_checkpoint_phase(trainer, device, run_dir, requests):
    """The serve CLI's ``--checkpoint`` loader on the PPO run directory
    (the newest step, the config from meta.json with greedy sampling put
    in by ``--config``), against an engine built from the trainer's
    in-memory params: identical greedy tokens on ``requests``, and the
    paged-decode kernel launches (layers x decode steps)."""
    latest, meta_config, greedy = greedy_run_config(run_dir)
    assert meta_config == trainer.config.to_nested_dict()
    config_path = os.path.join(run_dir, "greedy.json")
    with open(config_path, "w") as f:
        json.dump(greedy, f)
    flags = ["--checkpoint", run_dir, "--config", config_path,
             "--buckets", "2x512x32", "--slots", "2", "--page-size", "16",
             "--attention", "pallas", "--device", device]
    telemetry.start()
    t0 = time.perf_counter()
    engine = serve_cli.build_engine(serve_cli.build_parser().parse_args(
        flags))
    sync(device)
    load_s = time.perf_counter() - t0
    assert engine.checkpoint_path == latest
    live = InferenceEngine(
        TRLConfig.from_dict(greedy), serve=engine.serve,
        views=decode_views_from_numpy(trainer.params, engine.spec,
                                      trainer.policy.num_layers_unfrozen),
        device=device)
    out = {}
    for label, e in (("checkpoint", engine), ("in-memory", live)):
        ops.reset_launches()
        tokens, sched = run_scheduler(e, requests)
        out[label] = tokens
        if label == "checkpoint":
            launches = ops.LAUNCHES["paged_decode"]
            steps = sched.runtime.steps
    assert out["checkpoint"] == out["in-memory"], out
    if device == "cuda":
        assert launches == engine.spec.n_layer * steps > 0, (launches, steps)
    assert recompiles() == 0, f"serve recompiled {recompiles()} times"
    return {"load_s": load_s, "launches": launches, "steps": steps,
            "layers": engine.spec.n_layer, "tokens": out["checkpoint"]}


#: the draft tier's requests: every history (prompt + tokens so far)
#: fits the draft's 32-token window, so the draft sees what the target sees
DRAFT_REQUESTS = [("Hi", 24), ("What is 2+2?", 16), ("Tell a story", 16),
                  ("x", 24)]


def self_draft_counts(tokens, max_new, k):
    """(proposed, accepted) that a self-draft gives one request whose
    emitted tokens are ``tokens``. As in trlx_tpu, each step ships the
    first k drafted tokens, which continue the history from the free
    token t0 on; proposal j is accepted iff it equals the greedy token
    after candidate j - 1, i.e. iff the draft's token j - 1 repeats
    token j - 2 (counting t0 as 0): from emitted index i a step accepts
    the run of repeats that starts at ``tokens[i]``, capped by the
    budget (the free token spends one) and by the request's end."""
    i = proposed = accepted = 0
    while i < len(tokens):
        n = max(0, min(k, max_new - i - 1))
        m = 0
        while m < n and i + m + 1 < len(tokens) \
                and tokens[i + m + 1] == tokens[i + m]:
            m += 1
        proposed += n
        accepted += m
        i += m + 1
    return proposed, accepted


def spec_draft_phase(device, run_dir):
    """``speculation: draft`` with the PPO run directory's newest params
    as both target and draft (greedy, 4 slots, the kernel path for plain
    steps), re-saved as one checkpoint whose embedded config computes in
    float32, so the draft (which computes in its checkpoint's dtype)
    proposes the target's own greedy tokens. The tokens equal the same
    checkpoint's with speculation off; no proposal falls back; the
    proposal and acceptance counts equal what trlx_tpu's rule gives a
    self-draft on those tokens (:func:`self_draft_counts`); 0
    recompiles (the draft's whole generate is one graph)."""
    latest, _, greedy = greedy_run_config(run_dir)
    greedy["model"] = {**greedy["model"], "compute_dtype": "float32"}
    params, _, _ = restore_tensor_component("params", latest)
    ckpt = os.path.join(CKPT_ROOT, "ppo_fp32", os.path.basename(latest))
    save_components({"params": params, "config": greedy}, ckpt)
    del params
    out = {}
    for mode in ("off", "draft"):
        telemetry.start()
        serve = ServeConfig(buckets=[[4, 16, 24]], slots=4, page_size=16,
                            attention="pallas", max_queue=64,
                            request_timeout=600.0, speculation=mode,
                            spec_k=4, spec_draft_checkpoint=ckpt)
        engine = InferenceEngine.from_checkpoint(ckpt, serve=serve,
                                                 device=device)
        tokens, sched = run_scheduler(engine, DRAFT_REQUESTS)
        assert recompiles() == 0, f"{mode}: {recompiles()} recompiles"
        counters = telemetry.current().registry.counters
        out[mode] = {
            "tokens": tokens, "steps": sched.runtime.steps,
            "verify_steps": sched.runtime.verify_steps,
            "proposed": counters.get("serve/spec_proposed", 0.0),
            "accepted": counters.get("serve/spec_accepted", 0.0),
            "fallbacks": counters.get("serve/spec_fallbacks", 0.0),
            "verify_p50_ms": p50_ms(SlotPoolRuntime.VERIFY_SPAN),
            "step_p50_ms": p50_ms(SlotPoolRuntime.STEP_SPAN),
            "makespan_s": makespan_s(),
            "graphs": graph_stats(sched.graphs()),
            "kv": sched.pool_stats(),
        }
        del engine, sched
        release(device)
    d = out["draft"]
    assert d["tokens"] == out["off"]["tokens"], \
        "draft speculation changed the greedy tokens"
    assert d["fallbacks"] == 0, \
        f"{d['fallbacks']} draft proposal faults fell back to plain steps"
    assert d["proposed"] > 0 and d["verify_steps"] > 0, d
    want = [self_draft_counts(t, n, 4)
            for t, (_, n) in zip(d["tokens"], DRAFT_REQUESTS)]
    d["predicted"] = [sum(x) for x in zip(*want)]
    assert [d["proposed"], d["accepted"]] == d["predicted"], (
        f"self-draft proposed/accepted {d['proposed']}/{d['accepted']} != "
        f"{d['predicted']}, trlx_tpu's rule on the emitted tokens")
    for r in out.values():
        r["tokens_total"] = sum(len(t) for t in r.pop("tokens"))
    return out


# --------------------------------------------------------------------- #
# 7b. the serve lifecycle: tracing, tenants, replay, hot-swap, drain and
# the serve watchdog, on the PPO run directory
# --------------------------------------------------------------------- #

#: the over-quota tenant's bucket: two requests, then (at 0.01 rps) a
#: 429 whose Retry-After is the bucket's refill time (100 s)
LIFECYCLE_TENANTS = {"miser": {"rps": 0.01, "burst": 2}}


def http(url, payload=None, headers=None, timeout=600):
    """(status, headers, body) of one request; an HTTP error status is a
    response here, not an exception. The body is parsed as JSON unless
    it is text."""
    req = urllib.request.Request(
        url, method="GET" if payload is None else "POST",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, hdrs, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, dict(e.headers), e.read()
    text = raw.decode()
    if hdrs.get("Content-Type", "").startswith("application/json"):
        return status, hdrs, json.loads(text)
    return status, hdrs, text


def engine_ptrs(engine):
    """Every serving tensor's address: a swap must keep each one."""
    return [t.data_ptr() for t in aotjit.tree_flatten(
        (engine.blocks, engine.embed, engine.ln_f))[0]]


def lifecycle_engine(checkpoint, config, device, **serve):
    """An engine on a checkpoint of the PPO run at phase 5's lattice (16
    slots, pages of 16, the kernel path), greedy."""
    cfg = ServeConfig(**{"buckets": [list(b) for b in SERVE_BUCKETS],
                         "slots": 16, "page_size": 16,
                         "attention": "pallas", "max_queue": 256,
                         "request_timeout": 600.0, **serve})
    return InferenceEngine.from_checkpoint(
        checkpoint, config=TRLConfig.from_dict(config), serve=cfg,
        device=device)


def serve_ordered(sched, engine, requests=USER_PROMPTS):
    """``requests`` through a RUNNING scheduler, all queued under its
    lock (one admission order, as :func:`run_scheduler` gives a stopped
    one); their tokens."""
    with sched._cond:
        reqs = [sched.submit(engine.encode_prompt(p), max_new_tokens=n)
                for p, n in requests]
    return [r.wait(timeout=600).result for r in reqs]


def step_ms_p50(records):
    """Median whole-step wall time (ms) of flight-recorder records: the
    device step plus the harvest and its tracing bookkeeping."""
    return float(np.median([r["step_ms"] for r in records])) \
        if records else None


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServeWatchdogDrive:
    """Two ``python -m trlx_tpu_torch.serve`` children at gpt2 width
    (seeded weights, bf16, the kernel path), started with the PPO phase
    and checked by ``[serve-lifecycle]``: one with ``stall_timeout: 2`` and
    a ``serve_decode`` chaos hang at its sixth step, which must exit 70
    after printing the flight recorder beside the stall's stack dump;
    one sent SIGTERM while idle, which must drain clean and exit 0. A
    thread of this process feeds them; :meth:`finish` checks, and
    :meth:`kill` stops whatever is left."""

    def __init__(self, root, device):
        self.root, self.device = root, device
        self.procs, self.ports, self.out = {}, {}, {}
        self.error, self.result = None, None

    def _start(self, name, chaos_spec):
        os.makedirs(self.root, exist_ok=True)
        cfg = config_dict("bfloat16")
        cfg["serve"] = {"buckets": [[2, 16, 16]], "slots": 2,
                        "page_size": 16, "attention": "pallas",
                        "stall_timeout": 2.0, "request_timeout": 600.0,
                        "drain_timeout": 30.0}
        path = os.path.join(self.root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        self.ports[name] = free_port()
        env = dict(os.environ, TRLX_TPU_CHAOS=chaos_spec)
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        log_path = os.path.join(self.root, f"{name}.log")
        self.out[name] = log_path
        with open(log_path, "w") as log_file:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "trlx_tpu_torch.serve", "--config",
                 path, "--port", str(self.ports[name]), "--device",
                 self.device],
                stdout=log_file, stderr=subprocess.STDOUT, cwd=here,
                env=env)

    def start(self):
        self.t0 = time.perf_counter()
        self._start("stall", "serve_decode:hang@6")
        self._start("sigterm", "")
        self.thread = threading.Thread(target=self._drive, daemon=True,
                                       name="serve-watchdog-drive")
        self.thread.start()

    def _ready(self, name, timeout=600):
        url = f"http://127.0.0.1:{self.ports[name]}/readyz"
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            assert self.procs[name].poll() is None, (
                f"serve child '{name}' exited {self.procs[name].returncode}"
                f" before it was ready")
            try:
                if http(url, timeout=5)[0] == 200:
                    return
            except OSError:
                pass
            time.sleep(0.25)
        raise AssertionError(f"serve child '{name}' never became ready")

    def _drive(self):
        try:
            out = {}
            self._ready("stall")
            base = f"http://127.0.0.1:{self.ports['stall']}"
            status, _, body = http(f"{base}/generate",
                                   {"prompt": "Hi", "max_new_tokens": 4})
            assert status == 200 and len(body["tokens"]) == 4, body
            hung_at = time.perf_counter()
            try:  # the child dies under this request
                http(f"{base}/generate", {"prompt": "Hi",
                                          "max_new_tokens": 16},
                     timeout=300)
            except OSError:
                pass
            rc = self.procs["stall"].wait(timeout=300)
            out["stall"] = {"exit": rc,
                            "s": time.perf_counter() - hung_at}
            self._ready("sigterm")
            t = time.perf_counter()
            self.procs["sigterm"].send_signal(signal.SIGTERM)
            rc = self.procs["sigterm"].wait(timeout=120)
            out["sigterm"] = {"exit": rc, "s": time.perf_counter() - t}
            self.result = out
        except BaseException as e:  # re-raised by finish()
            self.error = e
        self.wall_s = time.perf_counter() - self.t0

    def finish(self, timeout=600):
        self.thread.join(timeout)
        assert not self.thread.is_alive(), "the serve children hung"
        if self.error is not None:
            raise self.error
        logs = {}
        for name, path in self.out.items():
            with open(path) as f:
                logs[name] = f.read()
        out = self.result
        stall, sigterm = logs["stall"], logs["sigterm"]
        assert out["stall"]["exit"] == 70, (out, stall[-6000:])
        assert "STALL: phase 'serve_decode'" in stall, stall[-6000:]
        assert "FLIGHT RECORDER (watchdog stall): last 5 engine steps" \
            in stall, stall[-6000:]
        assert "STALL ESCALATION: phase 'serve_decode'" in stall
        assert out["sigterm"]["exit"] == 0, (out, sigterm[-6000:])
        assert "SIGTERM: beginning graceful drain" in sigterm, sigterm
        assert "drained (clean)" in sigterm, sigterm[-6000:]
        out["wall_s"] = self.wall_s
        out["recorder_lines"] = sum(
            1 for ln in stall.splitlines()
            if ln.startswith('[trlx_tpu_torch.serve] {"step"'))
        return out

    def kill(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        if hasattr(self, "thread"):
            self.thread.join(30)


def serve_lifecycle_phase(device, run_dir, watchdog):
    """The serve lifecycle on the PPO run directory at gpt2 width: an
    in-process ``InferenceServer`` on its newest step (bf16, greedy, the
    kernel path, 16 slots, pages of 16) with a tenant table, then

    - tracing: the 10 ``USER_PROMPTS`` over HTTP, each response with a
      ``trace_id``; ``serve/ttft`` and ``serve/itl`` with >= 10
      observations; Prometheus text on ``Accept: text/plain``;
      ``/debug/slo`` and ``/debug/state`` 200;
    - tenants: the over-quota tenant's third request 429 with
      ``Retry-After`` while the default tenant is served; a request whose
      ``deadline_ms`` (1) passes while it waits for the queue: 503;
    - replay at bf16: the 10 requests with a ``serve_decode`` fault at
      their third step against the same run without it (the divergence
      printed, not asserted); replays > 0, no request error. The third:
      two committed tokens keep the longest prompt (30 bytes) inside the
      32-token prompt class; a later fault ends it with
      ``ReplayExhausted``, as in trlx_tpu;
    - hot-swap: ``POST /admin/reload`` to the older ``step_<N>``: 200,
      ``model_version`` 2, then a ``serve_reload`` fault: 409, the version
      and the tokens unchanged; both times 0 recompiles and every engine
      tensor at its address; the swapped engine's tokens equal a fresh
      engine's on that step (built after the server stopped, tracing
      off: the step p50 without tracing);
    - drain: ``POST /admin/drain`` with the 10 requests in flight (steps
      slowed by a chaos ``slow``): 202, a new request 429, ``/readyz``
      503, every in-flight request 200 and whole, the drain clean;
    - replay at fp32: an fp32 engine on the same step, the 10 requests
      with and without a ``serve_decode`` fault: identical tokens,
      replays > 0, no request error;
    - the watchdog children (:class:`ServeWatchdogDrive`) checked.

    Paged-decode launches are counted from 0 just before the server
    starts to just after it drained: > 0, and layers x decode steps."""
    t_phase = time.perf_counter()
    latest, _, greedy = greedy_run_config(run_dir)
    older = sorted((d for d in os.listdir(run_dir)
                    if d.startswith("step_") and ".tmp-" not in d
                    and os.path.join(run_dir, d) != latest),
                   key=lambda d: int(d.split("_")[1]))[-1]
    older = os.path.join(run_dir, older)
    telemetry.start()
    registry = telemetry.current().registry
    engine = lifecycle_engine(latest, greedy, device,
                              tenants=LIFECYCLE_TENANTS,
                              drain_timeout=120.0)
    L = engine.spec.n_layer
    ops.reset_launches()
    server = InferenceServer(engine, host="127.0.0.1", port=0).start()
    sched = server.scheduler
    base = f"http://127.0.0.1:{server.port}"
    out = {}
    try:
        # -- tracing ---------------------------------------------------- #
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(USER_PROMPTS)) as pool:
            replies = list(pool.map(
                lambda r: http(f"{base}/generate",
                               {"prompt": r[0], "max_new_tokens": r[1],
                                "trace": r[0] == "Hi"}),
                USER_PROMPTS))
        out["burst_s"] = time.perf_counter() - t0
        for status, headers, body in replies:
            assert status == 200, body
            assert body["trace_id"] and headers["X-Request-Id"] == \
                body["trace_id"], body
            assert body["model_version"] == 1
        traced = next(b["trace"] for _, _, b in replies if "trace" in b)
        hists = registry.hists
        ttft, itl = hists["serve/ttft"], hists["serve/itl"]
        assert ttft.count >= 10 and itl.count >= 10, (ttft.count, itl.count)
        status, headers, text = http(f"{base}/metrics",
                                     headers={"Accept": "text/plain"})
        assert status == 200 and "trlx_tpu_serve_ttft" in text, text[:500]
        assert headers["Content-Type"].startswith("text/plain")
        for route in ("/debug/slo", "/debug/state"):
            status, _, body = http(base + route)
            assert status == 200, (route, body)
        assert body["flight_recorder"], body.keys()
        out["tracing"] = {
            "ttft_p50_ms": ttft.quantile(0.5) * 1e3,
            "ttft_max_ms": ttft.max * 1e3,
            "itl_p50_ms": itl.quantile(0.5) * 1e3,
            "itl_max_ms": itl.max * 1e3,
            "ttft_n": ttft.count, "itl_n": itl.count, "trace": traced,
            "prometheus_lines": len(text.splitlines())}

        # -- tenants and deadlines --------------------------------------- #
        miser = [http(f"{base}/generate", {"prompt": "Hi",
                                           "max_new_tokens": 4},
                      headers={"X-Tenant-Id": "miser"}) for _ in range(3)]
        assert [s for s, _, _ in miser] == [200, 200, 429], miser
        _, headers, body = miser[2]
        assert body["tenant"] == "miser" and int(headers["Retry-After"]) \
            >= 1, (headers, body)
        status, _, body = http(f"{base}/generate",
                               {"prompt": "Hi", "max_new_tokens": 4})
        assert status == 200 and len(body["tokens"]) == 4, body
        # with no slot free the request waits in the queue past its 1 ms,
        # and the worker's next admission scan sheds it
        free, sched._free = sched._free, []
        try:
            late = {"r": http(f"{base}/generate",
                              {"prompt": "Hi", "max_new_tokens": 4,
                               "deadline_ms": 1})}
        finally:
            sched._free = free
        assert late["r"][0] == 503 and "deadline_ms" in \
            late["r"][2]["error"], late
        out["tenants"] = {"miser": [s for s, _, _ in miser],
                          "retry_after_s": int(miser[2][1]["Retry-After"]),
                          "deadline_status": late["r"][0]}

        # -- replay at bf16 (divergence printed) --------------------------- #
        first = sched._step_counter
        bf16 = serve_ordered(sched, engine)
        traced_records = [r for r in sched.flight.snapshot()
                          if r["step"] > first]
        replays0 = registry.counters["serve/replays"]
        errors0 = registry.counters["serve/request_errors"]  # the shed
        chaos.configure("serve_decode:exc@3")
        try:
            bf16_fault = serve_ordered(sched, engine)
        finally:
            chaos.reset()
        replays = registry.counters["serve/replays"] - replays0
        assert replays > 0, "the fault replayed nothing"
        assert registry.counters["serve/request_errors"] == errors0, \
            registry.counters["serve/request_errors"]
        out["replay_bf16"] = {
            "replays": replays,
            "divergence": divergence(bf16_fault, bf16, engine,
                                     USER_PROMPTS)}
        out["step_on"] = {
            "slot_step_p50_ms": hists["time/serve/slot_step"]
            .quantile(0.5) * 1e3,
            "step_ms_p50": step_ms_p50(traced_records)}

        # -- hot-swap ------------------------------------------------------ #
        ptrs = engine_ptrs(engine)
        t0 = time.perf_counter()
        status, _, swap = http(f"{base}/admin/reload",
                               {"checkpoint": older})
        swap_s = time.perf_counter() - t0
        assert status == 200 and swap["reloaded"] is True, swap
        assert swap["model_version"] == engine.model_version == 2, swap
        assert engine_ptrs(engine) == ptrs, "the swap moved a tensor"
        assert recompiles() == 0, f"the swap recompiled {recompiles()}"
        swapped = serve_ordered(sched, engine)
        chaos.configure("serve_reload:exc@1")
        try:
            status, _, failed = http(f"{base}/admin/reload",
                                     {"checkpoint": latest})
        finally:
            chaos.reset()
        assert status == 409 and failed["reloaded"] is False, failed
        assert "ChaosError" in failed["reason"], failed
        assert engine.model_version == 2 and engine_ptrs(engine) == ptrs
        assert serve_ordered(sched, engine) == swapped, \
            "the rolled-back swap changed the tokens"
        t0 = time.perf_counter()  # the restore alone: verify + map
        engine.load_params(older)
        load_s = time.perf_counter() - t0
        assert recompiles() == 0, f"the rollback recompiled {recompiles()}"
        _, _, ready = http(f"{base}/readyz")
        assert ready["model_version"] == 2, ready

        # -- drain with the requests in flight ----------------------------- #
        chaos.configure("serve_decode:slow=0.05@*")
        submitted = registry.counters["serve/requests"]
        try:
            with ThreadPoolExecutor(len(USER_PROMPTS)) as pool:
                burst = [pool.submit(http, f"{base}/generate",
                                     {"prompt": p, "max_new_tokens": n})
                         for p, n in USER_PROMPTS]
                # the drain starts once every request was admitted to
                # the queue: one still on its way would get its 429
                deadline = time.monotonic() + 60
                while registry.counters["serve/requests"] - submitted < \
                        len(USER_PROMPTS) and time.monotonic() < deadline:
                    time.sleep(0.002)
                in_flight = len(sched._live) + sched.queue_depth()
                assert registry.counters["serve/requests"] - submitted == \
                    len(USER_PROMPTS), "the burst never reached the queue"
                assert in_flight > 0, "the burst finished before the drain"
                status, _, body = http(f"{base}/admin/drain", {})
                assert status == 202 and body["draining"] is True, body
                status, headers, body = http(
                    f"{base}/generate", {"prompt": "Hi",
                                         "max_new_tokens": 4})
                assert status == 429 and "draining" in body["error"], body
                assert int(headers["Retry-After"]) >= 1
                status, _, ready = http(f"{base}/readyz")
                assert status == 503 and ready["draining"] is True, ready
                done = [f.result() for f in burst]
        finally:
            chaos.reset()
        for (status, _, body), (_, n) in zip(done, USER_PROMPTS):
            assert status == 200, body
        check_counts([(r, b["tokens"]) for r, (_, _, b) in
                      zip(USER_PROMPTS, done)],
                     engine.tokenizer.eos_token_id)
        assert server._drain_done.wait(120), "the drain never ended"
        assert server._drain_clean is True, "the drain shed requests"
        out["drain"] = {"in_flight": in_flight,
                        "drains": registry.counters["serve/drains"]}
    finally:
        chaos.reset()
        server.stop()
    launches, steps = ops.LAUNCHES["paged_decode"], sched.runtime.steps
    if device == "cuda":
        assert launches == L * steps > 0, (launches, L, steps)
    assert recompiles() == 0, f"the phase recompiled {recompiles()}"
    out.update(launches=launches, steps=steps, layers=L, swap_s=swap_s,
               load_s=load_s,
               counters={k: registry.counters[k] for k in (
                   "serve/replays", "serve/reloads", "serve/reload_failures",
                   "serve/shed_quota", "serve/shed_expired", "serve/drains",
                   "serve/flight_dumps", "serve/request_errors")})
    del engine, sched, server
    release(device)

    # -- a fresh engine on the swapped-to step; the p50 without tracing -- #
    telemetry.start()
    fresh = lifecycle_engine(older, greedy, device, request_tracing=False)
    fresh_tokens, fresh_sched = run_scheduler(fresh, USER_PROMPTS)
    assert fresh_tokens == swapped, divergence(swapped, fresh_tokens,
                                               fresh, USER_PROMPTS)
    out["step_off"] = {
        "slot_step_p50_ms": p50_ms(SlotPoolRuntime.STEP_SPAN),
        "step_ms_p50": step_ms_p50(fresh_sched.flight.snapshot())}
    del fresh, fresh_sched
    release(device)

    # -- replay at fp32: the tokens hold --------------------------------- #
    fp32_config = dict(greedy)
    fp32_config["model"] = {**greedy["model"], "compute_dtype": "float32"}
    telemetry.start()
    fp32 = lifecycle_engine(latest, fp32_config, device)
    clean, _ = run_scheduler(fp32, USER_PROMPTS)
    chaos.configure("serve_decode:exc@3")
    try:
        faulted, _ = run_scheduler(fp32, USER_PROMPTS)
    finally:
        chaos.reset()
    counters = telemetry.current().registry.counters
    assert counters["serve/replays"] > 0, "the fp32 fault replayed nothing"
    assert counters.get("serve/request_errors", 0.0) == 0, counters
    assert faulted == clean, divergence(faulted, clean, fp32, USER_PROMPTS)
    out["replay_fp32"] = {"replays": counters["serve/replays"],
                          "identical": f"{len(clean)}/{len(clean)}"}
    del fp32
    release(device)
    out["watchdog"] = watchdog.finish()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def log_lifecycle(lc, card):
    tr = lc["tracing"]
    log("serve-lifecycle", f"10 traced HTTP requests in "
                           f"{lc['burst_s'] * 1e3:.1f} ms: every response "
                           f"carries a trace_id; serve/ttft {tr['ttft_n']} "
                           f"and serve/itl {tr['itl_n']} observations; "
                           f"Prometheus text ({tr['prometheus_lines']} lines) "
                           f"on Accept: text/plain; /debug/slo and "
                           f"/debug/state 200")
    log("serve-lifecycle", f"smoke figures, not cells: TTFT p50 "
                           f"{tr['ttft_p50_ms']:.2f} ms max "
                           f"{tr['ttft_max_ms']:.2f} ms; inter-token gap p50 "
                           f"{tr['itl_p50_ms']:.3f} ms max "
                           f"{tr['itl_max_ms']:.3f} ms ({card})")
    on, off = lc["step_on"], lc["step_off"]
    log("serve-lifecycle", f"decode step p50, the span "
                           f"(time/serve/slot_step): tracing on "
                           f"{on['slot_step_p50_ms']:.3f} ms, off "
                           f"{off['slot_step_p50_ms']:.3f} ms; the whole "
                           f"step with its harvest (flight recorder): on "
                           f"{on['step_ms_p50']:.3f} ms, off "
                           f"{off['step_ms_p50']:.3f} ms ({card})")
    t = lc["tenants"]
    log("serve-lifecycle", f"tenants: the 2-request bucket answered "
                           f"{t['miser']} (Retry-After "
                           f"{t['retry_after_s']} s) while the default "
                           f"tenant was served; deadline_ms 1 -> "
                           f"{t['deadline_status']}")
    log("serve-lifecycle", f"replay: a serve_decode fault at the 3rd step "
                           f"replayed {lc['replay_fp32']['replays']:.0f} "
                           f"requests at fp32, tokens identical "
                           f"{lc['replay_fp32']['identical']}, no request "
                           f"error; at bf16 "
                           f"{lc['replay_bf16']['replays']:.0f} replayed, "
                           f"divergence {lc['replay_bf16']['divergence']}")
    log("serve-lifecycle", f"hot-swap to the older step: model_version 2 "
                           f"in {lc['swap_s'] * 1e3:.1f} ms (POST "
                           f"/admin/reload: restore, install in place, "
                           f"probe; the restore alone, manifest check and "
                           f"map, {lc['load_s'] * 1e3:.1f} ms), tokens == "
                           f"a fresh engine's on that "
                           f"step; a serve_reload fault: 409, version and "
                           f"tokens unchanged; 0 recompiles, every engine "
                           f"tensor at its address ({card})")
    wd = lc["watchdog"]
    log("serve-lifecycle", f"drain with {lc['drain']['in_flight']} requests "
                           f"in flight: 202, new request 429, /readyz 503, "
                           f"all 10 answered whole, clean; watchdog child: "
                           f"exit {wd['stall']['exit']} "
                           f"{wd['stall']['s']:.1f}s after the hung request "
                           f"(stall_timeout 2 + the 60 s grace), flight "
                           f"recorder {wd['recorder_lines']} records in its "
                           f"dump; SIGTERM child: exit "
                           f"{wd['sigterm']['exit']} in "
                           f"{wd['sigterm']['s']:.2f}s, drained clean")
    log("serve-lifecycle", f"paged decode launches {lc['launches']} == "
                           f"{lc['layers']} layers x {lc['steps']} steps; "
                           f"counters {lc['counters']}; the phase took "
                           f"{lc['wall_s']:.1f}s (the children "
                           f"{wd['wall_s']:.1f}s from their start, beside "
                           f"the phases before it) ({card})")


# --------------------------------------------------------------------- #
# 7c. the fleet: the router in front of two replicas on the PPO run's
# newest step, the obs CLI on its access log; the host C++ data path
# --------------------------------------------------------------------- #

#: bench.py's bench_fleet lattice: one class of 8 x (64 + 32)
FLEET_BUCKETS = [[8, 64, 32]]
FLEET_REQUESTS, FLEET_CLIENTS = 96, 16


def fleet_trace(n=FLEET_REQUESTS, seed=17):
    """bench.py's bench_fleet trace: 4 system prompts of 48 tokens, each
    request one of them (in turn) plus a tail of 2-8 tokens, with
    ``max_new_tokens`` drawn from {4, 8, 16}; [(tokens, max_new)]."""
    rng = np.random.default_rng(seed)
    system = [[int(t) for t in rng.integers(1, 250, size=48)]
              for _ in range(4)]
    return [(system[i % 4] + [int(t) for t in rng.integers(
        1, 250, size=rng.integers(2, 9))], int(rng.choice([4, 8, 16])))
        for i in range(n)]


def fleet_engine(checkpoint, config, device):
    """A replica of the fleet: the checkpoint at bench_fleet's lattice,
    16 slots, pages of 16, the kernel path, greedy."""
    cfg = ServeConfig(buckets=[list(b) for b in FLEET_BUCKETS], slots=16,
                      page_size=16, attention="pallas", max_wait_ms=8.0,
                      max_queue=256, request_timeout=600.0)
    return InferenceEngine.from_checkpoint(
        checkpoint, config=TRLConfig.from_dict(config), serve=cfg,
        device=device)


def link_tree(src, dst):
    """``src`` copied to ``dst`` as hard links where the file system
    allows (the drills rename ``dst`` aside; ``src`` stays)."""
    def link(a, b):
        try:
            os.link(a, b)
        except OSError:
            shutil.copy2(a, b)

    shutil.copytree(src, dst, copy_function=link)


def pct_ms(values, q):
    """bench.py's percentile rule, in ms."""
    if not values:
        return 0.0
    values = sorted(values)
    return values[min(int(q * (len(values) - 1)), len(values) - 1)] * 1e3


def fleet_clients(port, items, on_done=None, clients=FLEET_CLIENTS):
    """``items`` [(index, tokens, max_new)] through ``clients`` HTTP
    client threads against the router; [(status, body)] by index, and the
    threads (started)."""
    import queue

    work = queue.Queue()
    for item in items:
        work.put(item)
    results = {}

    def client():
        while True:
            try:
                i, tokens, max_new = work.get_nowait()
            except queue.Empty:
                return
            status, _, body = http(f"http://127.0.0.1:{port}/generate",
                                   {"tokens": tokens,
                                    "max_new_tokens": max_new,
                                    "trace": True})
            results[i] = (status, body)
            if on_done is not None:
                on_done()

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    return results, threads


def watch_admitting(router, stop):
    """The fewest admitting replicas seen until ``stop`` is set (a
    thread polling every 2 ms); a one-element list."""
    low = [len(router.backends)]

    def poll():
        while not stop.wait(0.002):
            low[0] = min(low[0], router.admitting_count())

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    return low, thread


def fleet_phase(device, run_dir):
    """bench.py's bench_fleet on the port, on a hard-linked copy of the
    PPO run's newest step (its bf16 config made greedy, 16 slots, pages
    of 16, bucket 8 x (64 + 32), the kernel path):

    - direct leg: the 96-request trace (:func:`fleet_trace`) through one
      engine's slot scheduler; its TTFT p95 becomes the fleet's SLO;
    - fleet leg: two in-process ``InferenceServer`` replicas behind the
      router (``trlx_tpu_torch.router``, ``access_log_sample`` 1), the
      same trace from 16 HTTP clients, and ``POST /admin/rollout`` to the
      same step once a quarter of it has landed: the rollout ok and
      ``model_version`` 2 on both, 0 requests lost, 0 recompiles, every
      request's greedy tokens equal to the direct leg's, paged decode
      launches == layers x the two replicas' decode steps;
    - kill drill: one replica's server stopped in the middle of a burst
      of 16: every request 200 with the direct leg's tokens, through
      failover; the replica revived on its port and re-admitted;
    - corrupt-rollout drill: a rollout under ``checkpoint_verify:exc@1``
      answers 409 (the first replica's reload refused), the fleet keeps
      version 2, at least one replica admits throughout, the copy is
      quarantined, and the fleet still serves the same tokens;
    - ``python -m trlx_tpu_torch.obs summarize --json`` as a child on the
      router's access log: its request total == ``router/requests``.

    Paged-decode launches are counted from 0 at the phase's start: ==
    layers x every scheduler's decode steps (direct leg, replicas, the
    revived one)."""
    t_phase = time.perf_counter()
    latest, _, greedy = greedy_run_config(run_dir)
    root = os.path.join(CKPT_ROOT, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    step = os.path.join(root, "run", os.path.basename(latest))
    link_tree(latest, step)
    trace = fleet_trace()
    out = {"dtype": greedy["model"]["compute_dtype"]}
    ops.reset_launches()

    # -- direct leg: one engine, its slot scheduler, no HTTP ------------- #
    telemetry.start()
    engine = fleet_engine(step, greedy, device)
    L = engine.spec.n_layer
    sched = SlotScheduler(engine)
    sched.warmup()
    sched.start()
    try:
        t0 = time.perf_counter()
        reqs = [sched.submit(list(t), max_new_tokens=n) for t, n in trace]
        for r in reqs:
            r.wait(timeout=600)
        direct_s = time.perf_counter() - t0
    finally:
        sched.stop()
    for r in reqs:
        assert r.error is None, r.error
    direct = [list(r.result) for r in reqs]
    ttfts = [r.trace.ttft() for r in reqs
             if r.trace is not None and r.trace.first_token]
    slo_ms = max(pct_ms(ttfts, 0.95), 1.0)
    steps = sched.runtime.steps
    direct_launches = ops.LAUNCHES["paged_decode"]
    if device == "cuda":
        assert direct_launches == L * steps > 0, (direct_launches, L, steps)
    direct_retries = telemetry.current().registry.counters.get(
        "compile/capture_retries", 0.0)
    out["direct"] = {"tok_per_s": sum(map(len, direct)) / direct_s,
                     "s": direct_s, "ttft_p95_ms": slo_ms,
                     "tokens": sum(map(len, direct))}
    del engine, sched, reqs
    release(device)

    # -- fleet leg: two replicas behind the router, a rollout mid-trace - #
    telemetry.start()
    registry = telemetry.current().registry
    everyone = [InferenceServer(fleet_engine(step, greedy, device),
                                host="127.0.0.1", port=0).start()
                for _ in range(2)]
    servers = list(everyone)
    access = os.path.join(root, "access.jsonl")
    router = FleetRouter(RouterConfig(
        backends=[f"127.0.0.1:{s.port}" for s in servers], port=0,
        page_size=16, probe_interval=0.2, failover_retries=1,
        slo_ttft_ms=slo_ms, rollout_timeout=600.0, request_timeout=600.0,
        access_log=access, access_log_sample=1)).start()
    base = f"http://127.0.0.1:{router.port}"
    try:
        assert router.admitting_count() == 2, router.fleet_state()
        landed = [0]
        lock = threading.Lock()

        def count():
            with lock:
                landed[0] += 1

        t0 = time.perf_counter()
        results, threads = fleet_clients(
            router.port, [(i, t, n) for i, (t, n) in enumerate(trace)],
            on_done=count)
        while landed[0] < FLEET_REQUESTS // 4:
            time.sleep(0.005)
        stop = threading.Event()
        low, watcher = watch_admitting(router, stop)
        t_roll = time.perf_counter()
        status, _, rollout = http(f"{base}/admin/rollout",
                                  {"checkpoint": step})
        rollout_s = time.perf_counter() - t_roll
        stop.set()
        watcher.join(10)
        for t in threads:
            t.join(900)
        fleet_s = time.perf_counter() - t0
        assert status == 200 and rollout["ok"] is True, rollout
        assert [s["model_version"] for s in rollout["steps"]] == [2, 2], \
            rollout
        assert low[0] >= 1, "the rollout left no replica admitting"
        lost = [i for i in range(FLEET_REQUESTS)
                if results.get(i, (None,))[0] != 200]
        assert not lost, [results.get(i) for i in lost[:3]]
        assert recompiles() == 0, f"the fleet recompiled {recompiles()}"
        router.probe_fleet()
        assert registry.gauges["router/fleet_model_version"] == 2.0
        assert [s.engine.model_version for s in servers] == [2, 2]
        fleet = [results[i][1]["tokens"] for i in range(FLEET_REQUESTS)]
        diverged = [i for i in range(FLEET_REQUESTS)
                    if fleet[i] != direct[i]]
        assert not diverged, [(i, fleet[i], direct[i])
                              for i in diverged[:3]]
        leg_steps = sum(s.scheduler.runtime.steps for s in servers)
        leg_launches = ops.LAUNCHES["paged_decode"] - direct_launches
        if device == "cuda":
            assert leg_launches == L * leg_steps > 0, (leg_launches, L,
                                                       leg_steps)
        ttft_fleet = [results[i][1]["trace"]["ttft_ms"]
                      for i in range(FLEET_REQUESTS)]
        out["fleet"] = {
            "tok_per_s": sum(map(len, fleet)) / fleet_s, "s": fleet_s,
            "goodput": sum(1 for t in ttft_fleet if t <= slo_ms)
            / len(ttft_fleet),
            "ttft_p95_ms": pct_ms([t / 1e3 for t in ttft_fleet], 0.95),
            "affinity_hit_rate": registry.gauges[
                "router/affinity_hit_rate"],
            "rollout_s": rollout_s, "min_admitting": low[0],
            "failovers": registry.counters["router/failovers"],
            "launches": leg_launches, "steps": leg_steps,
            "prefix_tokens_saved": registry.counters[
                "serve/prefix_tokens_saved"]}
        out["fleet"]["ratio"] = out["fleet"]["tok_per_s"] \
            / out["direct"]["tok_per_s"]

        # -- kill drill: one replica stopped in the middle of a burst -- #
        failovers0 = registry.counters["router/failovers"]
        burst = [(i, trace[i][0], trace[i][1]) for i in range(16)]
        results, threads = fleet_clients(router.port, burst)

        def in_flight(server):
            return len(server.scheduler._live) \
                + server.scheduler.queue_depth()

        deadline = time.monotonic() + 60
        while max(map(in_flight, servers)) == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        # the replica holding the most of the burst right now
        victim = max(servers, key=in_flight)
        victim.stop()
        for t in threads:
            t.join(900)
        for i, _, _ in burst:
            status, body = results[i]
            assert status == 200, f"request {i} lost in the kill: {body}"
            assert body["tokens"] == direct[i], (i, body["tokens"],
                                                 direct[i])
        revived = InferenceServer(victim.engine, host="127.0.0.1",
                                  port=victim.port).start()
        everyone.append(revived)
        servers[servers.index(victim)] = revived
        deadline = time.monotonic() + 120
        while router.admitting_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.admitting_count() == 2, router.fleet_state()
        out["kill"] = {
            "failovers": registry.counters["router/failovers"] - failovers0,
            "ejections": registry.counters["router/ejections"],
            "readmissions": registry.counters["router/readmissions"]}
        assert out["kill"]["failovers"] >= 1, out["kill"]
        assert out["kill"]["readmissions"] >= 1, out["kill"]

        # -- corrupt-rollout drill: checkpoint_verify:exc@1 --------------- #
        stop = threading.Event()
        low, watcher = watch_admitting(router, stop)
        chaos.configure("checkpoint_verify:exc@1")
        try:
            status, _, aborted = http(f"{base}/admin/rollout",
                                      {"checkpoint": step})
        finally:
            chaos.reset()
            stop.set()
            watcher.join(10)
        assert status == 409 and aborted["ok"] is False, aborted
        assert "chaos-injected" in aborted["steps"][0]["reason"], aborted
        assert low[0] >= 1, "the aborted rollout left no replica admitting"
        assert registry.counters["checkpoint/quarantined"] == 1.0
        assert not os.path.isdir(step), "the drill's step not quarantined"
        router.probe_fleet()
        assert registry.gauges["router/fleet_model_version"] == 2.0
        assert [s.engine.model_version for s in servers] == [2, 2]
        after, threads = fleet_clients(
            router.port, [(i, trace[i][0], trace[i][1]) for i in range(8)])
        for t in threads:
            t.join(900)
        assert all(after[i][0] == 200 and after[i][1]["tokens"] == direct[i]
                   for i in range(8)), after
        out["corrupt"] = {"reason": aborted["steps"][0]["reason"][:120],
                          "min_admitting": low[0]}
        assert recompiles() == 0, f"the drills recompiled {recompiles()}"

        # -- the obs CLI as a child on the access log --------------------- #
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run(
            [sys.executable, "-m", "trlx_tpu_torch.obs", "summarize",
             "--json", access], capture_output=True, text=True, timeout=120,
            cwd=here, env=dict(os.environ, PYTHONPATH=here + os.pathsep
                               + os.environ.get("PYTHONPATH", "")))
        assert proc.returncode == 0, proc.stderr[-4000:]
        summary = json.loads(proc.stdout)["totals"]
        assert summary["requests"] == registry.counters["router/requests"], \
            (summary, registry.counters["router/requests"])
        out["obs"] = {"requests": summary["requests"],
                      "errors": summary["errors"],
                      "failovers": summary["failovers"]}
        out["capture_retries"] = direct_retries + registry.counters.get(
            "compile/capture_retries", 0.0)
    finally:
        chaos.reset()
        router.stop()
        for s in servers:
            s.stop()
    steps += sum(s.scheduler.runtime.steps for s in everyone)
    launches = ops.LAUNCHES["paged_decode"]
    if device == "cuda":
        assert launches == L * steps > 0, (launches, L, steps)
    out.update(launches=launches, steps=steps, layers=L,
               wall_s=time.perf_counter() - t_phase)
    del everyone, servers, router
    release(device)
    shutil.rmtree(root, ignore_errors=True)
    return out


def log_fleet(f, card):
    d, fl = f["direct"], f["fleet"]
    log("fleet", f"{FLEET_REQUESTS} requests (4 system prompts of 48 "
                 f"tokens + 2-8, max_new_tokens 4/8/16, {f['dtype']}, "
                 f"greedy): the direct leg {d['tok_per_s']:.1f} tok/s "
                 f"({d['tokens']} tokens in {d['s']:.3f}s), TTFT p95 "
                 f"{d['ttft_p95_ms']:.1f} ms = the SLO; through the router "
                 f"over 2 replicas {fl['tok_per_s']:.1f} tok/s (ratio "
                 f"{fl['ratio']:.3f}, the rollout window included), "
                 f"goodput {fl['goodput']:.3f} at that SLO, TTFT p95 "
                 f"{fl['ttft_p95_ms']:.1f} ms, router/affinity_hit_rate "
                 f"{fl['affinity_hit_rate']:.3f}, prefix tokens saved "
                 f"{fl['prefix_tokens_saved']:.0f}, failovers "
                 f"{fl['failovers']:.0f}; rollout to model_version 2 on "
                 f"both in {fl['rollout_s']:.3f}s, >= {fl['min_admitting']} "
                 f"admitting; 0 lost, 0 recompiles, tokens == the direct "
                 f"leg's; capture retries {f['capture_retries']:.0f} "
                 f"({card}; for information, not a metric)")
    k, c = f["kill"], f["corrupt"]
    log("fleet", f"kill drill: a replica stopped mid-burst, 16/16 "
                 f"answered 200 with the direct leg's tokens "
                 f"({k['failovers']:.0f} failovers), ejections "
                 f"{k['ejections']:.0f}, re-admitted after its revival "
                 f"(readmissions {k['readmissions']:.0f}); corrupt "
                 f"rollout (checkpoint_verify:exc@1): 409, the copy "
                 f"quarantined, version 2 kept, >= {c['min_admitting']} "
                 f"admitting; obs summarize: {f['obs']['requests']} "
                 f"requests == router/requests ({f['obs']['errors']} "
                 f"errors); paged decode launches {f['launches']} == "
                 f"{f['layers']} layers x {f['steps']} steps (fleet leg "
                 f"{fl['launches']} = {f['layers']} x {fl['steps']}); the "
                 f"phase took {f['wall_s']:.1f}s")


#: the native phase's tokenizer batch: 4096 texts of up to 600 bytes
NATIVE_TEXTS, NATIVE_MAX_LEN = 4096, 512


def native_phase(seed=0):
    """The host C++ library (``trlx_tpu_torch/csrc/hostdata.cpp``) built
    (a missing compiler fails the run) and used by the port's entry
    points: the byte tokenizer on 4096 texts and the ILQL store's loader
    over 320 rows of 130-500 tokens (4 batches of 80), each equal to its
    Python loop, both timed (best of 3)."""
    from trlx_tpu_torch.pipeline.offline_pipeline import \
        OfflineRolloutStorage
    from trlx_tpu_torch.utils.tokenizer import ByteTokenizer

    assert native.available(), (
        f"the host library did not build (compiler {native.compiler()}, "
        f"source {native.SOURCE})")
    # the first use may have been in a child (the gpt-j child tokenizes
    # first), so the build is timed here once more, as native builds it
    built = os.path.join(CKPT_ROOT, "hostdata-timing.so")
    os.makedirs(CKPT_ROOT, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([native.compiler(), *native.CXX_FLAGS, str(native.SOURCE),
                    "-o", built], check=True, capture_output=True,
                   timeout=120)
    out = {"build_s": time.perf_counter() - t0,
           "first_use_build_s": float(native.BUILD_INFO["seconds"]),
           "library": os.path.basename(str(native.BUILD_INFO["path"]))}
    os.remove(built)
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghij KLMNOP,.") + ["é", "ü", "☃", "\n"]
    texts = ["".join(rng.choice(alphabet, int(rng.integers(0, 600))))
             for _ in range(NATIVE_TEXTS)]
    rows = ilql_rows(seed=seed)
    masks = [[1] * (len(r) - 1) + [0] for r in rows]
    rewards = [rng.normal(size=len(r) - 1).astype(np.float32).tolist()
               for r in rows]
    store = OfflineRolloutStorage(rows, masks, rewards)
    tok = ByteTokenizer()

    def best(fn):
        times, result = [], None
        for _ in range(3):
            t = time.perf_counter()
            result = fn()
            times.append(time.perf_counter() - t)
        return min(times), result

    def tokenize():
        return tok(texts, max_length=NATIVE_MAX_LEN)

    def collate():
        return list(store.create_loader(80, eos_token_id=256))

    calls = dict(native.CALLS)
    tok_native, enc = best(tokenize)
    col_native, batches = best(collate)
    assert native.CALLS["byte_tokenize_pad"] - \
        calls["byte_tokenize_pad"] == 3
    assert native.CALLS["pad_collate"] - calls["pad_collate"] == 12
    available = native.available
    native.available = lambda: False
    try:
        tok_python, enc_py = best(tokenize)
        col_python, batches_py = best(collate)
    finally:
        native.available = available
    for key in ("input_ids", "attention_mask"):
        assert np.array_equal(enc[key], enc_py[key]), key
    assert len(batches) == len(batches_py) == 4
    for a, b in zip(batches, batches_py):
        for field in ("input_ids", "attention_mask", "rewards"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), \
                field
    out.update(tokenize_ms={"native": tok_native * 1e3,
                            "python": tok_python * 1e3},
               collate_ms={"native": col_native * 1e3,
                           "python": col_python * 1e3},
               shape=list(enc["input_ids"].shape),
               T=int(batches[0].input_ids.shape[1]))
    return out


def log_native(n, card):
    log("native", f"host library {n['library']}: g++ -O3 builds it in "
                  f"{n['build_s']:.2f}s (this process's first use "
                  f"{n['first_use_build_s']:.2f}s, 0 = built by an "
                  f"earlier process); the byte "
                  f"tokenizer on {NATIVE_TEXTS} texts to "
                  f"{n['shape']}: {n['tokenize_ms']['native']:.2f} ms "
                  f"native, {n['tokenize_ms']['python']:.2f} ms Python; "
                  f"the ILQL loader (320 rows, 4 batches of 80 x "
                  f"T{n['T']}): {n['collate_ms']['native']:.2f} ms native, "
                  f"{n['collate_ms']['python']:.2f} ms Python; equal "
                  f"arrays (best of 3; host clock; {card})")


# --------------------------------------------------------------------- #
# 8. train parity: kernel path vs dense path at fp32
# --------------------------------------------------------------------- #


def named_leaves(tree, prefix=""):
    """[(dotted name, leaf)] in the order ``tree_map`` visits ``tree``,
    which is the order of the optimizer's parameter and gradient lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def leaf_norms(ours, theirs):
    """[(name, |ours - theirs|, |theirs|)] per leaf of two [(name, array)]
    lists (numpy arrays, or tensors, which stay on their device), L2
    norms in float64."""
    rows = []
    for (name, o), (_, t) in zip(ours, theirs):
        if torch.is_tensor(o):
            o, t = o.double(), t.double()
            rows.append((name, float(torch.linalg.vector_norm(o - t)),
                         float(torch.linalg.vector_norm(t))))
            continue
        o, t = np.asarray(o, np.float64), np.asarray(t, np.float64)
        rows.append((name, np.linalg.norm(o - t), np.linalg.norm(t)))
    return rows


def snapshot(tree):
    """[(dotted name, float32 copy)] of a tensor tree, on its device."""
    return [(n, x.detach().float().clone()) for n, x in named_leaves(tree)]


def train_parity_phase(tree, batch, device, config_fn=None,
                       phase="train-parity"):
    """One train_step, then one 2-pass train_multi, at fp32 on the kernel
    path, every pass held against the dense path's pass at the same
    parameters (the kernel path's, copied into the dense trainer before
    each pass) and the same batch: loss and grad norm at rtol 1e-5, and
    the first step's per-leaf gradients (as they reach the optimizer) at
    relative L2 2e-3. The two paths' own Adam trajectories are not held
    to each other past a step: Adam moves each element by about +-lr, so
    an element whose gradient lies within the paths' float32 rounding
    steps +-lr with a sign neither pins down, and the trajectories part
    far beyond float32 rounding within a pass or two (PERF.md).
    For the same reason tests/test_golden_step.py's rule on each pass's
    update is printed, not asserted, with the dense gradient at the
    elements whose first updates differ by more than lr / 2.
    ``config_fn(compute_dtype, fused, ppo_epochs)`` gives the config dict
    (default :func:`train_config_dict`); ``phase`` labels the lines."""
    trainers, grads = {}, {}
    for fused in (True, False):
        cfg = TRLConfig.from_dict((config_fn or train_config_dict)(
            "float32", fused, 2))
        trainer = get_model(cfg.model.model_type)(cfg, device=device,
                                                  params=tree)
        grads[fused], opt_step = [], trainer.opt.step

        def capture(params, g, state, ok=None, g_norm=None,
                    opt_step=opt_step, out=grads[fused]):
            if not out:  # the first step's gradients
                out.append([x.detach().float().clone() for x in g])
            return opt_step(params, g, state, ok=ok, g_norm=g_norm)

        trainer.opt.step = capture
        trainers[fused] = trainer
    kernel, dense = trainers[True], trainers[False]
    kernel_step = kernel.train_step
    passes = []  # per pass: (kernel stats, dense stats, params before,
    #              kernel params after, dense params after)

    def paired(batch):
        with torch.no_grad():
            for (_, d), (_, k) in zip(named_leaves(dense.params["trainable"]),
                                      named_leaves(kernel.params["trainable"])):
                d.copy_(k)
        before = snapshot(kernel.params["trainable"])
        stats = kernel_step(batch)
        dense_stats = dense.train_step(batch)
        passes.append(({k: float(v) for k, v in stats.items()},
                       {k: float(v) for k, v in dense_stats.items()}, before,
                       *(snapshot(t.params["trainable"])
                         for t in (kernel, dense))))
        return stats

    kernel.train_step = paired
    kernel.train_step(batch)
    kernel.train_multi(batch)
    del kernel, dense, trainers
    torch.cuda.empty_cache() if device == "cuda" else None

    labels = ("train_step", "train_multi pass 1", "train_multi pass 2")
    worst = 0.0
    for label, (ours, theirs, *_) in zip(labels, passes):
        for key in ("loss", "grad_norm"):
            a, b = ours[key], theirs[key]
            rel = abs(a - b) / max(abs(b), 1e-30)
            log(phase, f"{label} {key}: kernel {a!r} dense {b!r} "
                       f"at the same parameters (relative "
                       f"{rel:.2e}, rtol 1e-5)")
            worst = max(worst, rel)
    assert worst <= 1e-5, f"loss or grad norm differs by {worst:.2e}"
    # a leaf whose gradient is analytically zero (the key bias: softmax
    # is shift-invariant) holds float32 rounding on both paths; below
    # 1e-5 of the global norm it is held absolutely at that level
    names = [n for n, _ in passes[0][2]]
    g_kernel, g_dense = (list(zip(names, grads[f][0])) for f in (True, False))
    floor = 1e-5 * passes[0][1]["grad_norm"]
    rows = leaf_norms(g_kernel, g_dense)
    rel = [(d / t, n) for n, d, t in rows if t >= floor]
    zero = {n: f"|grad| {t:.2e} |diff| {d:.2e}" for n, d, t in rows
            if t < floor}
    grad_rel, name = max(rel)
    log(phase, f"train_step gradients: largest relative L2 "
               f"{grad_rel:.2e} ({name}) over {len(rel)} leaves "
               f"(rtol 2e-3); below the floor {floor:.2e} (1e-5 "
               f"of the global norm), held to it: {zero}")
    for name, d, t in rows:
        assert (d < 2e-3 * t) if t >= floor else (d < floor), \
            f"{name}: gradients differ by {d} of {t}"

    lr = float(build_optimizer(cfg.train).schedule(0))  # the first step's
    updates = {}
    for label, (_, _, before, k_after, d_after) in zip(labels, passes):
        ours, theirs = ([(n, p - s) for (n, p), (_, s) in zip(after, before)]
                        for after in (k_after, d_after))
        # tests/test_golden_step.py's rule: updates agreeing absolutely
        # to 1e-5 pass, else relative L2 < 2e-3
        updates[label] = {n: 0.0 if d < 1e-5 else d / max(t, 1e-12)
                          for n, d, t in leaf_norms(ours, theirs)}
        over = {n: f"{r:.2e}" for n, r in updates[label].items() if r >= 2e-3}
        log(phase, f"{label} update from the same parameters by "
                   f"tests/test_golden_step.py's rule at 2e-3 "
                   f"(printed, not asserted): {len(over)} leaves "
                   f"at or over: {over}")
        if label != "train_step":
            continue
        flipped, total, top = 0, 0, (0.0, "")
        for (n, u_k), (_, u_d), (_, g_d) in zip(ours, theirs, g_dense):
            flip = (u_k - u_d).abs() > 0.5 * lr
            flipped, total = flipped + int(flip.sum()), total + flip.numel()
            if flip.any():
                rms = float(g_d.double().square().mean().sqrt())
                share = float(g_d[flip].abs().max()) / max(rms, 1e-30)
                top = max(top, (share, n))
        log(phase, f"train_step: {flipped} of {total} elements "
                   f"have updates differing by > lr/2; the dense "
                   f"|grad| there is at most {top[0]:.2e} of its "
                   f"leaf's RMS gradient ({top[1] or 'none'})")
    return {"worst_rel": worst, "grads_rel_l2": grad_rel,
            "updates_rel_l2": {k: max(v.values())
                               for k, v in updates.items()}}


# --------------------------------------------------------------------- #
# 10c. mesh: the PPO main path on a device mesh of one card
# --------------------------------------------------------------------- #


def mesh_config_dict(compute_dtype="float32"):
    """:func:`train_config_dict` at ``compute_dtype`` with fused attention
    and greedy rollouts (the mesh and the plain trainer must decode the
    same tokens): one chunk of 32 rollouts, one batch of 2 PPO epochs,
    its stats logged once."""
    cfg = train_config_dict(compute_dtype, True, 2)
    cfg["method"].update(num_rollouts=32, chunk_size=32)
    cfg["method"]["gen_kwargs"] = dict(cfg["method"]["gen_kwargs"],
                                       do_sample=False)
    cfg["train"].update(total_steps=2, log_interval=2)
    return cfg


def mesh_stack(cfg, tree, device, mesh):
    """A PPO trainer (on ``mesh``, or plain with None) with ppo_tldr's
    wiring: the reward model from its trunk, on its mesh."""
    trainer = get_model(cfg.model.model_type)(cfg, device=device,
                                              params=tree, mesh=mesh)
    reward_model = ppo_tldr.build_reward_model(cfg, trainer)
    pipeline = get_pipeline(cfg.train.pipeline)(
        ppo_tldr.synthetic_documents(64), trainer.tokenizer, cfg)
    orch = get_orchestrator(cfg.train.orchestrator)(
        trainer, pipeline, reward_fn=reward_model,
        chunk_size=cfg.method.chunk_size)
    return trainer, orch


def mesh_run(cfg, tree, device, mesh):
    """make_experience + learn() on a fresh stack, the launch counters at
    0 just before and read just after; 0 recompiles in its telemetry
    session."""
    trainer, orch = mesh_stack(cfg, tree, device, mesh)
    logs = []
    sync(device)
    ops.reset_launches()
    info = orch.make_experience(cfg.method.num_rollouts)
    trainer.learn(log_fn=logs.append)
    sync(device)
    launches = {n: ops.LAUNCHES[n] for n in FLASH_NAMES}
    assert recompiles() == 0, f"recompiled {recompiles()} times"
    return {"trainer": trainer, "orch": orch, "info": info,
            "logs": [e for e in logs if "loss" in e], "launches": launches,
            "graphs": graph_stats(trainer.decoder.step.graphs())}


def whole_leaves(tree):
    """[(dotted name, the whole tensor)] of a tree, DTensors gathered."""
    return [(n, x.full_tensor() if is_dtensor(x) else x)
            for n, x in named_leaves(tree)]


def assert_close_leaves(a, b, what, rtol=1e-5, atol=0.0):
    """Per-leaf allclose of two [(name, tensor)] lists; the largest
    absolute difference and whether every leaf is bit-identical."""
    worst, same = 0.0, True
    for (name, x), (_, y) in zip(a, b):
        x, y = x.detach(), y.detach().to(x.device)
        assert x.shape == y.shape and torch.allclose(
            x.float(), y.float(), rtol=rtol, atol=atol), \
            f"{what}: {name} differs"
        if x.numel():
            worst = max(worst, float((x.float() - y.float()).abs().max()))
        same = same and torch.equal(x, y)
    return worst, same


def timed_alternating(fns, device, rounds=3):
    """{name: median seconds} of each callable, called in turn ``rounds``
    times (one after the other, so a drift in the card's clocks falls on
    both), a device sync around each call."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            times[name].append(time.perf_counter() - t0)
    return {name: float(np.median(v)) for name, v in times.items()}


def mesh_phase(tree, batch, device, card):
    """The PPO main path on a device mesh of one card against the plain
    path (module docstring, phase 10c). A world of one process
    over NCCL on a free localhost port, torn down at the end."""
    import torch.distributed as dist

    initialize_runtime(f"tcp://127.0.0.1:{free_port()}", 1, 0, device)
    try:
        mesh = build_mesh({"dp": -1, "fsdp": 1, "tp": 1}, device)
        out = _mesh_phase(tree, batch, device, card, mesh)
        release(device)
        out["sp_pp_one"] = sp_pp_world_of_one(tree, batch, device)
        return out
    finally:
        dist.destroy_process_group()
        release(device)


def sp_pp_world_of_one(tree, batch, device):
    """``train.mesh: {dp: -1, sp: 1, pp: 1}`` through the trainer in the
    world of one (the [mesh] phase's): it constructs, its policy runs
    neither the ring nor the pipeline (both axes are 1), and one fp32
    update equals the plain trainer's (loss and grad norm at rtol 1e-5;
    whether bit-identical is printed). The flash launches of the update
    are counted."""
    cfg = mesh_config_dict()
    cfg["train"]["mesh"] = {"dp": -1, "sp": 1, "pp": 1}
    cfg = TRLConfig.from_dict(cfg)
    mesh = build_mesh(cfg.train.mesh, device)
    t = get_model(cfg.model.model_type)(cfg, device=device, params=tree,
                                        mesh=mesh)
    assert t.sp is None and not t.policy._pp_active() \
        and t.policy.pp_mesh is None, "size-1 sp / pp must not engage"
    sync(device)
    ops.reset_launches()
    ours = {k: float(v) for k, v in t.train_step(batch).items()}
    sync(device)
    launches = {n: ops.LAUNCHES[n] for n in FLASH_NAMES}
    del t
    release(device)
    plain = get_model(cfg.model.model_type)(
        TRLConfig.from_dict(mesh_config_dict()), device=device, params=tree)
    theirs = {k: float(v) for k, v in plain.train_step(batch).items()}
    del plain
    release(device)
    for key in ("loss", "grad_norm"):
        assert abs(ours[key] - theirs[key]) <= 1e-5 * abs(theirs[key]), \
            f"{{sp: 1, pp: 1}} {key}: {ours[key]} vs {theirs[key]}"
    same = all(ours[k] == theirs[k] for k in ours)
    log("pp", f"train.mesh {{dp: -1, sp: 1, pp: 1}} through the trainer "
              f"in a world of one (NCCL): no ring, no pipeline; one fp32 "
              f"update loss {ours['loss']!r} vs {theirs['loss']!r} plain, "
              f"grad norm {ours['grad_norm']!r} vs "
              f"{theirs['grad_norm']!r} (bit-identical stats: {same}); "
              f"flash launches {launches}")
    return {"stats": ours, "plain": theirs, "bit_identical": same,
            "launches": launches}


def _mesh_phase(tree, batch, device, card, mesh):
    cfg = TRLConfig.from_dict(mesh_config_dict())
    spec = cfg.model.resolve_spec()
    meshed = mesh_run(cfg, tree, device, mesh)
    plain = mesh_run(cfg, tree, device, None)
    m, p = meshed["trainer"], plain["trainer"]
    assert m.mesh is mesh and p.mesh is None
    dtensors = [is_dtensor(x) for _, x in named_leaves(m.params)]
    assert all(dtensors) and all(
        is_dtensor(x) for _, x in named_leaves(m.opt_state["mu"])), \
        "a leaf of the mesh trainer is not a DTensor"
    ms, ps = m.store._stacked(), p.store._stacked()
    assert torch.equal(ms.response_tensors, ps.response_tensors), \
        "greedy rollout tokens differ with the mesh"
    rollout_lp = float((ms.logprobs - ps.logprobs).abs().max())
    for key in ("loss", "grad_norm"):
        a, b = meshed["logs"][-1][key], plain["logs"][-1][key]
        assert abs(a - b) <= 1e-5 * abs(b), f"{key}: mesh {a} plain {b}"
    params_err, params_same = assert_close_leaves(
        whole_leaves(m.params), whole_leaves(p.params), "updated params")
    L, k = spec.n_layer, m.policy.k
    want = {"flash_fwd": L + k + 2 * L, "flash_bwd_dq": 2 * k,
            "flash_bwd_dkv": 2 * k}  # 1 chunk x (L + k), 2 passes x L
    if device == "cuda":  # the CPU runs the plain versions
        assert meshed["launches"] == want, (meshed["launches"], want)

    # the mesh's checkpoint restored into a plain trainer: bit-identical
    ckpt = os.path.join(CKPT_ROOT, "mesh")
    m.save(ckpt)
    back = get_model(cfg.model.model_type)(cfg, device=device, params=tree)
    back.load(ckpt)
    for what, x, y in (("params", m.params, back.params),
                       ("opt_state", m.opt_state, back.opt_state)):
        for (name, a), (_, b) in zip(whole_leaves(x), whole_leaves(y)):
            assert torch.equal(a, b), f"restored {what}.{name} differs"
    step_batch = ms.map(lambda x: x[:cfg.train.batch_size])
    s_mesh, s_back = m.train_step(step_batch), back.train_step(step_batch)
    for key in s_mesh:
        assert torch.equal(s_mesh[key], s_back[key]), key
    for what, x, y in (("params", m.params, back.params),
                       ("opt_state", m.opt_state, back.opt_state)):
        for (name, a), (_, b) in zip(whole_leaves(x), whole_leaves(y)):
            assert torch.equal(a, b), f"next update: {what}.{name} differs"
    del back

    # times: the update (2 passes) and the rollout (32), alternated
    orchs = {"mesh": meshed["orch"], "plain": plain["orch"]}
    update_s = timed_alternating({
        name: (lambda t=t: t.train_multi(step_batch))
        for name, t in (("mesh", m), ("plain", p))}, device)
    rollout_s = timed_alternating({
        name: (lambda o=o: o.make_experience(cfg.method.num_rollouts))
        for name, o in orchs.items()}, device, rounds=2)
    for stack in (meshed, plain):
        stack.pop("trainer"), stack.pop("orch")
    del m, p, orchs
    release(device)

    # bf16: one update each from the same batch
    cfg16 = TRLConfig.from_dict(mesh_config_dict("bfloat16"))
    bf16 = {}
    for name, on in (("mesh", mesh), ("plain", None)):
        t = get_model(cfg16.model.model_type)(cfg16, device=device,
                                              params=tree, mesh=on)
        bf16[name] = {k: float(v) for k, v in t.train_step(batch).items()}
        del t
        release(device)
    for key in ("loss", "grad_norm"):
        a, b = bf16["mesh"][key], bf16["plain"][key]
        assert abs(a - b) <= 1e-5 * abs(b), f"bf16 {key}: {a} vs {b}"
    return {"launches": meshed["launches"], "want": want,
            "leaves": len(dtensors), "rollout_logprob_err": rollout_lp,
            "params_err": params_err, "params_bit_identical": params_same,
            "loss": (meshed["logs"][-1]["loss"], plain["logs"][-1]["loss"]),
            "grad_norm": (meshed["logs"][-1]["grad_norm"],
                          plain["logs"][-1]["grad_norm"]),
            "bf16": bf16, "update_s": update_s, "rollout_s": rollout_s,
            "graphs": meshed["graphs"], "card": card}


def log_mesh(r, card):
    log("mesh", f"a world of one process over NCCL, the mesh "
                f"{{dp: 1, pp: 1, fsdp: 1, sp: 1, tp: 1}} passed as mesh=: "
                f"{r['leaves']} parameter leaves, every one a DTensor; 32 "
                f"greedy rollouts' tokens identical to the plain trainer's "
                f"(rollout logprobs differ by at most "
                f"{r['rollout_logprob_err']:.3e}); learn() of 2 passes at "
                f"fp32: loss {r['loss'][0]!r} vs {r['loss'][1]!r}, grad "
                f"norm {r['grad_norm'][0]!r} vs {r['grad_norm'][1]!r}; "
                f"updated params within rtol 1e-5 (largest difference "
                f"{r['params_err']:.3e}, bit-identical: "
                f"{r['params_bit_identical']}); flash launches "
                f"{r['launches']} == {r['want']}; decode graphs "
                f"{r['graphs']}, 0 recompiles; the mesh checkpoint "
                f"restored into a plain trainer bit for bit, the next "
                f"update bit-identical; bf16 update loss "
                f"{r['bf16']['mesh']['loss']!r} vs "
                f"{r['bf16']['plain']['loss']!r}, grad norm "
                f"{r['bf16']['mesh']['grad_norm']!r} vs "
                f"{r['bf16']['plain']['grad_norm']!r}")
    log("mesh", f"update (2 passes of B32 T576, fp32, median of 3 "
                f"alternated): {r['update_s']['mesh'] * 1e3:.1f} ms on the "
                f"mesh, {r['update_s']['plain'] * 1e3:.1f} ms plain; "
                f"rollout (32 greedy, generate + score + reward model, "
                f"median of 2): {r['rollout_s']['mesh'] * 1e3:.1f} ms on "
                f"the mesh, {r['rollout_s']['plain'] * 1e3:.1f} ms plain "
                f"({card})")


# --------------------------------------------------------------------- #
# 9. ILQL: offline training at gpt2-124M width, full unfreeze
# --------------------------------------------------------------------- #

#: rows of the ILQL store (4 batches of 80) and their length range
ILQL_ROWS, ILQL_MIN_LEN, ILQL_MAX_LEN = 320, 130, 500
#: where the ILQL phase's telemetry.json and trace.jsonl land
ILQL_RUN_DIR = os.path.join(CKPT_ROOT, "ilql_run")


def ilql_config_dict(compute_dtype="bfloat16", fused=True):
    """configs/ilql_config.yml (the port example's copy: full unfreeze,
    batch 80, tau 0.7, gamma 0.99, cql 0.1, awac 1, alpha 1, beta 4, two
    Q heads) at gpt2-124M width from config with fused_attention, the
    byte tokenizer, a target sync every 2 steps, stats every step, one
    eval at step 0 and checkpoints beyond the run; supervised as
    configs/ppo_config.yml ships it, its telemetry in
    :data:`ILQL_RUN_DIR`."""
    cfg = ilql_sentiments.ilql_config()
    cfg["model"].update(model_path="from-config", tokenizer_path="byte",
                        model_spec=dict(GPT2_SPEC),
                        compute_dtype=compute_dtype, fused_attention=fused)
    cfg["train"].update(log_interval=1, checkpoint_interval=10**9,
                        **{**SUPERVISED, "telemetry_dir": ILQL_RUN_DIR})
    cfg["method"].update(steps_for_target_q_sync=2)
    return cfg


def ilql_rows(n=ILQL_ROWS, seed=0, lo=ILQL_MIN_LEN, hi=ILQL_MAX_LEN):
    """Pre-tokenized rows of printable bytes, lengths drawn in [lo, hi]
    (row 0 at hi, so the store-global T is hi), each holding one "good"
    or "bad" for the reward to read."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    lengths[0] = hi
    rows = []
    for size in lengths:
        row = rng.integers(32, 127, int(size))
        word = list(b"good" if rng.random() < 0.5 else b"bad")
        at = int(rng.integers(0, size - len(word)))
        row[at:at + len(word)] = word
        rows.append(row.tolist())
    return rows


def ilql_phase(tree, device):
    """registry -> OfflineOrchestrator -> learn(): one epoch (4 updates
    of 80 rows, T 500) with an eval of 64 bos prompts x 32 tokens at step
    0 and a target sync at step 2; every launch counter at 0 just before
    and read just after. The flash kernels launch once per layer per
    update (fwd, dq, dk/dv); every logged loss is finite. The trainer's
    ``step_events`` split steps 2-4 into their parts (median ms)."""
    cfg = TRLConfig.from_dict(ilql_config_dict())
    trainer = get_model(cfg.model.model_type)(cfg, device=device,
                                              params=tree)
    get_orchestrator(cfg.train.orchestrator)(
        trainer, ilql_rows(), [trainer.tokenizer.eos_token] * 64,
        reward_fn=ilql_sentiments.reward_fn)
    logs = []
    if device == "cuda":
        trainer.step_events = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    trainer.learn(log_fn=logs.append)
    torch.cuda.synchronize() if device == "cuda" else None
    wall = time.perf_counter() - t0
    all_launches = dict(ops.LAUNCHES)
    launches = {n: all_launches[n] for n in FLASH_NAMES}
    steps, L = trainer.iter_count, trainer.net.spec.n_layer
    want = dict.fromkeys(FLASH_NAMES, steps * L)
    if device == "cuda":
        assert launches == want and steps > 0, \
            f"flash launches {launches} != {want}"
    train_logs = [entry for entry in logs if "loss" in entry]
    assert len(train_logs) == steps == ILQL_ROWS // cfg.train.batch_size
    for entry in train_logs:
        for key in ("loss", "loss_q", "loss_v", "loss_cql", "loss_awac",
                    "grad_norm"):
            assert np.isfinite(entry[key]), (key, entry)
    evals = [entry for entry in logs if "reward" in entry]
    assert len(evals) == 1 and np.isfinite(evals[0]["reward"]), evals
    floor = check_run_floor(ILQL_RUN_DIR, train_logs, device,
                            torch.cuda.max_memory_allocated() / 2**30
                            if device == "cuda" else 0.0)
    assert floor["summary"]["timings"]["time/ilql_update"]["count"] == steps
    assert trainer.supervisor.stall_timeout == 300
    assert trainer.supervisor.stalls == 0
    hists = telemetry.current().registry.hists
    update = hists["time/ilql_update"]
    T = trainer._tokens_per_sample
    first = next(iter(trainer.train_store.create_loader(
        cfg.train.batch_size)))
    # the device time of each part of steps 2-4 (train_step's own events)
    split = {part: float(np.median([
        marks[i].elapsed_time(marks[i + 1])
        for marks in (trainer.step_events or [])[1:]]))
        for i, part in enumerate(STEP_PARTS)} if device == "cuda" else {}
    step_s = update.quantile(0.5)  # steps 2-4: the window skips the first
    return {
        "trainer": trainer, "launches": launches, "all_launches": all_launches, "want": want,
        "steps": steps, "T": T,
        "wall_s": wall, "step_p50_s": step_s,
        "steps_s": [update.first] + list(update.window),
        "tokens_per_s": cfg.train.batch_size * T / step_s,
        "eval_s": hists["time/eval"].total,
        "max_memory_gb": (torch.cuda.max_memory_allocated() / 2**30
                          if device == "cuda" else 0.0),
        "logs": train_logs, "eval_reward": evals[0]["reward"],
        "first_mask": first.attention_mask, "split_ms": split,
        "first_call_s": dict(trainer.supervisor.first_call_s),
        "mfu": floor["last"].get("throughput/mfu"),
    }


def ilql_checkpoint_phase(trainer, device, directory):
    """Save the ILQL trainer after its updates (full unfreeze: the frozen
    bottom has zero-size leaves and the frozen embed is empty), restore
    into a fresh trainer from another seed, hold the trees bit-identical,
    then one more update of each on the same batch, bit-identical again."""
    sync(device)
    t0 = time.perf_counter()
    trainer.save(directory)
    save_s = time.perf_counter() - t0
    cfg = TRLConfig.from_dict(ilql_config_dict())
    cfg.train.seed = 1
    fresh = get_model(cfg.model.model_type)(cfg, device=device)
    t0 = time.perf_counter()
    fresh.load(directory)
    sync(device)
    restore_s = time.perf_counter() - t0
    assert fresh.iter_count == trainer.iter_count
    assert fresh.params["frozen_base"]["embed"] == {}
    n, empty = assert_same_state(trainer, fresh, "ILQL restored state")
    assert empty > 0, "no zero-size leaf in the ILQL tree"
    full, _ = trainer._collate_store()
    batch = full.map(lambda x: torch.as_tensor(
        x[:cfg.train.batch_size]).to(device))
    losses = [float(t.train_step(batch)["loss"]) for t in (trainer, fresh)]
    assert losses[0] == losses[1], losses
    assert_same_state(trainer, fresh, "ILQL next update")
    del fresh
    torch.cuda.empty_cache() if device == "cuda" else None
    return {"save_s": save_s, "restore_s": restore_s, "leaves": n,
            "zero_size_leaves": empty, "bytes": dir_bytes(directory)}


# --------------------------------------------------------------------- #
# 10. ILQL parity: kernel path vs dense path at fp32
# --------------------------------------------------------------------- #


def ilql_parity_phase(tree, device, B=8, hi=200, steps=3):
    """``steps`` train steps at fp32 on the kernel path, each held
    against the dense path's step at the same parameters (the kernel
    path's, copied into the dense trainer first) on one batch of B rows
    (T ``hi``, right-padded, terminal slots masked): loss and pre-clip
    grad norm at rtol 1e-5, and every leaf's gradient (as it reaches the
    optimizer) by train_parity_phase's rule: relative L2 2e-3, a leaf
    under 1e-5 of the global norm held absolutely to that floor. The ramp
    makes the first step's lr 0, so the third step is the first at moved
    parameters."""
    trainers, grads = {}, {}
    for fused in (True, False):
        cfg = TRLConfig.from_dict(ilql_config_dict("float32", fused))
        trainer = get_model(cfg.model.model_type)(cfg, device=device,
                                                  params=tree)
        opt_step = trainer.opt.step

        def capture(params, g, state, ok=None, g_norm=None,
                    opt_step=opt_step, fused=fused):
            grads[fused] = [x.detach().clone() for x in g]
            return opt_step(params, g, state, ok=ok, g_norm=g_norm)

        trainer.opt.step = capture
        trainers[fused] = trainer
    kernel, dense = trainers[True], trainers[False]
    get_orchestrator(cfg.train.orchestrator)(
        kernel, ilql_rows(B, seed=1, hi=hi), [],
        reward_fn=ilql_sentiments.reward_fn)
    full, _ = kernel._collate_store()
    batch = full.map(lambda x: torch.as_tensor(x).to(device))
    names = [n for n, _ in named_leaves(kernel.params["trainable"])]
    worst, worst_grad = 0.0, (0.0, "")
    for step in range(steps):
        with torch.no_grad():
            for (_, d), (_, k) in zip(
                    named_leaves(dense.params["trainable"]),
                    named_leaves(kernel.params["trainable"])):
                d.copy_(k)
        ours = {k: float(v) for k, v in kernel.train_step(batch).items()}
        theirs = {k: float(v) for k, v in dense.train_step(batch).items()}
        for key in ("loss", "grad_norm"):
            a, b = ours[key], theirs[key]
            rel = abs(a - b) / max(abs(b), 1e-30)
            log("ilql-parity", f"step {step + 1} {key}: kernel {a!r} dense "
                               f"{b!r} at the same parameters (relative "
                               f"{rel:.2e}, rtol 1e-5; B{B} T{hi})")
            worst = max(worst, rel)
        floor = 1e-5 * theirs["grad_norm"]
        rows = [(n, float((k.double() - d.double()).norm()),
                 float(d.double().norm()))
                for n, k, d in zip(names, grads[True], grads[False])]
        rel = [(d / t, n) for n, d, t in rows if t >= floor]
        zero = {n: f"|grad| {t:.2e} |diff| {d:.2e}" for n, d, t in rows
                if t < floor}
        step_worst = max(rel)
        worst_grad = max(worst_grad, step_worst)
        log("ilql-parity", f"step {step + 1} gradients: largest relative L2 "
                           f"{step_worst[0]:.2e} ({step_worst[1]}) over "
                           f"{len(rel)} leaves (rtol 2e-3); below the floor "
                           f"{floor:.2e} (1e-5 of the global norm), held to "
                           f"it: {zero}")
        for name, d, t in rows:
            assert (d < 2e-3 * t) if t >= floor else (d < floor), \
                f"ILQL step {step + 1} {name}: gradients differ by {d} of {t}"
    assert worst <= 1e-5, f"ILQL loss or grad norm differs by {worst:.2e}"
    del kernel, dense, trainers, grads
    torch.cuda.empty_cache() if device == "cuda" else None
    return {"worst_rel": worst, "grads_rel_l2": worst_grad[0],
            "T": int(batch.input_ids.shape[1])}


# --------------------------------------------------------------------- #
# 10b. CUDA graphs against the eager path: the rollout decoder
# --------------------------------------------------------------------- #


def ppo_ab_phase(trainer, orch, batch, device):
    """PPO's rollout decoder with graphs off and on, at the rollout
    shape (B 32, P 512, G 64): greedy tokens and logprobs identical,
    before and after one update pass, and the pass moved the logprobs
    (the graph read the updated weights); then the orchestrator's
    rollouts timed on both paths, each path warmed by one chunk first.
    The trainer's own decoder keeps one signature."""
    greedy = trainer.gen_config._replace(
        sampling=SamplingParams(do_sample=False))
    decoder = RolloutDecoder()

    def rollout():
        embed, ln_f = head_params_for_decode(trainer.params)
        out = generate(trainer.policy.spec, all_blocks(trainer.params),
                       embed, ln_f, batch.query_tensors, batch.query_masks,
                       trainer.generator, greedy,
                       compute_dtype=trainer.policy.compute_dtype,
                       decoder=decoder)
        sync(device)
        return out

    def experience():
        orch.make_experience(orch.chunk_size)  # warm
        sync(device)
        t0 = time.perf_counter()
        orch.make_experience(trainer.config.method.num_rollouts)
        sync(device)
        return time.perf_counter() - t0

    runs = {}
    for label in ("before", "after"):
        if label == "after":
            stats = trainer.train_step(batch)
            assert float(stats["bad_step"]) == 0.0, stats
        for graphs in (False, True):
            t0 = time.perf_counter()
            out = with_graphs(graphs, rollout)
            runs[label, graphs] = (out, time.perf_counter() - t0)
        (eager, _), (graph, _) = runs[label, False], runs[label, True]
        assert torch.equal(eager.gen_tokens, graph.gen_tokens), label
        assert torch.equal(eager.gen_logprobs, graph.gen_logprobs), label
    moved = float((runs["after", True][0].gen_logprobs
                   - runs["before", True][0].gen_logprobs).abs().max())
    assert moved > 0, "the update moved no logprob: nothing was checked"
    rollout_s = {graphs: with_graphs(graphs, experience)
                 for graphs in (False, True)}
    assert trainer.decoder.step.signatures() == 1
    return {"moved_logprob": moved,
            "greedy_decode_s": {g: runs["after", g][1] for g in (False, True)},
            "rollout_s": rollout_s,
            "rollouts": trainer.config.method.num_rollouts,
            "graphs": graph_stats(decoder.step.graphs())}


def ilql_ab_phase(trainer, device):
    """ILQL's eval sampler (the advantage-shifted ``extras_fn`` inside
    the decode step) with graphs off and on from the same generator
    state: identical sampled tokens and the same generator state after;
    timed on both paths. The graph was captured by the phase's eval at
    step 0 and replays here, after the updates, reading the trained
    weights."""
    prompts = trainer.eval_pipeline.texts[:trainer.EVAL_CAP]
    state = trainer.generator.get_state()
    runs = {}
    for graphs in (False, True):
        trainer.generator.set_state(state)
        sync(device)
        t0 = time.perf_counter()
        samples = with_graphs(graphs, trainer.sample, prompts)
        sync(device)
        runs[graphs] = (samples, time.perf_counter() - t0,
                        trainer.generator.get_state())
    assert np.array_equal(runs[False][0], runs[True][0]), \
        "ILQL eval: graph tokens != eager tokens"
    assert torch.equal(runs[False][2], runs[True][2])
    return {"prompts": len(prompts),
            "sample_s": {g: runs[g][1] for g in (False, True)},
            "graphs": graph_stats(trainer.decoder.step.graphs())}


# --------------------------------------------------------------------- #
# 7b. the run floor on the card: the cost of supervision, the drills, a
# profiled cycle and the escalation drive
# --------------------------------------------------------------------- #

#: the supervisor's knobs off (the run floor's telemetry stays on)
UNSUPERVISED = {"stall_timeout": 0, "stall_grace": 60,
                "host_call_timeout": 0}


def warm_learn(trainer, orch, schedule="", **train):
    """One more cycle of the warm PPO trainer through learn(): a chunk of
    fresh experience first (outside learn), then ``train`` set on its
    config (no interval checkpoints unless given) and ``schedule`` as
    ``train.chaos``, and two updates of ``ppo_epochs`` passes with one
    chunk's rollout refresh between them, the rollout and update shapes
    of phase 7. Returns the logged stats; the schedule is cleared after."""
    t, m = trainer.config.train, trainer.config.method
    trainer.store.clear_history()
    orch.make_experience(orch.chunk_size)
    m.num_rollouts = orch.chunk_size
    for key, value in {"checkpoint_interval": 10**9, **train}.items():
        setattr(t, key, value)
    t.chaos = schedule
    t.total_steps = trainer.iter_count + 2 * m.ppo_epochs
    t.epochs = trainer.epoch + 2
    logs = []
    try:
        trainer.learn(log_fn=logs.append)
    finally:
        t.chaos = ""
        chaos.reset()
    return logs


def supervision_cost_phase(trainer, orch):
    """Phase 7's update and rollout times with the supervisor as
    configs/ppo_config.yml ships it and with it off, alternated (on,
    off, on, off) on the warm trainer in one process at the same shapes:
    each learn's two ``ppo_update`` spans (4 passes of B 32, T 576 each)
    and its ``rollout_refresh`` (one chunk of 32 rollouts); medians."""
    times = {mode: {"update_s": [], "rollout_s": []}
             for mode in ("supervised", "unsupervised")}
    for armed in (True, False, True, False):
        mode = "supervised" if armed else "unsupervised"
        warm_learn(trainer, orch, **(SUPERVISED if armed else UNSUPERVISED))
        assert (trainer.supervisor.stall_timeout > 0) == armed
        hists = telemetry.current().registry.hists
        times[mode]["update_s"] += list(hists["time/ppo_update"].window)[-2:]
        times[mode]["rollout_s"].append(hists["time/rollout_refresh"].last)
    return {mode: {k: float(np.median(v)) for k, v in d.items()}
            for mode, d in times.items()}


def host_reward(texts):
    """The drills' host reward: each text's share of vowels."""
    return [sum(c in "aeiou" for c in t) / max(len(t), 1) for t in texts]


def drills_phase(trainer, orch, batch, device, drill_dir):
    """The run supervisor's drills on the warm PPO trainer, with a host
    reward (the device reward model takes no host seam), each in a fresh
    telemetry session and run directory:

    1. ``reward_fn:hang=30@1`` under a 1.5 s stall budget (first calls
       too: the trainer is warm) and a 3 s seam timeout: learn()
       completes; fault/stalls, fault/seam_timeouts and
       fault/host_retries >= 1; the stack dump names the reward_fn phase
       and MainThread;
    2. ``reward_fn:hang=30@*``, one retry of 2 s each: StallError, the
       checkpoint at the stall step, and a fresh trainer (seed 1,
       ``resume_from: auto``) restores it bit-identically;
    3. ``ppo_update:sigterm@1``: a preemption checkpoint at that step;
    4. ``max_walltime`` 1 ms: a checkpoint and a clean return;
    5. the guarded step (commit gate on) inside an armed supervisor's
       ``ppo_update`` phase, with the telemetry payload (device gauges
       included), under ``torch.cuda.set_sync_debug_mode("error")``."""
    t = trainer.config.train
    host = get_orchestrator(t.orchestrator)(
        trainer, orch.pipeline, reward_fn=host_reward,
        chunk_size=orch.chunk_size)
    base = dict(stall_timeout=1.5, stall_first_timeout=1.5, stall_grace=600,
                host_call_timeout=3.0, host_retries=2, host_retry_backoff=0.0,
                max_walltime=0)
    passes = 2 * trainer.config.method.ppo_epochs
    out = {}

    def fresh(name):
        t.checkpoint_dir = os.path.join(drill_dir, name)
        t.telemetry_dir = os.path.join(drill_dir, name, "telemetry")
        return telemetry.start_from_config(trainer.config).registry.counters

    def latest_step():
        found = find_latest_checkpoint(t.checkpoint_dir)
        assert found is not None, t.checkpoint_dir
        return int(os.path.basename(found).split("_")[1])

    counters = fresh("hung")
    start, err = trainer.iter_count, io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        warm_learn(trainer, host, "reward_fn:hang=30@1", **base)
    dump = err.getvalue()
    assert trainer.iter_count == start + passes
    for key in ("fault/stalls", "fault/seam_timeouts", "fault/host_retries"):
        assert counters[key] >= 1, (key, counters)
    assert "STALL: phase 'reward_fn'" in dump, dump[-2000:]
    assert "--- thread MainThread" in dump, dump[-2000:]
    out["hung"] = {"s": time.perf_counter() - t0,
                   "stalls": counters["fault/stalls"],
                   "seam_timeouts": counters["fault/seam_timeouts"],
                   "host_retries": counters["fault/host_retries"],
                   "dump_lines": dump.count("\n")}

    counters = fresh("stall")
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        try:
            warm_learn(trainer, host, "reward_fn:hang=30@*",
                       **{**base, "stall_timeout": 0, "host_retries": 1,
                          "host_call_timeout": 2.0})
        except StallError:
            pass
        else:
            raise AssertionError("a permanently hung reward_fn raised "
                                 "no StallError")
    stall_s = time.perf_counter() - t0
    assert latest_step() == trainer.iter_count
    assert counters["fault/host_giveups"] == 1
    assert counters["fault/seam_timeouts"] == 2
    cfg = TRLConfig.from_dict(tldr_config_dict(t.checkpoint_dir, seed=1))
    cfg.train.resume_from = "auto"
    resumed = get_model(cfg.model.model_type)(cfg, device=device)
    assert resumed.iter_count == trainer.iter_count
    n, _ = assert_same_state(trainer, resumed, "the stall checkpoint")
    del resumed
    torch.cuda.empty_cache() if device == "cuda" else None
    out["stall"] = {"s": stall_s, "step": trainer.iter_count, "tensors": n}

    counters = fresh("sigterm")
    logs = warm_learn(trainer, host, "ppo_update:sigterm@1",
                      **{**base, "stall_timeout": 0})
    assert any(s.get("preempted") for s in logs), logs
    assert counters["fault/preempt_sigterm"] == 1
    assert latest_step() == trainer.iter_count
    out["sigterm"] = {"step": trainer.iter_count}

    counters = fresh("walltime")
    logs = warm_learn(trainer, host, "", **{**base, "stall_timeout": 0,
                                            "max_walltime": 0.001})
    t.max_walltime = 0
    assert any(s.get("walltime_exceeded") for s in logs), logs
    assert counters["fault/walltime_exits"] == 1
    assert latest_step() == trainer.iter_count
    out["walltime"] = {"step": trainer.iter_count}

    if device == "cuda":
        sync(device)
        with RunSupervisor(stall_timeout=300, stall_grace=120) as sup:
            torch.cuda.set_sync_debug_mode("error")
            try:
                with annotate("ppo_update"):
                    stats = trainer.train_step(batch)
                    supervisor.beat()
                payload = trainer._telemetry_stats(1.0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert sup._thread is None and sup.stalls == 0
        assert float(stats["bad_step"]) == 0.0, stats
        assert "device/hbm_in_use_gb" in payload, sorted(payload)
        out["sync_checked"] = True
    return out


def seam_capture_drill(trainer, batch, device):
    """A reward seam that scores on the card is timed out and abandoned
    by its bounded worker while it keeps launching (a matmul loop on its
    own thread's stream, reading a value back every 128 launches), and
    meanwhile the main thread captures a fresh rollout decoder (greedy,
    at the rollout shape) for the first time:

    (a) the capture holds at its first attempt while the worker keeps
        launching (``compile/capture_retries`` unchanged);
    (b) the worker synchronises the whole device once inside a second
        fresh decoder's capture (a hook on the capture's start waits for
        it): CUDA refuses the sync in the worker and invalidates the
        capture, and aot_jit takes it again (``compile/capture_retries``
        + 1).

    In both the eager first call, the replay and the eager path give
    identical tokens; then the worker is released and ends without an
    error."""
    release, started = threading.Event(), threading.Event()
    began, synced = threading.Event(), threading.Event()
    work = {"launches": 0, "error": None, "sync_error": None,
            "armed": False}
    weight = torch.randn(1024, 1024, device=device) / 32

    def scorer(texts):
        try:
            x = torch.randn(256, 1024, device=device)
            started.set()
            while not release.is_set():
                x = torch.tanh(x @ weight)
                work["launches"] += 2
                if work["launches"] % 128 == 0:
                    float(x[0, 0])  # a read back on this thread's stream
                if work["armed"] and began.is_set() and not synced.is_set():
                    try:
                        torch.cuda.synchronize()  # device-wide
                    except Exception as e:  # CUDA refuses it: expected
                        work["sync_error"] = e
                    synced.set()
        except Exception as e:  # reported below, never swallowed
            work["error"] = e
            raise
        return [0.0] * len(texts)

    try:
        retry_call(scorer, ["x"], retries=0, timeout=0.2, seam="reward_fn",
                   label="reward_fn")
    except SeamTimeout:
        pass
    else:
        raise AssertionError("the scoring seam did not time out")
    assert started.is_set()
    worker = next(th for th in threading.enumerate()
                  if th.name == "trlx-seam-reward_fn")
    greedy = trainer.gen_config._replace(
        sampling=SamplingParams(do_sample=False))
    counters = telemetry.current().registry.counters

    def rollout(decoder):
        embed, ln_f = head_params_for_decode(trainer.params)
        out = generate(trainer.policy.spec, all_blocks(trainer.params),
                       embed, ln_f, batch.query_tensors, batch.query_masks,
                       trainer.generator, greedy,
                       compute_dtype=trainer.policy.compute_dtype,
                       decoder=decoder)
        sync(device)
        return out.gen_tokens.clone()

    def capture_begin(graph, *args, **kwargs):
        real_begin(graph, *args, **kwargs)
        if work["armed"] and not synced.is_set():
            began.set()
            assert synced.wait(60), "the worker never synchronised"

    real_begin = torch.cuda.CUDAGraph.capture_begin
    runs = {}
    try:
        torch.cuda.CUDAGraph.capture_begin = capture_begin
        for case in ("launching", "device sync"):
            work["armed"] = case == "device sync"
            decoder = RolloutDecoder()
            retries = counters.get("compile/capture_retries", 0.0)
            before = work["launches"]
            first = rollout(decoder)  # eager on a side stream, then capture
            during = work["launches"] - before
            assert worker.is_alive() and work["error"] is None, work
            replay = rollout(decoder)
            eager = with_graphs(False, rollout, decoder)
            assert torch.equal(first, replay) and torch.equal(first, eager)
            runs[case] = {
                "seam_launches": during,
                "capture_retries": counters.get("compile/capture_retries",
                                                0.0) - retries,
                "graphs": graph_stats(decoder.step.graphs())}
    finally:
        torch.cuda.CUDAGraph.capture_begin = real_begin
        release.set()
        worker.join(60)
    assert not worker.is_alive() and work["error"] is None, work
    if device == "cuda":
        assert runs["launching"]["seam_launches"] > 0, runs
        assert runs["launching"]["capture_retries"] == 0, runs
        assert runs["device sync"]["capture_retries"] == 1, runs
        assert "capturing" in str(work["sync_error"]), work["sync_error"]
        for run in runs.values():
            assert run["graphs"]["graphs"] == 1, runs
    return runs


#: the CUDA symbols of the bf16 flash kernels on the training path
FLASH_SYMBOLS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel")


def profile_phase(trainer, orch, device, trace_dir):
    """One supervised cycle (:func:`warm_learn`: two updates of 4 passes
    and one chunk's rollout refresh) under ``$TRLX_TPU_PROFILE_DIR``: the
    learn loop's torch.profiler exports one Chrome trace, which names
    the three flash kernels' CUDA symbols and the decode graph's
    replays (``cudaGraphLaunch``)."""
    t = trainer.config.train
    t.telemetry_dir = t.checkpoint_dir = os.path.join(
        os.path.dirname(trace_dir), "profile_run")
    telemetry.start_from_config(trainer.config)
    os.environ["TRLX_TPU_PROFILE_DIR"] = trace_dir
    t0 = time.perf_counter()
    try:
        warm_learn(trainer, orch, **{**SUPERVISED,
                                     "telemetry_dir": t.telemetry_dir})
    finally:
        del os.environ["TRLX_TPU_PROFILE_DIR"]
    wall = time.perf_counter() - t0
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {sym: sum(sym in e.get("name", "") for e in kernels)
             for sym in FLASH_SYMBOLS}
    replays = sum(e.get("name") == "cudaGraphLaunch" for e in events)
    annotated = {name: sum(e.get("name") == name for e in events)
                 for name in ("ppo_update", "rollout", "rollout_refresh")}
    if device == "cuda":
        assert all(found.values()) and replays > 0, (found, replays)
        assert all(annotated.values()), annotated
    return {"wall_s": wall, "bytes": os.path.getsize(files[0]),
            "events": len(events), "kernels": len(kernels),
            "flash": found, "graph_launches": replays,
            "annotations": annotated}


def child_config(run_dir, action):
    """The escalation drive's trainer: :func:`tldr_config_dict` cut to 2
    layers (T 576 still, so the flash kernels launch), one chunk of 32
    rollouts, 16 passes over 4 epochs, ``resume_from: auto``; a 2 s
    stall budget after first calls (300 s for those) and a 2 s grace.
    ``action`` "checkpoint_exit" or "abort": that ``stall_action``, and
    the second ``ppo_update`` hangs (chaos); "resume": no chaos."""
    cfg = tldr_config_dict(run_dir)
    cfg["model"]["model_spec"]["n_layer"] = 2
    cfg["method"]["num_rollouts"] = 32
    cfg["train"].update(
        epochs=4, total_steps=16, checkpoint_interval=10**9,
        resume_from="auto", stall_timeout=2.0, stall_first_timeout=300.0,
        stall_grace=2.0,
        stall_action="checkpoint_exit" if action == "resume" else action,
        chaos="" if action == "resume" else "ppo_update:hang=600@2")
    return cfg


def escalation_child(action, run_dir, device="cuda"):
    """The child process of the escalation drive (``chip_smoke.py
    --escalation-child <action> <run dir> [device]``): a supervised PPO
    learn() that the watchdog ends (exit 75 after a rescue checkpoint,
    or 70), or, for "resume", one that continues from that checkpoint
    and prints its start and end iterations as a JSON line."""
    cfg = TRLConfig.from_dict(child_config(run_dir, action))
    trainer = get_model(cfg.model.model_type)(cfg, device=device)
    start = trainer.iter_count
    reward_model = ppo_tldr.build_reward_model(cfg, trainer)
    pipeline = get_pipeline(cfg.train.pipeline)(
        ppo_tldr.synthetic_documents(32), trainer.tokenizer, cfg)
    orch = get_orchestrator(cfg.train.orchestrator)(
        trainer, pipeline, reward_fn=reward_model,
        chunk_size=cfg.method.chunk_size)
    orch.make_experience(cfg.method.num_rollouts)
    ops.reset_launches()
    trainer.learn(log_fn=lambda stats: None)
    print(json.dumps({"child": action, "start_iter": start,
                      "iter": trainer.iter_count,
                      "first_call_s": trainer.supervisor.first_call_s,
                      "launches": dict(ops.LAUNCHES)}), flush=True)
    return 0


def start_child(action, run_dir, device):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--escalation-child",
         action, run_dir, device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_child(proc, want_rc, timeout=600):
    """Wait for a child (killed past ``timeout``); its output, after
    checking its exit code."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == want_rc, (
        f"escalation child exited {proc.returncode}, not {want_rc}:\n"
        f"{out[-3000:]}\n{err[-6000:]}")
    return out, err


class EscalationDrive:
    """Three child processes, chained on a thread of this process so
    they run beside the untimed drills, profile and phase 8: a
    ``ppo_update`` hang with ``stall_action: checkpoint_exit`` exits 75
    after committing a rescue checkpoint at step 4, and a third child
    with ``resume_from: auto`` starts once it has exited and continues
    from that checkpoint to step 16; the same hang with ``abort`` exits
    70 and commits none. Every child is waited for, or killed, before
    the run ends."""

    def __init__(self, root, device):
        self.root, self.device = root, device
        self.procs, self.results = {}, {}
        self.error = None
        self.stopping = threading.Event()

    def _run(self, action):
        return os.path.join(self.root, "checkpoint_exit"
                            if action == "resume" else action)

    def start(self):
        self.t0 = time.perf_counter()
        for action in ("checkpoint_exit", "abort"):
            self.procs[action] = start_child(action, self._run(action),
                                             self.device)
        self.thread = threading.Thread(target=self._chain, daemon=True,
                                       name="escalation-drive")
        self.thread.start()

    def _chain(self):
        try:
            self.results["checkpoint_exit"] = finish_child(
                self.procs["checkpoint_exit"], 75)
            if not self.stopping.is_set():
                self.procs["resume"] = start_child(
                    "resume", self._run("resume"), self.device)
            self.results["abort"] = finish_child(self.procs["abort"], 70)
            if "resume" in self.procs:
                self.results["resume"] = finish_child(self.procs["resume"],
                                                      0)
        except BaseException as e:  # re-raised by finish()
            self.error = e
        self.wall_s = time.perf_counter() - self.t0

    def finish(self, timeout=900):
        """Wait for the chain and check each child's outcome."""
        self.thread.join(timeout)
        assert not self.thread.is_alive(), "the escalation children hung"
        if self.error is not None:
            raise self.error
        out = {}
        for action in ("checkpoint_exit", "abort"):
            _, err = self.results[action]
            latest = find_latest_checkpoint(self._run(action))
            if action == "abort":
                assert latest is None, latest
            else:
                assert latest is not None and latest.endswith("step_4"), \
                    latest
                assert "rescue checkpoint committed" in err, err[-3000:]
            assert "STALL ESCALATION: phase 'ppo_update'" in err, \
                err[-3000:]
            out[action] = {"exit": self.procs[action].returncode,
                           "checkpoint": latest and os.path.basename(latest)}
        report = json.loads(self.results["resume"][0].strip()
                            .splitlines()[-1])
        assert (report["start_iter"], report["iter"]) == (4, 16), report
        if self.device == "cuda":
            assert all(report["launches"][n] > 0 for n in FLASH_NAMES), \
                report
        out["resume"] = report
        out["wall_s"] = self.wall_s
        return out

    def kill(self):
        self.stopping.set()
        for _ in range(2):  # again for a child started meanwhile
            for proc in list(self.procs.values()):
                if proc.poll() is None:
                    proc.kill()
            self.thread.join(30)


# --------------------------------------------------------------------- #
# 7-10 and the durability checks, in one place so their checkpoints are
# removed however the run ends
# --------------------------------------------------------------------- #


def durability_phases(card, watchdog, device="cuda"):
    """PPO (ppo_tldr's wiring) with its serve-from-checkpoint, resume and
    commit-gate checks, the serve lifecycle (which checks ``watchdog``,
    a started :class:`ServeWatchdogDrive`), the PPO parity phase, ILQL
    with its save / restore check, the ILQL parity phase, the bf16
    flash kernels at the ILQL shape, then the PPO policy on a device
    mesh of one card (:func:`mesh_phase`, last, so the card's memory it
    leaves behind reaches no earlier phase). Checkpoints go under
    CKPT_ROOT."""
    tree = init_hydra_numpy(
        TRLConfig.from_dict(train_config_dict()).model.resolve_spec(), 2,
        seed=0)
    run_dir = os.path.join(CKPT_ROOT, "ppo")
    train = train_phase(tree, device, run_dir)
    last = train["logs"][-1]
    log("train", f"PPO (ppo_tldr's wiring, a reward model from the "
                 f"trainer's trunk scoring on the device) at gpt2-124M "
                 f"width: {train['chunks']} rollout chunks + "
                 f"{train['passes']} update passes in {train['wall_s']:.2f}s"
                 f" (rollout {train['rollout_s']:.2f}s, update "
                 f"{train['update_s']:.2f}s, {train['samples_per_sec']:.1f}"
                 f" samples/s in updates); flash launches "
                 f"{train['launches']} == chunks x (L + k) + passes x L / "
                 f"passes x k = {train['want']}; last loss "
                 f"{last['loss']:.4f} grad_norm {last['grad_norm']:.4f} "
                 f"approx_kl {last['approx_kl']:.3e} bad_step "
                 f"{last['bad_step']:.0f}, rollout mean_kl "
                 f"{train['info']['mean_kl']:.3e} mean reward-model score "
                 f"{train['info']['mean_score']:.4f}; step checkpoints "
                 f"{train['checkpoints']} ({card}; for information, not a "
                 f"metric)")
    trainer, batch = train.pop("trainer"), train["batch"]
    docs = ppo_tldr.synthetic_documents(2, seed=5)
    serve_ckpt = serve_checkpoint_phase(trainer, device, run_dir,
                                        [(d, 32) for d in docs])
    log("serve-checkpoint", f"the serve CLI's --checkpoint loader on the "
                            f"PPO run directory ({serve_ckpt['load_s']:.2f}s"
                            f" to build): greedy tokens of 2 requests equal "
                            f"the in-memory policy's; paged decode launches "
                            f"{serve_ckpt['launches']} == "
                            f"{serve_ckpt['layers']} layers x "
                            f"{serve_ckpt['steps']} steps")
    draft = spec_draft_phase(device, run_dir)
    d, off = draft["draft"], draft["off"]
    log("spec-draft", f"speculation draft (spec_k 4) with the PPO run "
                      f"directory's newest params as target and draft "
                      f"(fp32, greedy): {d['proposed']:.0f} proposed, "
                      f"{d['accepted']:.0f} accepted (acceptance "
                      f"{d['accepted'] / d['proposed']:.3f}; trlx_tpu's "
                      f"rule on the emitted tokens predicts "
                      f"{d['predicted'][0]}/{d['predicted'][1]}), "
                      f"{d['fallbacks']:.0f} fallbacks, "
                      f"{d['kv']['speculation']['tokens_per_slot_pass']:.3f}"
                      f" tokens per slot per verify pass; "
                      f"{d['verify_steps']} verify passes + {d['steps']} "
                      f"plain steps against {off['steps']} plain steps "
                      f"off; verify p50 {d['verify_p50_ms']:.2f} ms, off "
                      f"step p50 {off['step_p50_ms']:.2f} ms; all 4 "
                      f"requests served in {d['makespan_s'] * 1e3:.1f} ms "
                      f"against {off['makespan_s'] * 1e3:.1f} ms off "
                      f"(draft proposals included); tokens == "
                      f"speculation off; {d['graphs']['graphs']} graphs "
                      f"(the draft's generate one of them), 0 recompiles "
                      f"({card})")
    lifecycle = serve_lifecycle_phase(device, run_dir, watchdog)
    log_lifecycle(lifecycle, card)
    fleet = fleet_phase(device, run_dir)
    log_fleet(fleet, card)
    host = native_phase()
    log_native(host, card)
    resume = resume_phase(trainer, batch, device, run_dir)
    restore_ms = telemetry.current().registry.hists[
        "time/checkpoint_restore"].total * 1e3
    log("resume", f"a fresh trainer (seed 1, resume_from: auto) restored "
                  f"step {resume['step']} == LATEST in {restore_ms:.1f} ms "
                  f"({resume['leaves']} tensors); its next update equals "
                  f"the original trainer's bit for bit (params, mu, nu, "
                  f"count, generator state)")
    gate = gate_phase(trainer, batch, device)
    log("gate", f"NaN rewards: bad_step 1, params / moments / count "
                f"bit-identical, no host sync inside the guarded step "
                f"(set_sync_debug_mode error: {gate['sync_checked']}); the "
                f"next clean batch committed ({gate['moved_leaves']} "
                f"tensors moved); flash launches {gate['launches']}")
    train["orch_device"] = train.pop("orch")
    ppo_ab = ppo_ab_phase(trainer, train["orch_device"], batch, device)
    log("graphs-ppo", f"greedy rollout decode (B32 P512 G64) graph == "
                      f"eager, tokens and logprobs, before and after one "
                      f"update pass (logprobs moved by up to "
                      f"{ppo_ab['moved_logprob']:.3e}); greedy decode "
                      f"{ppo_ab['greedy_decode_s'][False]:.3f}s eager, "
                      f"{ppo_ab['greedy_decode_s'][True]:.3f}s graph; "
                      f"{ppo_ab['rollouts']} rollouts (generate + score + "
                      f"reward model) {ppo_ab['rollout_s'][False]:.3f}s "
                      f"eager, {ppo_ab['rollout_s'][True]:.3f}s graph; the "
                      f"training run's rollouts: {train['graphs']} "
                      f"captured, 0 recompiles ({card})")
    log("run-floor", f"phase 7 ran supervised as configs/ppo_config.yml "
                     f"ships it (stall_timeout 300, stall_grace 120, "
                     f"host_call_timeout 60, telemetry on) and logged "
                     f"through the jsonl tracker: {len(train['logs'])} "
                     f"records; telemetry.json and trace.jsonl "
                     f"({train['trace_events']} spans: "
                     f"{train['trace_names']}) written; every fault/* "
                     f"counter 0; last record throughput/mfu "
                     f"{train['mfu']}, device/hbm_peak_gb "
                     f"{train['peak_gb']:.3f} == max_memory_allocated; "
                     f"first calls the watchdog saw (s): "
                     f"{rounded(train['first_call_s'])} ({card})")
    cost = supervision_cost_phase(trainer, train["orch_device"])
    on, off = cost["supervised"], cost["unsupervised"]
    log("run-floor", f"cost of supervision (the same warm trainer, "
                     f"alternated on/off/on/off, medians): ppo_update (4 "
                     f"passes of B32 T576) {on['update_s'] * 1e3:.1f} ms "
                     f"supervised, {off['update_s'] * 1e3:.1f} ms "
                     f"unsupervised; rollout refresh (32 rollouts) "
                     f"{on['rollout_s'] * 1e3:.1f} / "
                     f"{off['rollout_s'] * 1e3:.1f} ms "
                     f"({card})")
    escalation = EscalationDrive(os.path.join(CKPT_ROOT, "escalation"),
                                 device)
    escalation.start()
    try:
        drills = drills_phase(trainer, train["orch_device"], batch, device,
                              os.path.join(CKPT_ROOT, "drills"))
        log("drills", f"hung reward_fn (one attempt): learn() completed in "
                      f"{drills['hung']['s']:.2f}s, fault/stalls "
                      f"{drills['hung']['stalls']:.0f}, fault/seam_timeouts "
                      f"{drills['hung']['seam_timeouts']:.0f}, "
                      f"fault/host_retries "
                      f"{drills['hung']['host_retries']:.0f}, the dump "
                      f"names 'reward_fn' and MainThread; every attempt "
                      f"hung: StallError after {drills['stall']['s']:.2f}s, "
                      f"checkpoint step {drills['stall']['step']} restored "
                      f"bit-identically by a fresh trainer "
                      f"({drills['stall']['tensors']} tensors); chaos "
                      f"SIGTERM: preemption checkpoint step "
                      f"{drills['sigterm']['step']}; max_walltime: checkpoint "
                      f"step {drills['walltime']['step']}, clean return; "
                      f"guarded step + telemetry payload inside an armed "
                      f"supervisor under set_sync_debug_mode error: "
                      f"{drills.get('sync_checked', False)} ({card})")
        capture = seam_capture_drill(trainer, batch, device)
        launching, synced = capture["launching"], capture["device sync"]
        log("drills", f"a timed-out scoring seam kept launching on the "
                      f"card ({launching['seam_launches']} launches during "
                      f"a fresh rollout decoder's first call and capture): "
                      f"the capture held at its first attempt "
                      f"({launching['graphs']}); the seam synchronising the "
                      f"whole device inside the next capture invalidated it "
                      f"and aot_jit captured again (compile/capture_retries "
                      f"+{synced['capture_retries']:.0f}, "
                      f"{synced['graphs']}); tokens identical eager / "
                      f"replay / eager path in both; the worker ended "
                      f"cleanly")
        profile = profile_phase(trainer, train["orch_device"], device,
                                os.path.join(CKPT_ROOT, "profile"))
        log("profile", f"one supervised cycle under TRLX_TPU_PROFILE_DIR in "
                       f"{profile['wall_s']:.2f}s: trace {profile['bytes']} "
                       f"bytes, {profile['events']} events, "
                       f"{profile['kernels']} kernels; flash symbols "
                       f"{profile['flash']}, cudaGraphLaunch "
                       f"{profile['graph_launches']}, annotations "
                       f"{profile['annotations']} ({card})")
        del trainer
        torch.cuda.empty_cache() if device == "cuda" else None
        train_parity = train_parity_phase(tree, batch, device)
        esc = escalation.finish()
    finally:
        escalation.kill()
    log("escalation", f"child processes at 2 layers, T 576: a ppo_update "
                      f"hang under stall_action checkpoint_exit exited "
                      f"{esc['checkpoint_exit']['exit']} with rescue "
                      f"checkpoint {esc['checkpoint_exit']['checkpoint']}; "
                      f"abort exited {esc['abort']['exit']} with none; "
                      f"resume_from auto continued from step "
                      f"{esc['resume']['start_iter']} to "
                      f"{esc['resume']['iter']} (first calls its watchdog "
                      f"saw, s: {rounded(esc['resume']['first_call_s'])}"
                      f"); {esc['wall_s']:.1f}s from the first start to the "
                      f"last exit, beside the drills, the profile and phase "
                      f"8 ({card})")
    # the mesh phase runs last, from phase 7's weights and batch
    mesh_inputs = (tree, batch.map(lambda x: x.cpu()))
    del tree, train["batch"], batch
    release(device)

    ilql_tree = init_ilql_numpy(
        TRLConfig.from_dict(ilql_config_dict()).model.resolve_spec(), -1,
        True, seed=0)
    ilql = ilql_phase(ilql_tree, device)
    last = ilql["logs"][-1]
    log("ilql", f"ILQL at gpt2-124M width, full unfreeze, bf16, fused "
                f"attention: {ilql['steps']} updates of B80 x T{ilql['T']} "
                f"in {ilql['wall_s']:.2f}s with one eval; update times "
                f"{[round(t, 4) for t in ilql['steps_s']]} s, median of "
                f"steps 2-4 {ilql['step_p50_s'] * 1e3:.1f} ms = "
                f"{ilql['tokens_per_s']:.0f} training tokens/s; eval (64 "
                f"prompts x 32 tokens, host reward) {ilql['eval_s']:.3f}s; "
                f"max_memory_allocated {ilql['max_memory_gb']:.2f} GiB; "
                f"steps 2-4 split on the device timeline (median ms): "
                f"{ {k: round(v, 2) for k, v in ilql['split_ms'].items()} }; "
                f"flash launches {ilql['launches']} == L x steps "
                f"{ilql['want']}; last loss {last['loss']:.4f} (q "
                f"{last['loss_q']:.4f} v {last['loss_v']:.4f} cql "
                f"{last['loss_cql']:.4f} awac {last['loss_awac']:.4f}) "
                f"grad_norm {last['grad_norm']:.4f}; eval reward "
                f"{ilql['eval_reward']:.3f} ({card}; for information, not "
                f"a metric)")
    ilql_ab = ilql_ab_phase(ilql["trainer"], device)
    log("graphs-ilql", f"eval sampling ({ilql_ab['prompts']} prompts x 32 "
                       f"tokens, advantage-shifted) graph == eager from "
                       f"one generator state: "
                       f"{ilql_ab['sample_s'][False]:.3f}s eager, "
                       f"{ilql_ab['sample_s'][True]:.3f}s graph; "
                       f"{ilql_ab['graphs']} ({card})")
    ilql_ckpt = ilql_checkpoint_phase(ilql.pop("trainer"), device,
                                      os.path.join(CKPT_ROOT, "ilql"))
    log("ilql-checkpoint", f"saved after {ilql['steps']} updates, restored "
                           f"into a fresh trainer (seed 1): "
                           f"{ilql_ckpt['leaves']} tensors bit-identical, "
                           f"{ilql_ckpt['zero_size_leaves']} of them "
                           f"zero-size; one more update bit-identical")
    ilql_parity = ilql_parity_phase(ilql_tree, device)
    del ilql_tree
    torch.cuda.empty_cache() if device == "cuda" else None
    ilql_lengths = (ilql.pop("first_mask").sum(1) + 1).tolist()
    ilql_errs = check_flash_at(device, "ILQL shape (terminal-holed mask)",
                               80, ilql["T"], ilql_lengths)
    flash_ilql = time_flash(device, "ILQL shape (terminal-holed mask)", 80,
                            ilql["T"], iters=10, lengths=ilql_lengths)
    release(device)
    tree, batch = mesh_inputs
    mesh = mesh_phase(tree, batch.map(lambda x: x.to(device)), device, card)
    log_mesh(mesh, card)
    durability = {
        "ppo_save_ms": train["save_ms"],
        "ppo_checkpoint_bytes": train["checkpoint_bytes"],
        "ppo_restore_ms": restore_ms,
        "ilql_save_ms": ilql_ckpt["save_s"] * 1e3,
        "ilql_restore_ms": ilql_ckpt["restore_s"] * 1e3,
        "ilql_checkpoint_bytes": ilql_ckpt["bytes"],
        "serve_checkpoint_load_s": serve_ckpt["load_s"],
        "resume": resume, "gate": gate,
    }
    log("durability", f"PPO checkpoint {train['checkpoint_bytes']} bytes: "
                      f"save {[round(t, 1) for t in train['save_ms']]} ms, "
                      f"restore {restore_ms:.1f} ms; ILQL checkpoint "
                      f"{ilql_ckpt['bytes']} bytes: save "
                      f"{ilql_ckpt['save_s'] * 1e3:.1f} ms, restore "
                      f"{ilql_ckpt['restore_s'] * 1e3:.1f} ms ({card})")
    train.pop("orch_device")
    run_floor = {"first_call_s": train["first_call_s"],
                 "mfu": train["mfu"], "peak_gb": train["peak_gb"],
                 "supervision": cost, "drills": drills,
                 "seam_capture": capture,
                 "profile": profile, "escalation": esc}
    return {"run_floor": run_floor,
            "train": train, "ilql": ilql, "train_parity": train_parity,
            "ppo_ab": ppo_ab, "ilql_ab": ilql_ab,
            "ilql_parity": ilql_parity, "ilql_errs": ilql_errs,
            "flash_ilql": flash_ilql, "serve_checkpoint": serve_ckpt,
            "spec_draft": draft, "serve_lifecycle": lifecycle,
            "fleet": fleet, "native": host,
            "durability": durability, "mesh": mesh}


# --------------------------------------------------------------------- #
# 11. gpt-j-6B at its published width, in a child process
# --------------------------------------------------------------------- #

#: gpt-j-6B's published geometry (``ModelSpec.preset("gpt-j-6b")``):
#: vocab 50400, 28 layers, 16 heads of 256, d_model 4096, d_ff 16384,
#: rotary_dim 64, n_positions 2048, an untied lm_head
GPTJ_SPEC = dict(ModelSpec.preset("gpt-j-6b").__dict__)
#: the recipe's 4-byte prompts (input_size 4)
GPTJ_PROMPTS = ["The ", "A ca", "Once", "When", "Data", "Rain", "Hope",
                "Time", "Fire", "Blue", "Cold", "Moon", "Wind", "Gold",
                "Road", "Star"]
#: what the served gpt-j policy answers (prompts within the 16-token
#: bucket, mixed lengths)
GPTJ_REQUESTS = [("Hello", 32), ("The card", 24), ("x", 8),
                 ("Tell a story", 32), ("What is 2+2?", 16),
                 ("Name a fruit", 28), ("Why?", 20), ("Count to 5", 12)]


def release(device):
    """Free what the dropped trainers and engines held: they sit in
    reference cycles (a trainer and its orchestrator, an engine and its
    scheduler), which only the cycle collector frees, and the caching
    allocator keeps freed blocks until emptied."""
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def gptj_recipe_config() -> dict:
    """configs/ppo_gptj_single_chip.yml as a dict (no pyyaml on the card
    machine; tests/test_torch_adafactor.py holds the two equal)."""
    return {
        "model": {
            "model_path": "EleutherAI/gpt-j-6B", "tokenizer_path": "gpt2",
            "model_type": "JaxPPOTrainer", "num_layers_unfrozen": 1,
            "compute_dtype": "bfloat16", "param_dtype": "bfloat16",
        },
        "train": {
            "n_ctx": 512, "epochs": 10, "total_steps": 80000,
            "batch_size": 8, "grad_clip": 1.0, "lr_ramp_steps": 100,
            "lr_decay_steps": 79000, "weight_decay": 1.0e-6,
            "learning_rate_init": 1.412e-4,
            "learning_rate_target": 1.412e-4, "log_interval": 25,
            "checkpoint_interval": 1000000, "eval_interval": 16,
            "pipeline": "PPOPipeline", "orchestrator": "PPOOrchestrator",
            "input_size": 4, "gen_size": 48, "seed": 0, "remat": True,
            "optimizer": "adafactor",
        },
        "method": {
            "name": "ppoconfig", "num_rollouts": 8, "chunk_size": 8,
            "ppo_epochs": 4, "init_kl_coef": 0.2, "target": 6,
            "horizon": 10000, "gamma": 1, "lam": 0.95, "cliprange": 0.2,
            "cliprange_value": 0.2, "vf_coef": 2.3,
            "gen_kwargs": {"max_length": 48, "min_length": 48,
                           "temperature": 0.5, "top_k": 0, "top_p": 0.7,
                           "do_sample": True},
        },
    }


def gptj_smoke_config(run_dir, continuous):
    """The recipe as shipped, but for: the synthetic checkpoint's spec as
    ``model_spec`` (no transformers on the card to read a config), 3
    cycles (3 epochs of one batch x 4 passes), stats every cycle, the
    commit gate on (``max_bad_steps`` 2, to show it skips nothing),
    ``continuous_rollouts`` as given, run files under ``run_dir``."""
    cfg = gptj_recipe_config()
    cfg["model"]["model_spec"] = dict(GPTJ_SPEC)
    cfg["train"].update(epochs=3, total_steps=12, log_interval=4,
                        max_bad_steps=2, continuous_rollouts=continuous,
                        checkpoint_dir=run_dir)
    return cfg


def gptj_tldr_config(run_dir, compute_dtype="bfloat16", fused=True,
                     ppo_epochs=4, n_layer=None):
    """configs/ppo_tldr.yml's shape at gpt-j-6B width ("gpt-j-6B at full
    scale", its line 6): 512-token prompts + 64 generated, 2 unfrozen
    layers, ``fused_attention``, frozen storage in ``compute_dtype``;
    batch 8, one cycle of 8 rollouts and ``ppo_epochs`` passes; depth
    ``n_layer`` (default the published 28)."""
    cfg = train_config_dict(compute_dtype, fused, ppo_epochs)
    cfg["model"].update(model_spec=dict(GPTJ_SPEC,
                                        n_layer=n_layer or GPTJ_SPEC[
                                            "n_layer"]),
                        param_dtype=compute_dtype)
    cfg["train"].update(batch_size=8, total_steps=ppo_epochs,
                        log_interval=ppo_epochs, checkpoint_dir=run_dir)
    cfg["method"].update(num_rollouts=8, chunk_size=8)
    return cfg


def gptj_state_dict(spec, device, seed=0, dtype=torch.bfloat16):
    """A seeded gpt-j checkpoint laid out as HF's GPTJForCausalLM
    ``state_dict`` (HF's tensor names; nn.Linear weights [out, in]), made
    on the card with an explicit CUDA generator: N(0, 0.02) matrices, the
    residual projections' scaled by 1 / sqrt(2 n_layer), zero biases,
    unit norm scales."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, V, L = spec.d_model, spec.d_ff, spec.vocab_size, spec.n_layer
    resid = 0.02 / math.sqrt(2 * L)

    def normal(*shape, std=0.02):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, std, generator=gen)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    sd = {"transformer.wte.weight": normal(V, d),
          "transformer.ln_f.weight": const(1.0, d),
          "transformer.ln_f.bias": const(0.0, d),
          "lm_head.weight": normal(V, d), "lm_head.bias": const(0.0, V)}
    for i in range(L):
        h = f"transformer.h.{i}."
        sd.update({
            h + "ln_1.weight": const(1.0, d), h + "ln_1.bias": const(0.0, d),
            h + "attn.q_proj.weight": normal(d, d),
            h + "attn.k_proj.weight": normal(d, d),
            h + "attn.v_proj.weight": normal(d, d),
            h + "attn.out_proj.weight": normal(d, d, std=resid),
            h + "mlp.fc_in.weight": normal(f, d),
            h + "mlp.fc_in.bias": const(0.0, f),
            h + "mlp.fc_out.weight": normal(d, f, std=resid),
            h + "mlp.fc_out.bias": const(0.0, d),
        })
    return sd


def gptj_tree(cfg, device, seed=0):
    """The trainer's hydra tree from :func:`gptj_state_dict` (in the
    config's frozen storage dtype) through the ported converter and
    ``hydra_params_from_trunk``, on the card; the state dict is dropped
    once converted."""
    spec = cfg.model.resolve_spec()
    frozen = DTYPES[cfg.model.param_dtype]
    sd = gptj_state_dict(spec, device, seed, frozen)
    trunk = convert_state_dict(sd, spec, dtype=None)
    del sd
    return hydra_params_from_trunk(
        HydraPolicy(spec, cfg.model.num_layers_unfrozen), *trunk,
        np.random.default_rng(seed), frozen_dtype=frozen)


def gptj_stack(cfg, device, prompts, seed=0):
    """Trainer (adopting :func:`gptj_tree` on the card), pipeline and
    orchestrator with the host reward."""
    trainer = get_model(cfg.model.model_type)(
        cfg, device=device, params=gptj_tree(cfg, device, seed))
    pipeline = get_pipeline(cfg.train.pipeline)(prompts, trainer.tokenizer,
                                                cfg)
    orch = get_orchestrator(cfg.train.orchestrator)(
        trainer, pipeline, reward_fn=host_reward,
        chunk_size=cfg.method.chunk_size)
    return trainer, orch


def hist_times(name):
    """Every duration of telemetry span ``name`` (s), first call first."""
    h = telemetry.current().registry.hists.get(name)
    return [] if h is None else [h.first] + list(h.window)


def gptj_recipe_phase(device, continuous):
    """configs/ppo_gptj_single_chip.yml (:func:`gptj_smoke_config`):
    make_experience, then learn() over 3 cycles with a host reward.
    Every logged loss, grad norm and KL finite, every ``bad_step`` 0,
    ``compile/recompiles`` 0; the state estimate ``_check_memory_fit``
    made beside the peak device memory of the run (reset once the
    trainer is built)."""
    run_dir = os.path.join(CKPT_ROOT, "gptj", f"recipe_{int(continuous)}")
    cfg = TRLConfig.from_dict(gptj_smoke_config(run_dir, continuous))
    torch.cuda.reset_peak_memory_stats() if device == "cuda" else None
    t0 = time.perf_counter()
    trainer, orch = gptj_stack(cfg, device, GPTJ_PROMPTS)
    sync(device)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30 \
        if device == "cuda" else 0.0
    torch.cuda.reset_peak_memory_stats() if device == "cuda" else None
    records = []
    t0 = time.perf_counter()
    orch.make_experience(cfg.method.num_rollouts)
    trainer.learn(log_fn=records.append)
    sync(device)
    wall = time.perf_counter() - t0
    logs = [r for r in records if "loss" in r]
    assert len(logs) == 3 and trainer.iter_count == 12, records
    for entry in logs:
        for key in ("loss", "pg_loss", "vf_loss", "grad_norm", "approx_kl"):
            assert np.isfinite(entry[key]), (key, entry)
        assert entry["bad_step"] == 0.0, entry
    assert recompiles() == 0, f"recompiled {recompiles()} times"
    refresh = hist_times("time/rollout_harvest") + hist_times(
        "time/rollout_dispatch_stale") if continuous \
        else hist_times("time/rollout_refresh")
    assert len(refresh) == (4 if continuous else 2), refresh
    return trainer, cfg, {
        "build_s": build_s, "build_peak_gb": build_peak, "wall_s": wall,
        "update_s": hist_times("time/ppo_update"),
        "first_rollout_s": hist_times("time/rollout")[0],
        "refresh_s": hist_times("time/rollout_refresh"),
        "dispatch_stale_s": hist_times("time/rollout_dispatch_stale"),
        "harvest_s": hist_times("time/rollout_harvest"),
        "losses": [e["loss"] for e in logs],
        "hbm_peak_gb": logs[-1].get("device/hbm_peak_gb"),
        "state_estimate_gb": trainer.state_bytes / 2**30,
        "grad_gb": sum(p.numel() * 4 for _, p in named_leaves(
            trainer.params["trainable"])) / 2**30,
        "decode_graphs": trainer.decoder.step.signatures(),
    }


def gptj_engine(cfg_dict, params, device, compute_dtype, attention,
                **tiers):
    """An engine on a trainer's parameters where they live (no checkpoint
    round trip), greedy, one bucket of 8 x (16 + 32), 8 slots of pages of
    16; ``tiers``: kv_dtype / weights_dtype."""
    cfg = json.loads(json.dumps(cfg_dict))
    cfg["model"]["compute_dtype"] = compute_dtype
    cfg["method"]["gen_kwargs"]["do_sample"] = False
    serve = ServeConfig(buckets=[[8, 16, 32]], slots=8, page_size=16,
                        attention=attention, max_queue=64,
                        request_timeout=600.0, **tiers)
    return InferenceEngine(TRLConfig.from_dict(cfg), serve=serve,
                           device=device, params=params)


def gptj_serve_phase(trainer, cfg_dict, device):
    """The trained policy served through the slot scheduler: bf16 on the
    kernel path (paged decode inside the decode step's CUDA graph;
    launches == layers x decode steps, 0 recompiles), then fp32 on the
    kernel path and on the plain gather path, greedy tokens identical;
    where the bf16 tokens part from the fp32 ones, the fp32 top-2 logit
    gap there is printed (as parity_phase does)."""
    telemetry.start()
    engine = gptj_engine(cfg_dict, trainer.params, device, "bfloat16",
                         "pallas")
    ops.reset_launches()
    t0 = time.perf_counter()
    bf16, sched = run_scheduler(engine, GPTJ_REQUESTS)
    wall = time.perf_counter() - t0
    launches, steps = ops.LAUNCHES["paged_decode"], sched.runtime.steps
    L = engine.spec.n_layer
    if device == "cuda":
        assert launches == L * steps, (launches, L, steps)
    assert recompiles() == 0, f"serve recompiled {recompiles()} times"
    step = telemetry.current().registry.hists["time/serve/slot_step"]
    step_p50 = step.quantile(0.5) * 1e3
    graphs = graph_stats(sched.runtime.graphs())
    bf16_gb = telemetry.current().registry.gauges["serve/model_gb"]
    bf16_logits = probe_logits(sched, engine.encode_prompt(
        GPTJ_REQUESTS[0][0]))
    del engine, sched
    release(device)
    int8 = gptj_int8_serve_phase(trainer, cfg_dict, device, bf16, bf16_gb,
                                 bf16_logits, step_p50)
    fp32 = {}
    for attention in ("pallas", "jnp"):
        telemetry.start()
        engine = gptj_engine(cfg_dict, trainer.params, device, "float32",
                             attention)
        fp32[attention], _ = run_scheduler(engine, GPTJ_REQUESTS)
        if attention == "pallas":
            del engine
            release(device)
    assert fp32["pallas"] == fp32["jnp"], "kernel path != plain path (fp32)"
    parted = {}
    for i, (a, b) in enumerate(zip(bf16, fp32["jnp"])):
        if a != b:
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            parted[i] = (j, logit_gap(engine, engine.encode_prompt(
                GPTJ_REQUESTS[i][0]) + b[:j]))
    del engine
    release(device)
    return {"launches": launches, "steps": steps, "layers": L,
            "tokens": sum(len(t) for t in bf16), "wall_s": wall,
            "step_p50_ms": step_p50, "graphs": graphs,
            "bf16_parted": parted, "requests": len(GPTJ_REQUESTS),
            "int8": int8}


@torch.no_grad()
def probe_logits(sched, prompt):
    """The first step's logits of ``prompt`` through a scheduler's own
    prefill (slot 0 of a warmed runtime, its first pages; the other rows
    fillers), as float32 on the host."""
    rt = sched.runtime
    Bp, P = 8, 16
    tokens = np.zeros((Bp, P), np.int32)
    mask = np.zeros((Bp, P), np.int32)
    tokens[0, :len(prompt)], mask[0, :len(prompt)] = prompt, 1
    slots = np.full((Bp,), rt.num_slots, np.int32)
    slots[0] = 0
    tables = np.full((Bp, rt.max_pages), rt.num_pages, np.int32)
    tables[0] = np.arange(rt.max_pages)
    rt.prefill((Bp, P), tokens, mask, slots, np.ones(Bp, np.int32),
               page_tables=tables, start=np.zeros(Bp, np.int32))
    return rt.state.logits[0].float().cpu()


def int8_projection_cost(engine, device, iters=50):
    """Device time (CUDA graph) of one decode step's int8 projections at
    8 rows, layer 0 of the trunk times the layers: the ``codes.to(bf16)``
    copy alone, the whole int8 projection (copy, matmul, scale) and the
    bf16 matmul on a bf16 copy of the same weight."""
    p = layer_params(engine.blocks[0], 0)
    out = {"convert_ms": 0.0, "int8_ms": 0.0, "bf16_ms": 0.0}
    if device != "cuda":
        return out
    for part in ("attn", "mlp"):
        for leaf in p[part].values():
            if not isinstance(leaf, tuple):
                continue
            codes, scale = leaf
            x = torch.randn(8, codes.shape[0], device=device,
                            dtype=torch.bfloat16)
            w = codes.to(torch.bfloat16)
            times = graph_ms([lambda: codes.to(torch.bfloat16),
                              lambda: project(x, (codes, scale)),
                              lambda: x @ w], [()], iters)
            for key, t in zip(out, times):
                out[key] += t * engine.spec.n_layer
            del w
    return out


def gptj_int8_serve_phase(trainer, cfg_dict, device, bf16, bf16_gb,
                          bf16_logits, bf16_p50):
    """The same trained policy served with ``weights_dtype: int8`` and
    ``kv_dtype: int8`` on the kernel path (bf16 q x int8 pool at hd 256),
    8 slots, one bucket of 8 x (16 + 32): ``serve/model_gb`` against
    bf16's, paged decode launches == layers x steps, 0 recompiles, every
    request as long as its bf16 response (the bound trlx_tpu's
    test_weights_int8_tracks_bf16_logits puts on the tier), the first
    step's logit gap to the bf16 engine's, the step p50s, the peak device
    memory of the int8 engine (its in-graph bf16 weight copies come from
    the graphs' pools) and the cost of those copies."""
    telemetry.start()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = gptj_engine(cfg_dict, trainer.params, device, "bfloat16",
                         "pallas", weights_dtype="int8", kv_dtype="int8")
    sync(device)
    build_s = time.perf_counter() - t0
    gb = telemetry.current().registry.gauges["serve/model_gb"]
    ops.reset_launches()
    tokens, sched = run_scheduler(engine, GPTJ_REQUESTS)
    launches, steps = ops.LAUNCHES["paged_decode"], sched.runtime.steps
    swap = gptj_swap(engine, sched, trainer.params, tokens, device)
    L = engine.spec.n_layer
    if device == "cuda":
        assert launches == L * steps > 0, (launches, L, steps)
    assert recompiles() == 0, f"int8 serve recompiled {recompiles()} times"
    assert [len(t) for t in tokens] == [len(t) for t in bf16], (tokens, bf16)
    logits = probe_logits(sched, engine.encode_prompt(GPTJ_REQUESTS[0][0]))
    assert torch.isfinite(logits).all()
    gap = float((logits - bf16_logits).abs().max())
    top = bool(logits.argmax() == bf16_logits.argmax())
    p50 = telemetry.current().registry.hists[
        "time/serve/slot_step"].quantile(0.5) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30         if device == "cuda" else 0.0
    graphs = graph_stats(sched.runtime.graphs())
    cost = int8_projection_cost(engine, device)
    same = sum(a == b for a, b in zip(tokens, bf16))
    del engine, sched
    release(device)
    return {"model_gb": gb, "bf16_model_gb": bf16_gb, "launches": launches,
            "steps": steps, "layers": L, "logit_gap": gap,
            "same_top1": top, "step_p50_ms": p50,
            "bf16_step_p50_ms": bf16_p50, "peak_gb": peak,
            "graphs": graphs, "projection": cost, "build_s": build_s,
            "identical": f"{same}/{len(tokens)}", "swap": swap}


def rerun(sched, engine, requests):
    """``requests`` through a stopped scheduler again (its graphs and
    pool reused): all queued, then its worker started and stopped."""
    reqs = [sched.submit(engine.encode_prompt(p), max_new_tokens=n)
            for p, n in requests]
    sched.start()
    try:
        return [r.wait(timeout=600).result for r in reqs]
    finally:
        sched.stop()


def gptj_swap(engine, sched, params, tokens, device):
    """One hot-swap of the int8-weight engine to the trainer's own params
    (the block matrices quantized again on the card and installed in
    place; the leaves the engine serves from the trainer's tree are that
    very tree's, so they stay; probed): committed at model_version 2,
    every engine tensor at its address, 0 recompiles, and the same
    greedy tokens as before (the same weights quantize to the same
    codes). Returns the swap's wall time."""
    ptrs = engine_ptrs(engine)
    sync(device)
    t0 = time.perf_counter()
    result = sched.request_swap(params, label="trainer params")
    sync(device)
    swap_s = time.perf_counter() - t0
    assert result["reloaded"] is True, result
    assert engine.model_version == 2, result
    assert engine_ptrs(engine) == ptrs, "the swap moved a tensor"
    assert recompiles() == 0, f"the swap recompiled {recompiles()} times"
    assert rerun(sched, engine, GPTJ_REQUESTS) == tokens, \
        "the swapped int8 engine changed the tokens"
    return {"swap_s": swap_s, "model_version": engine.model_version}


def gptj_flash_phase(device):
    """One PPO cycle at configs/ppo_tldr.yml's shape at gpt-j-6B width
    (:func:`gptj_tldr_config`, bf16, ``fused_attention``): flash
    launches == chunks x (L + k) + passes x L forwards and passes x k of
    each backward kernel, all at hd 256; finite losses. Returns the
    counts and one rollout batch."""
    run_dir = os.path.join(CKPT_ROOT, "gptj", "tldr")
    cfg = TRLConfig.from_dict(gptj_tldr_config(run_dir))
    trainer, orch = gptj_stack(cfg, device, ppo_tldr.synthetic_documents(8),
                               seed=1)
    if device == "cuda":
        assert trainer.policy.spec.head_dim == 256
    records = []
    ops.reset_launches()
    t0 = time.perf_counter()
    orch.make_experience(cfg.method.num_rollouts)
    trainer.learn(log_fn=records.append)
    sync(device)
    wall = time.perf_counter() - t0
    launches = {n: ops.LAUNCHES[n] for n in FLASH_NAMES}
    L, k = trainer.policy.spec.n_layer, trainer.policy.k
    chunks = cfg.method.num_rollouts // cfg.method.chunk_size
    passes = trainer.iter_count
    want = {"flash_fwd": chunks * (L + k) + passes * L,
            "flash_bwd_dq": passes * k, "flash_bwd_dkv": passes * k}
    if device == "cuda":
        assert launches == want, f"flash launches {launches} != {want}"
    logs = [r for r in records if "loss" in r]
    assert logs and all(np.isfinite(e["loss"]) and np.isfinite(
        e["grad_norm"]) for e in logs), logs
    batch = trainer.store._stacked().map(lambda x: x[:8])
    return {"launches": launches, "want": want, "wall_s": wall,
            "update_s": hist_times("time/ppo_update"),
            "loss": logs[-1]["loss"]}, batch


def gptj_child(device="cuda"):
    """The gpt-j-6B phase (``chip_smoke.py --gptj-child [device]``):
    the single-card recipe with continuous rollouts off, then on; the
    trained policy served; the flash path at the TL;DR shape and its
    fp32 kernel-against-dense step at 2 layers of the same width. Prints
    its lines, then one JSON line of its numbers."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out, t0 = {}, time.perf_counter()

    def done(part):
        log("gptj-child", f"{part} done at {time.perf_counter() - t0:.1f}s")

    try:
        for continuous in (False, True):
            trainer, cfg, out[f"recipe_{int(continuous)}"] = \
                gptj_recipe_phase(device, continuous)
            done(f"recipe (continuous_rollouts {continuous})")
            if not continuous:
                del trainer
                release(device)
        out["serve"] = gptj_serve_phase(trainer, cfg.to_nested_dict(),
                                        device)
        done("serve")
        del trainer
        release(device)
        out["flash"], batch = gptj_flash_phase(device)
        done("TL;DR flash cycle")
        release(device)
        parity_dir = os.path.join(CKPT_ROOT, "gptj", "parity")

        def parity_config(dtype, fused, epochs):
            # 2 layers, the top one trainable: the float32 trainable
            # branch (a block, the untied lm_head, the value head; 441 M
            # parameters) and its copies stay a fraction of the card
            cfg = gptj_tldr_config(parity_dir, dtype, fused, epochs,
                                   n_layer=2)
            cfg["model"]["num_layers_unfrozen"] = 1
            return cfg

        tree = gptj_tree(TRLConfig.from_dict(parity_config("float32", True,
                                                           2)),
                         device, seed=2)
        # each trainer copies its own trainable top (the kernel path's
        # step must not move the dense path's); the frozen trunk is shared
        tree["trainable"] = tree_map(lambda x: x.cpu().numpy(),
                                     tree["trainable"])
        out["parity"] = train_parity_phase(tree, batch, device,
                                           parity_config, phase="gptj-parity")
        done("parity")
    finally:
        shutil.rmtree(os.path.join(CKPT_ROOT, "gptj"), ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


def log_gptj(g, card):
    """The gpt-j child's numbers, one line a part."""
    def times(seconds):
        return [round(t, 3) for t in seconds]

    for key in ("recipe_0", "recipe_1"):
        r = g[key]
        refresh = (f"dispatch (stale) {times(r['dispatch_stale_s'])} s + "
                   f"harvest {times(r['harvest_s'])} s"
                   if key == "recipe_1" else
                   f"refresh {times(r['refresh_s'])} s")
        log("gptj", f"configs/ppo_gptj_single_chip.yml (adafactor, 1 "
                    f"unfrozen layer, bf16 frozen storage, remat, B8, 4 + 48 "
                    f"tokens, top_p 0.7, temperature 0.5), continuous_"
                    f"rollouts {key == 'recipe_1'}: 3 cycles in "
                    f"{r['wall_s']:.2f}s; update (4 passes) "
                    f"{times(r['update_s'])} s; first "
                    f"rollout {r['first_rollout_s']:.3f}s, {refresh}; "
                    f"losses {[round(x, 4) for x in r['losses']]}, no step "
                    f"skipped by the gate, 0 recompiles; device/hbm_peak_gb "
                    f"{r['hbm_peak_gb']:.3f} against _check_memory_fit's "
                    f"{r['state_estimate_gb']:.3f} GiB of state + "
                    f"{r['grad_gb']:.3f} GiB of gradients; building the "
                    f"trainer from the synthetic checkpoint took "
                    f"{r['build_s']:.2f}s, peak {r['build_peak_gb']:.3f} GiB "
                    f"({card})")
    sv = g["serve"]
    log("gptj", f"the trained policy served (8 slots, bucket 8 x (16 + 32)): "
                f"{sv['requests']} requests, {sv['tokens']} tokens in "
                f"{sv['wall_s']:.2f}s, decode step p50 {sv['step_p50_ms']:.2f}"
                f" ms; paged decode launches {sv['launches']} == "
                f"{sv['layers']} layers x {sv['steps']} steps inside the "
                f"step's CUDA graph, 0 recompiles; fp32 greedy tokens "
                f"identical kernel vs plain path; bf16 parts from fp32 at "
                f"(request: token, fp32 top-2 logit gap) {sv['bf16_parted']} "
                f"({card})")
    i8 = sv["int8"]
    pr = i8["projection"]
    log("gptj", f"the same policy served with weights_dtype int8 and "
                f"kv_dtype int8 (attention pallas, bf16): serve/model_gb "
                f"{i8['model_gb']:.3f} vs bf16's {i8['bf16_model_gb']:.3f};"
                f" paged decode (bf16 q x int8 pool, hd 256) launches "
                f"{i8['launches']} == {i8['layers']} layers x {i8['steps']}"
                f" steps, 0 recompiles; every response as long as bf16's, "
                f"{i8['identical']} identical; first-step logit gap to the "
                f"bf16 engine {i8['logit_gap']:.4f} (same top-1: "
                f"{i8['same_top1']}); decode step p50 "
                f"{i8['step_p50_ms']:.2f} ms vs bf16's "
                f"{i8['bf16_step_p50_ms']:.2f} ms; peak "
                f"{i8['peak_gb']:.3f} GiB, graphs {i8['graphs']}; one "
                f"step's int8 projections (8 rows, {i8['layers']} layers): "
                f"codes.to(bf16) copies {pr['convert_ms']:.3f} ms, int8 "
                f"projection {pr['int8_ms']:.3f} ms, bf16 matmul alone "
                f"{pr['bf16_ms']:.3f} ms; engine built in "
                f"{i8['build_s']:.2f}s ({card})")
    log("gptj", f"hot-swap of the int8-weight engine to the trainer's "
                f"params (quantized on the card, installed in place, "
                f"probed): {i8['swap']['swap_s'] * 1e3:.1f} ms, "
                f"model_version {i8['swap']['model_version']}, every "
                f"engine tensor at its address, 0 recompiles, the same "
                f"tokens after ({card})")
    fl = g["flash"]
    log("gptj", f"one PPO cycle at the TL;DR shape (B8, 512 + 64, 2 "
                f"unfrozen layers, fused_attention, bf16): flash launches at "
                f"hd 256 {fl['launches']} == {fl['want']}; {fl['wall_s']:.2f}s"
                f", update (4 passes) {times(fl['update_s'])} s, last loss "
                f"{fl['loss']:.4f} ({card})")
    log("gptj", f"fp32 kernel vs dense at 2 layers of gpt-j width: worst "
                f"loss / grad norm relative {g['parity']['worst_rel']:.2e} "
                f"(rtol 1e-5), gradients relative L2 "
                f"{g['parity']['grads_rel_l2']:.2e} (rtol 2e-3)")


def kernel_entry(name, source, replaces, launches, err, t, by_phase):
    """One entry of the kernels line from a timing dict of time_kernel /
    time_flash."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_phase": by_phase, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def run_gptj_child(device="cuda", timeout=900):
    """:func:`gptj_child` in its own process (its 15-30 GB never overlap
    the gpt2 phases'; its peak is its own): its lines re-printed, its
    JSON returned; a non-zero exit fails the run."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--gptj-child", device],
        capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    assert proc.returncode == 0 and lines, (
        f"gpt-j child exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
        f"{proc.stderr[-8000:]}")
    return json.loads(lines[-1])


# --------------------------------------------------------------------- #
# main
# --------------------------------------------------------------------- #


def main() -> int:
    # every load is local: a checkpoint name never reaches for a hub
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    if sys.argv[1:2] == ["--escalation-child"]:
        return escalation_child(*sys.argv[2:5])
    if sys.argv[1:2] == ["--gptj-child"]:
        return gptj_child(*sys.argv[2:3])
    if sys.argv[1:2] == ["--serve-mesh-child"]:
        return serve_mesh_child(*sys.argv[2:8])
    if sys.argv[1:2] == ["--paged-decode"]:
        return paged_decode_only()
    if sys.argv[1:2] == ["--paged-times"]:
        return paged_decode_only(times_only=True)
    if sys.argv[1:2] == ["--rollout-decode"]:
        return paged_decode_only(times_only="rollout")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("device", f"{card}; torch {torch.__version__} cuda "
                  f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} "
                  f"x{torch.cuda.device_count()}")

    info = _build.build()
    for name, entry in info.items():
        log("build", f"{name}: {entry['seconds']:.2f}s nvcc")
        for ln in ptxas_summary(str(entry["log"])):
            log("build", f"  {ln}")
    sass = flash_sass()
    log("build", "bf16 flash SASS (cuobjdump -sass; HGMMA = wgmma, "
                 "UTMALDG = TMA load, HMMA = mma.sync): " + "; ".join(
                     f"{k} {c['HGMMA']} / {c['UTMALDG']} / {c['HMMA']}"
                     for k, c in sorted(sass.items())))
    assert len(sass) == 3 * len(fa.HEAD_DIMS), sorted(sass)
    for k, c in sass.items():
        assert c["HGMMA"] and c["UTMALDG"] and not c["HMMA"], (k, c)
    for hd in fa.HEAD_DIMS:
        built, plan = fa.backward_smem_bytes(hd), fa.shared_memory_bytes(hd)
        assert all(built[n] == plan[n] for n in built), (hd, built, plan)
        fwd, geo = fa.forward_plan(hd), fa.forward_geometry(hd)
        assert fwd == {"consumers": geo["consumers"],
                       "blocks": geo["blocks"], "stages": geo["stages"],
                       "registers": geo["registers"],
                       "smem": plan["flash_fwd"]}, (hd, fwd, geo)
    log("build", f"flash kernels' dynamic shared memory at hd 64: bf16 "
                 f"{fa.shared_memory_bytes(64)} B, fp32 "
                 f"{fa.shared_memory_bytes(64, torch.float32)} B; at hd "
                 f"256: bf16 {fa.shared_memory_bytes(256)} B, fp32 "
                 f"{fa.shared_memory_bytes(256, torch.float32)} B")
    check_paged_build()

    # gpt-j-6B first, while this process holds next to nothing on the card
    gptj = run_gptj_child("cuda")
    log_gptj(gptj, card)

    paged_errs, paged, sweeps = paged_phase("cuda")
    err, gptj_paged_err = paged_errs["kernel"], paged_errs["gptj"]
    int8_err, shard_err = paged_errs["int8"], paged_errs["shards"]
    serving, long_ctx = paged["serving"], paged["ctx1024"]
    gptj_serving, gptj_long = paged["gptj_serving"], paged["gptj_ctx1024"]
    int8_serving = paged["int8_serving"]
    gptj_int8_serving = paged["gptj_int8_serving"]
    shard_times = {f"H{H}_hd{hd}": paged[f"H{H}_hd{hd}"]
                   for H, hd in SHARD_SHAPES}
    by_partitions = sweeps["ctx1024"]
    gptj_by_partitions = {"serving": sweeps["gptj_serving"],
                          "ctx1024": sweeps["gptj_ctx1024"]}

    flash_err = check_flash("cuda")
    flash_slice = time_flash("cuda", "training shape", 32, 576, iters=10)
    flash_long = time_flash("cuda", "2048-token", 8, 2048, iters=5)
    gptj_flash_err = check_flash_gptj("cuda")
    flash_gptj = time_flash("cuda", "gpt-j TL;DR shape", iters=10,
                            **GPTJ_FLASH)
    sp = sp_phase("cuda")
    pp = pp_phase("cuda")
    flash_err = {n: max(flash_err[n], sp["errs"][n]) for n in flash_err}

    views = init_decode_views(TRLConfig.from_dict(config_dict()).model
                              .resolve_spec(), seed=0,
                              num_layers_unfrozen=2)
    run = serve_phase(views, "cuda")
    log("serve", f"{len(run['results'])} concurrent HTTP requests, "
                 f"{run['tokens']} tokens in {run['wall_s']:.3f}s = "
                 f"{run['tok_per_s']:.1f} tok/s, latency p50 "
                 f"{run['latency_p50_ms']:.1f} ms max "
                 f"{run['latency_max_ms']:.1f} ms, warmup "
                 f"{run['warmup_s']:.2f}s; {run['steps']} decode steps, "
                 f"{run['launches']} kernel launches, prefix tokens saved "
                 f"{run['prefix_tokens_saved']:.0f}; decode step p50 "
                 f"{run['step_p50_ms']:.2f} ms p95 {run['step_p95_ms']:.2f}"
                 f" ms over {run['step_count']} steps, prefill "
                 f"{run['prefill_s']:.3f}s in {run['prefill_calls']} calls "
                 f"({card}; for information, not a metric)")
    parity = parity_phase(views, "cuda")
    log("parity", f"fp32 greedy tokens identical on {len(parity['jnp'])} "
                  f"requests (kernel path vs plain path)")
    log("graphs-serve", f"the serve phase replayed {run['graphs']} "
                        f"(capture seconds, private-pool bytes), 0 "
                        f"recompiles")
    serve_ab = serve_ab_phase(views, "cuda")
    for name, runs in serve_ab.items():
        e, g = runs[False], runs[True]
        log("graphs-serve", f"{name}: tokens identical graph vs eager, "
                            f"paged decode launches {g['launches']} == "
                            f"{e['launches']} = layers x {g['steps']} "
                            f"steps, 0 recompiles; step p50 "
                            f"{e['step_p50_ms']:.2f} ms eager, "
                            f"{g['step_p50_ms']:.2f} ms graph, p95 "
                            f"{e['step_p95_ms']:.2f} / "
                            f"{g['step_p95_ms']:.2f} ms; {g['graphs']} "
                            f"({card})")
    tiers = serve_tiers_phase(views, "cuda", parity["jnp"])
    log_tiers(tiers, card)
    serve_mesh = serve_mesh_phase(views, "cuda", parity["jnp"], card)
    del views

    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    # the serve watchdog's children start here, beside the PPO phase, so
    # their 60 s stall grace has passed when [serve-lifecycle] checks them
    watchdog = ServeWatchdogDrive(os.path.join(CKPT_ROOT, "serve_children"),
                                  "cuda")
    watchdog.start()
    try:
        durable = durability_phases(card, watchdog)
    finally:
        watchdog.kill()
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    train, ilql = durable["train"], durable["ilql"]
    train_parity, ilql_parity = durable["train_parity"], \
        durable["ilql_parity"]
    flash_err = {n: max(flash_err[n], durable["ilql_errs"][n])
                 for n in flash_err}
    flash_ilql = durable["flash_ilql"]
    serve_ckpt = durable["serve_checkpoint"]
    lifecycle = durable["serve_lifecycle"]
    fleet = durable["fleet"]

    print(json.dumps({"timing": {
        "serving_shape": serving, "ctx1024": long_ctx,
        "paged_stream4096": paged["stream4096"],
        "ctx1024_by_partitions": by_partitions,
        "flash_training_shape": flash_slice, "flash_2048": flash_long,
        "train": {k: train[k] for k in ("wall_s", "rollout_s", "update_s",
                                        "samples_per_sec", "launches",
                                        "save_ms", "checkpoint_bytes")},
        "durability": durable["durability"],
        "train_parity": train_parity,
        "mesh": {k: v for k, v in durable["mesh"].items() if k != "card"},
        "sp": sp["runs"], "pp": pp["runs"],
        "ilql": {k: ilql[k] for k in ("wall_s", "step_p50_s", "steps_s",
                                      "tokens_per_s", "eval_s",
                                      "max_memory_gb", "launches", "T",
                                      "split_ms")},
        "ilql_parity": ilql_parity, "flash_ilql_shape": flash_ilql,
        "run_floor": durable["run_floor"],
        "graphs": {"serve": run["graphs"], "serve_ab": serve_ab,
                   "ppo": train["graphs"], "ppo_ab": durable["ppo_ab"],
                   "ilql_ab": durable["ilql_ab"]},
        "gptj": {**gptj, "paged_serving": gptj_serving,
                 "paged_ctx1024": gptj_long,
                 "paged_by_partitions": gptj_by_partitions,
                 "flash_tldr_shape": flash_gptj,
                 "paged_int8_serving": gptj_int8_serving},
        "serve_tiers": tiers, "spec_draft": durable["spec_draft"],
        "serve_lifecycle": {k: v for k, v in lifecycle.items()
                            if k != "tracing"} | {
            "tracing": {k: v for k, v in lifecycle["tracing"].items()
                        if k != "trace"}},
        "paged_int8_serving": int8_serving,
        "serve_mesh": serve_mesh, "paged_shards": shard_times,
        "fleet": fleet, "native": {**durable["native"],
                                   "calls": dict(native.CALLS)},
    }}))
    resume, gate = (durable["durability"][k]["launches"]
                    for k in ("resume", "gate"))
    kernels = [kernel_entry(
        "paged_decode", "trlx_tpu_torch/csrc/paged_decode.cu",
        "trlx_tpu/ops/paged_attention.py:58",
        run["launches"] + serve_ckpt["launches"] + lifecycle["launches"]
        + serve_mesh["launches"] + fleet["launches"],
        err, serving,
        {"serve": run["launches"],
         "serve_checkpoint": serve_ckpt["launches"],
         "serve_lifecycle": lifecycle["launches"],
         "serve_mesh": serve_mesh["launches"],
         "fleet": fleet["launches"],
         "ppo": train["all_launches"]["paged_decode"],
         "ilql": ilql["all_launches"]["paged_decode"]})]
    mesh = durable["mesh"]["launches"]
    one = durable["mesh"]["sp_pp_one"]["launches"]
    for name in FLASH_NAMES:
        kernels.append(kernel_entry(
            name, FLASH_SOURCES[name], FLASH_REPLACES[name],
            train["launches"][name] + ilql["launches"][name] + mesh[name]
            + sp["launches"][name] + pp["launches"][name] + one[name],
            flash_err[name], flash_slice[name],
            {"ppo": train["launches"][name], "ilql": ilql["launches"][name],
             "ppo_resume": resume[name], "ppo_gate": gate[name],
             "mesh": mesh[name], "sp": sp["launches"][name],
             "pp": pp["launches"][name], "sp_pp_world_of_one": one[name]}))
    kernels.append(kernel_entry(
        "paged_decode (hd 256)", "trlx_tpu_torch/csrc/paged_decode.cu",
        "trlx_tpu/ops/paged_attention.py:58", gptj["serve"]["launches"],
        gptj_paged_err, gptj_serving,
        {"gptj_serve": gptj["serve"]["launches"]}))
    kernels.append(kernel_entry(
        "paged_decode (bf16 q, int8 pool)",
        "trlx_tpu_torch/csrc/paged_decode.cu",
        "trlx_tpu/ops/paged_attention.py:58",
        tiers["int8_bfloat16"]["launches"], int8_err[64], int8_serving,
        {"serve_int8_bf16": tiers["int8_bfloat16"]["launches"]}))
    kernels.append(kernel_entry(
        "paged_decode (bf16 q, int8 pool, hd 256)",
        "trlx_tpu_torch/csrc/paged_decode.cu",
        "trlx_tpu/ops/paged_attention.py:58",
        gptj["serve"]["int8"]["launches"], int8_err[256], gptj_int8_serving,
        {"gptj_serve_int8": gptj["serve"]["int8"]["launches"]}))
    worlds = serve_mesh["worlds"]
    kernels.append(kernel_entry(
        "paged_decode (tp shards)", "trlx_tpu_torch/csrc/paged_decode.cu",
        "trlx_tpu/ops/paged_attention.py:58",
        sum(w["launches"] for w in worlds.values()), shard_err,
        shard_times["H6_hd64"],
        {f"serve_mesh_tp{n}": w["launches"] for n, w in worlds.items()}))
    for name in FLASH_NAMES:
        kernels.append(kernel_entry(
            f"{name} (hd 256)", FLASH_SOURCES[name],
            FLASH_REPLACES[name], gptj["flash"]["launches"][name],
            gptj_flash_err[name], flash_gptj[name],
            {"gptj_tldr": gptj["flash"]["launches"][name]}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
