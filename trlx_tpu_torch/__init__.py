"""trlx_tpu_torch: the PyTorch/CUDA port of trlx_tpu, slice by slice.

The package mirrors ``trlx_tpu``'s module layout and public names so a
reader finds each counterpart, but imports ``torch`` and never ``jax``
or anything of ``trlx_tpu`` (it keeps its own copies of what it needs).
Every Pallas kernel on a ported path is a hand-written Hopper kernel
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

Ported so far: the serving path — config, byte tokenizer, telemetry,
the functional transformer (dense, dense-with-cache and paged modes),
paged slot-pool prefill/decode, the paged-decode attention kernel, the
page allocator + radix prefix cache, the continuous-batching slot
scheduler, the inference engine, its HTTP server and CLI
(``python -m trlx_tpu_torch.serve``); and PPO training — the hydra
policy, the rollout decoder, the loss math, the pipeline, orchestrator
and trainer (``trlx_tpu_torch.utils.loading.get_model``), with the
flash-attention forward and backward kernels on train-time forwards
(``python -m trlx_tpu_torch.examples.ppo_sentiments``); and offline
ILQL training — the ILQL network with its Q / target-Q / value heads,
the chunked ILQL loss, the offline pipeline, orchestrator and trainer
with advantage-shifted sampling, on the same kernels
(``python -m trlx_tpu_torch.examples.ilql_randomwalks``); and durable
training — crash-atomic checkpoints, ``resume_from``, the commit gate
and SIGTERM preemption (``utils/checkpoint.py``, ``utils/faults.py``,
``utils/preemption.py``), the device reward model
(``models/reward.py``, ``python -m
trlx_tpu_torch.examples.ppo_tldr``) and serving a checkpoint
(``python -m trlx_tpu_torch.serve --checkpoint <run dir>``); decode as
CUDA graphs (``utils/aotjit.py``); and the run floor — telemetry
(``telemetry/``), the run supervisor with bounded host seams, walltime
and chaos drills (``supervisor/``), trackers and profiling
(``utils/trackers.py``, ``utils/profiling.py``).

Importing the package does nothing else: no CUDA initialisation, no
kernel build, no thread.
"""
