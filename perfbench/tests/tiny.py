"""Tiny versions of the cells for CPU tests: the cells' own files with
the widths, sizes and traffic cut so that a run takes seconds on the
CPU (the harness's ``overrides``)."""

import io
import json

from perfbench import harness

GPTJ = {"arch": "gptj", "vocab_size": 300, "n_layer": 3, "n_head": 2,
        "d_model": 32, "d_ff": 64, "n_positions": 128, "rotary_dim": 8,
        "layer_norm_epsilon": 1e-5, "tie_lm_head": False}
#: serving's tiny width: at d_model 32 the float8 control's widest gap
#: stayed under the cell's limit; at 64 it does not
SERVE = dict(GPTJ, d_model=64, n_head=4, d_ff=256)
GPT2 = {"arch": "gpt2", "vocab_size": 300, "n_layer": 2, "n_head": 2,
        "d_model": 32, "d_ff": 128, "n_positions": 64,
        "layer_norm_epsilon": 1e-5, "tie_lm_head": True}

#: every limit a tiny float32 run on the CPU holds (both sides float32:
#: the gaps are rounding, ~1e-6; a logit itself, some units, differs by
#: ~1e-4)
TIGHT = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3,
         "mask_gap": 0.0, "logprob_gap": 1e-4, "value_gap": 1e-4,
         "reward_gap": 1e-4, "logit_gap": 1e-4, "logit_diff": 1e-3}

OVERRIDES = {
    "ilql-gpt2-imdb": {
        "spec": GPT2, "rows": 24, "warm_updates": 4, "trace_updates": [1, 2],
        "traffic_params": {"lengths": {"dist": "lognormal", "median": 20,
                                       "sigma": 0.5, "min": 6, "max": 40}},
        "trainer": {"model": {"model_path": "from-config",
                              "tokenizer_path": "byte",
                              "compute_dtype": "float32",
                              "fused_attention": True},
                    "train": {"batch_size": 4, "checkpoint_interval": 10**9,
                              "eval_interval": 10**9,
                              "log_interval": 10**9}}},
    "ppo-gptj6b-tldr": {
        "spec": GPTJ, "prompts": 16, "trace_cycle": 0,
        "traffic_params": {"lengths": {"dist": "lognormal", "median": 18,
                                       "sigma": 0.3, "min": 10, "max": 24},
                           "cue_tokens": [10, 11, 12]},
        "trainer": {"model": {"model_path": "from-config",
                              "tokenizer_path": "byte",
                              "compute_dtype": "float32",
                              "param_dtype": "float32",
                              "fused_attention": True},
                    "train": {"batch_size": 4, "input_size": 24,
                              "gen_size": 8, "epochs": 10**6,
                              "total_steps": 10**9,
                              "checkpoint_interval": 10**9,
                              "eval_interval": 10**9,
                              "log_interval": 10**9},
                    "method": {"num_rollouts": 8, "chunk_size": 4,
                               "gen_kwargs": {"max_length": 8,
                                              "min_length": 4, "top_k": 0,
                                              "top_p": 1.0, "do_sample": True,
                                              "temperature": 0.7}}}},
    "serve-gptj6b-sessions": {
        "spec": SERVE, "rate": 20.0, "warm_seconds": 0.5, "tail_seconds": 0.5,
        "trace_at": [0.2, 0.3],
        "traffic_params": {
            "system_prompts": 4,
            "system_lengths": {"dist": "linear", "min": 16, "max": 32},
            "popularity": 1.1,
            "user_lengths": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                             "min": 4, "max": 32},
            "output_lengths": {"dist": "lognormal", "median": 8,
                               "sigma": 0.5, "min": 2, "max": 16}},
        "engine": {"buckets": [[1, 32, 16], [2, 32, 16], [1, 64, 16],
                               [2, 64, 16]],
                   "slots": 8, "page_size": 8, "pages": 64,
                   "attention": "pallas", "max_queue": 4096,
                   "request_timeout": 600.0},
        "trainer": {"model": {"model_path": "from-config",
                              "tokenizer_path": "byte",
                              "compute_dtype": "float32",
                              "param_dtype": "float32"},
                    "method": {"gen_kwargs": {"max_length": 16,
                                              "do_sample": False}}}},
}


def overrides(cell, limits=None):
    """The tiny overrides of ``cell`` with its limits (default: the cell's
    own limit names, each at :data:`TIGHT`)."""
    own = harness.load_json("workloads", f"{cell}.json")["limits"]
    return dict(OVERRIDES[cell],
                limits=limits or {k: TIGHT[k] for k in own})


def run(cell, seed=12345, trace=0, seconds=1.0, patch=None, limits=None,
        bench_path=None):
    """One tiny CPU run; (exit code, the result line parsed or None)."""
    out = io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)],
                     require_card=False, overrides=overrides(cell, limits),
                     bench_path=bench_path, out=out, patch=patch)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
