"""GPT-2 and GPT-J held to the harness as it was before each architecture
became a module of its own (``perfbench/arch/``): the same checkpoint
bytes, FLOP counts, reference outputs and program leaves.

``parent_readings.json`` holds what the earlier harness gave on these
very inputs, recorded once on the CPU: integers and floats as they were,
each tensor as the SHA-256 of its bytes (equal digests are bitwise-equal
tensors, which ``torch.equal`` would pass). Widths are ``tiny``'s, and
the FLOP counts are also taken at the published ``gptj-6b`` and
``gpt2-124m`` sizes: one PPO cycle of 64 rollouts of up to 512 + 64
tokens, one ILQL update of 80 rows and a traced part of serving.
"""

import functools
import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import harness, weights, yardstick
from perfbench.reference import gpt, leaves
from perfbench.reference import ilql as ref_ilql
from perfbench.reference import ppo as ref_ppo
from perfbench.reference import serve as ref_serve
from perfbench.tests import tiny

with open(os.path.join(os.path.dirname(__file__),
                       "parent_readings.json")) as _f:
    PARENT = json.load(_f)

SPECS = {"gptj-6b": harness.load_json("configs", "gptj-6b.json")["spec"],
         "gpt2-124m": harness.load_json("configs", "gpt2-124m.json")["spec"],
         "tiny.GPT2": tiny.GPT2, "tiny.GPTJ": tiny.GPTJ,
         "tiny.SERVE": tiny.SERVE}
TINY = ("tiny.GPT2", "tiny.GPTJ", "tiny.SERVE")


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(
        t.detach().contiguous().view(torch.uint8).numpy().tobytes()
    ).hexdigest()


def layout_digest(spec) -> str:
    model = harness.arch(spec)
    mats = [[n, list(s), r] for n, s, r in model.matrices(spec)]
    vecs = [list(v) for v in model.vectors(spec)]
    return hashlib.sha256(json.dumps([mats, vecs]).encode()).hexdigest()


def state_dict_digest(sd) -> str:
    h = hashlib.sha256()
    for name, t in sd.items():
        h.update(name.encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# -- FLOPs: the helpers and the drivers' counts ---------------------------- #


def ppo_cycle_flops(spec) -> int:
    """``PPO.cycle_flops`` over a store of 64 rows of 171-512 prompt and
    1-64 response tokens, 2 layers trained, 4 epochs."""
    rng = np.random.default_rng(7)
    n, P, G = 64, 512, 64
    plen, glen = rng.integers(P // 3, P + 1, n), rng.integers(1, G + 1, n)
    q = torch.zeros(n, P, dtype=torch.int32)
    r = torch.zeros(n, G, dtype=torch.int32)
    for i in range(n):
        q[i, P - plen[i]:] = 1
        r[i, :glen[i]] = 1
    store = SimpleNamespace(query_masks=q, response_masks=r)
    driver = harness.load_module("drivers", "ppo").make(
        SimpleNamespace(spec=spec))
    driver.trainer = SimpleNamespace(
        store=SimpleNamespace(_stacked=lambda: store),
        policy=SimpleNamespace(k=2),
        config=SimpleNamespace(method=SimpleNamespace(ppo_epochs=4)))
    return driver.cycle_flops()


def ilql_update_flops(spec) -> int:
    """``ILQL.update_flops`` of 80 rows of 32-512 tokens."""
    driver = harness.load_module("drivers", "ilql").make(
        SimpleNamespace(spec=spec))
    driver.lengths = np.random.default_rng(11).integers(32, 513, 3200)
    return driver.update_flops(
        np.random.default_rng(12).permutation(3200)[:80])


def serve_readings(spec):
    """``Serve.readings`` of 24 requests on 64 slots of pages of 16, with
    prefix hits, over a traced part that cuts some requests' tokens."""
    rng = np.random.default_rng(13)
    driver = harness.load_module("drivers", "serve_open_loop").make(
        SimpleNamespace(spec=spec))
    driver.engine = SimpleNamespace(serve=SimpleNamespace(page_size=16))
    driver.sched = SimpleNamespace(runtime=SimpleNamespace(num_slots=64,
                                                           max_pages=104))
    driver.sent = []
    for _ in range(24):
        plen = int(rng.integers(20, 200))
        hit = int(rng.integers(0, plen // 16))
        n_out = int(rng.integers(1, 30))
        start = round(float(rng.uniform(0, 10)), 1)
        trace = SimpleNamespace(
            admitted=start, enqueued=start - 0.1, prefix_blocks_hit=hit,
            steps=[round(start + 0.1 * j, 1) for j in range(n_out)],
            prefill_start=start, suffix_len=plen - hit * 16)
        driver.sent.append((list(range(plen)), trace, SimpleNamespace()))
    out = driver.readings(list(range(24)), (0.0, 1.0, 3.0, 9.0))
    return {"traced_flops": out["traced_flops"],
            "paged_geometry": list(out["paged_geometry"]),
            "paged_steps": sorted(sorted(s) for s in out["paged_steps"]),
            "prefix_saved": out["prefix_saved"]}


def flops(spec):
    d, V, L = spec["d_model"], spec["vocab_size"], spec["n_layer"]
    every, top2 = range(L), range(L - 2, L)
    return {
        "forward_all": yardstick.forward_flops(spec, every, [1, 17, 300, 576]),
        "forward_top2": yardstick.forward_flops(spec, top2, [576, 389]),
        "decode_400_64": yardstick.decode_flops(spec, every, 400, 64),
        "decode_1_1": yardstick.decode_flops(spec, every, 1, 1),
        "prefill_640": yardstick.prefill_flops(spec, every, 640),
        "prefill_640_hit_384": yardstick.prefill_flops(spec, every, 640, 384),
        "prefill_17_hit_16": yardstick.prefill_flops(spec, every, 17, 16),
        "lm_head": yardstick.lm_head_flops(spec),
        "head_d_1": yardstick.head_flops(d, 1),
        "head_d_V": yardstick.head_flops(d, V),
        "ppo_cycle": ppo_cycle_flops(spec),
        "ilql_update": ilql_update_flops(spec),
        "serve": serve_readings(spec),
    }


# -- the reference's outputs ---------------------------------------------- #


def left_padded(spec, B, T, pads, seed):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, spec["vocab_size"], (B, T), generator=g)
    mask = torch.ones(B, T, dtype=torch.long)
    for b, p in enumerate(pads):
        mask[b, :p] = 0
        tokens[b, :p] = 0
    return tokens, mask


def trunk_outputs(outs):
    """Logits of the trunk over two rows of 8, one left-padded by 3; the
    float8 control too at gpt-j."""
    for name in TINY:
        spec = SPECS[name]
        sd = weights.state_dict(spec, 2024, "cpu", torch.float32)
        get, model = sd.__getitem__, harness.arch(spec)
        tokens, mask = left_padded(spec, 2, 8, [0, 3], 5)
        precs = ("float32", "float8") if name == "tiny.GPTJ" else \
            ("float32",)
        for p in precs:
            prec = gpt.Precision(p)
            with gpt.exact_float32():
                h = gpt.trunk(get, spec, tokens, mask, prec)
                outs[f"trunk.{name}.{p}"] = model.lm_logits(
                    get, spec, model.final_norm(get, spec, h), prec)


def ppo_outputs(outs, rec):
    """PPO's rollout of 6 rows (two ending early in eos) and three
    updates on 4 of them, 2 layers trained, at gpt-j."""
    spec = SPECS["tiny.GPTJ"]
    prec = gpt.Precision("float32")
    sd = weights.state_dict(spec, 77, "cpu", torch.float32)
    query, qmask = left_padded(spec, 6, 10, [0, 2, 4, 1, 0, 3], 8)
    g = torch.Generator().manual_seed(9)
    response = torch.randint(3, spec["vocab_size"], (6, 6), generator=g)
    eos = 1
    response[1, 3] = eos
    response[4, 0] = eos
    d = spec["d_model"]
    v_head = gpt.init_head(np.random.default_rng(77), d, 1, "cpu")
    r_head = gpt.init_head(np.random.default_rng(78), d, 1, "cpu")
    ro = ref_ppo.rollout(sd, spec, query, qmask, response, v_head, r_head,
                         eos, 2, prec, rows_per_block=4)
    for k, v in ro.items():
        outs[f"ppo.rollout.{k}"] = v
    idx = torch.as_tensor([4, 0, 5, 2])
    batch = {"query": query[idx], "qmask": qmask[idx],
             "response": response[idx], "h_split": ro["h_split"][idx],
             **{k: ro[k][idx] for k in ("logprobs", "values", "rewards",
                                        "gen_mask")}}
    method = {"gamma": 1.0, "lam": 0.95, "cliprange": 0.2,
              "cliprange_value": 0.2, "vf_coef": 0.2}
    train = {"grad_clip": 1.0, "weight_decay": 1e-6,
             "learning_rate_init": 1e-4}
    top = ref_ppo.top_prefixes(spec, 2)
    sd_top = {n: w for n, w in sd.items() if n.startswith(top)}
    up = ref_ppo.updates(sd_top, spec, v_head, batch, method, train, 2, 3,
                         prec, rows_per_block=2)
    outs["ppo.update.losses"] = torch.tensor(up["losses"],
                                             dtype=torch.float64)
    for n, t in up["grad_tensors"].items():
        outs[f"ppo.update.grad.{n}"] = t
    for n, t in up["change"].items():
        outs[f"ppo.update.change.{n}"] = t
    rec["ppo_leaves"] = {"grad": leaves.leaf_norms(up["grad_tensors"], spec),
                         "change": leaves.leaf_norms(up["change"], spec)}
    rec["ppo_top_keys"] = sorted(sd_top)
    rec["ppo_params"] = sorted(ref_ppo.top_params(sd, spec, v_head, 2))
    rec["ppo_layer_weights"] = sorted(ref_ppo.layer_weights(sd, spec, 1))


def ilql_outputs(outs, rec):
    """ILQL's first three updates on 4 rows each of 8 rows of 6-16
    tokens, at gpt2."""
    spec = SPECS["tiny.GPT2"]
    sd = weights.state_dict(spec, 55, "cpu", torch.float32)
    rng = np.random.default_rng(55)
    d, V = spec["d_model"], spec["vocab_size"]
    heads = {"q1_head": gpt.init_head(rng, d, V, "cpu"),
             "v_head": gpt.init_head(rng, d, 1, "cpu"),
             "q2_head": gpt.init_head(rng, d, V, "cpu")}
    rows = [np.random.default_rng(100 + i).integers(0, V, n)
            for i, n in enumerate([7, 12, 9, 16, 6, 11, 14, 8])]
    scores = np.random.default_rng(3).standard_normal(len(rows)).astype(
        np.float32)
    method = {"gamma": 0.99, "tau": 0.7, "cql_scale": 0.1,
              "awac_scale": 1.0}
    train = {"grad_clip": 1.0, "weight_decay": 1e-6, "lr_ramp_steps": 10,
             "learning_rate_init": 1e-4}
    out = ref_ilql.updates(sd, heads, spec, rows, scores,
                           [[0, 3, 5, 1], [2, 7, 4, 6], [1, 6, 0, 3]], 16,
                           V - 1, method, train, "cpu",
                           gpt.Precision("float32"), rows_per_block=3)
    outs["ilql.losses"] = torch.tensor(out["losses"], dtype=torch.float64)
    for n, t in out["grad_tensors"].items():
        outs[f"ilql.grad.{n}"] = t
    for n, t in out["change"].items():
        outs[f"ilql.change.{n}"] = t
    rec["ilql_leaves"] = {"grad": leaves.leaf_norms(out["grad_tensors"],
                                                    spec),
                          "change": leaves.leaf_norms(out["change"], spec)}


def serve_outputs(outs, rec):
    """Six greedy tokens after each of two prompts, and the logits that
    predict them, at serving's width."""
    spec = SPECS["tiny.SERVE"]
    prec = gpt.Precision("float32")
    sd = weights.state_dict(spec, 66, "cpu", torch.float32)
    prompts = [list(range(5, 17)), [40, 41, 42, 3, 9, 250, 251]]
    served = [[], []]
    for _ in range(6):
        logits = ref_serve.logits(sd, spec, [(p, s + [0]) for p, s in
                                             zip(prompts, served)],
                                  prec, "cpu")
        for s, x in zip(served, logits):
            s.append(int(x[-1].argmax()))
    logits = ref_serve.logits(sd, spec, list(zip(prompts, served)), prec,
                              "cpu")
    for i, x in enumerate(logits):
        outs[f"serve.logits.{i}"] = x
    rec["serve_tokens"] = served


@functools.cache
def current():
    """The same readings from the harness as it is (one thread, as they
    were recorded)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = {"layout": {n: layout_digest(s) for n, s in SPECS.items()},
               "state_dict": {}}
        for name in TINY:
            for dtype in ("float32", "bfloat16"):
                for seed in (12345, 3000000019):
                    sd = weights.state_dict(SPECS[name], seed, "cpu",
                                            getattr(torch, dtype))
                    rec["state_dict"][f"{name}.{dtype}.{seed}"] = \
                        state_dict_digest(sd)
        rec["flops"] = {n: flops(s) for n, s in SPECS.items()}
        outs = {}
        trunk_outputs(outs)
        ppo_outputs(outs, rec)
        ilql_outputs(outs, rec)
        serve_outputs(outs, rec)
    finally:
        torch.set_num_threads(threads)
    rec["outputs"] = {k: [list(v.shape), str(v.dtype), digest(v)]
                      for k, v in outs.items()}
    rec["losses"] = {k: v.tolist() for k, v in outs.items()
                     if k.endswith("losses")}
    return json.loads(json.dumps(rec))


#: (section, prefix of its keys) of each case
CASES = [("layout", n) for n in SPECS] \
    + [("state_dict", n) for n in TINY] \
    + [("flops", n) for n in SPECS] \
    + [("outputs", p) for p in ("trunk.", "ppo.rollout.", "ppo.update.",
                                "ilql.", "serve.")] \
    + [(s, "") for s in ("losses", "ppo_leaves", "ilql_leaves",
                         "ppo_top_keys", "ppo_params", "ppo_layer_weights",
                         "serve_tokens")]


def test_every_recorded_reading_has_a_case():
    assert {s for s, _ in CASES} == set(PARENT)
    for section, value in PARENT.items():
        if isinstance(value, dict):
            prefixes = [p for s, p in CASES if s == section]
            assert all(any(k.startswith(p) for p in prefixes)
                       for k in value), section


@pytest.mark.parametrize("section,prefix", CASES)
def test_equal_to_the_parent(section, prefix):
    ours, theirs = current()[section], PARENT[section]
    if not isinstance(theirs, dict):
        assert ours == theirs
        return
    assert set(ours) == set(theirs)
    keys = [k for k in theirs if k.startswith(prefix)]
    assert keys
    differ = [k for k in keys if ours[k] != theirs[k]]
    assert not differ, differ
