"""An architecture added as one file, ``arch/<name>.py``, found by name
by the harness that exists: its seeded checkpoint, the reference trunk,
the FLOP helpers and serving's paged geometry run through it, and no
file of the benchmark is edited.

The toy has what GPT-2 and GPT-J lack: grouped-query attention (H 4,
Hkv 2, hd 6, so H x hd is not d_model) with an RMSNorm on q and k, a
layer with no attention (a gated short convolution that zeroes padded
inputs through the row mask, as Hugging Face's
``apply_mask_to_padding_states`` does), SwiGLU, and a layer of routed
experts (top 2 of 4 by a sigmoid with an expert bias).
"""

import os
import shutil
from types import SimpleNamespace

import torch

from perfbench import harness, weights, yardstick
from perfbench.reference import gpt
from perfbench.reference import ppo as ref_ppo
from perfbench.reference.leaves import leaf_norms

TOY_ARCH = '''"""A toy architecture for the harness's tests."""

import torch
import torch.nn.functional as F

from perfbench.reference.gpt import attend, rotary


def attends(cfg, i):
    return cfg["layer_types"][i] == "full_attention"


def routed(cfg, i):
    return i >= cfg["num_dense_layers"]


def layer_prefix(cfg, i):
    return f"model.layers.{i}."


def final_prefixes(cfg):
    return ("model.embedding_norm.",)


def matrices(cfg):
    d, V = cfg["d_model"], cfg["vocab_size"]
    H, Hkv, hd = cfg["n_head"], cfg["n_kv_head"], cfg["head_dim"]
    E, fe, f = cfg["n_experts"], cfg["d_expert"], cfg["d_ff"]
    out = [("model.embed_tokens.weight", (V, d), False)]
    for i in range(cfg["n_layer"]):
        n = layer_prefix(cfg, i)
        if attends(cfg, i):
            out += [(n + "self_attn.q_proj.weight", (H * hd, d), False),
                    (n + "self_attn.k_proj.weight", (Hkv * hd, d), False),
                    (n + "self_attn.v_proj.weight", (Hkv * hd, d), False),
                    (n + "self_attn.out_proj.weight", (d, H * hd), True)]
        else:
            out += [(n + "conv.in_proj.weight", (3 * d, d), False),
                    (n + "conv.conv.weight", (d, 1, cfg["conv_L_cache"]),
                     False),
                    (n + "conv.out_proj.weight", (d, d), True)]
        if routed(cfg, i):
            out += [(n + "feed_forward.gate.weight", (E, d), False),
                    (n + "feed_forward.experts.w1", (E, fe, d), False),
                    (n + "feed_forward.experts.w3", (E, fe, d), False),
                    (n + "feed_forward.experts.w2", (E, d, fe), True)]
        else:
            out += [(n + "feed_forward.w1.weight", (f, d), False),
                    (n + "feed_forward.w3.weight", (f, d), False),
                    (n + "feed_forward.w2.weight", (d, f), True)]
    return out


def vectors(cfg):
    d, hd = cfg["d_model"], cfg["head_dim"]
    out = [("model.embedding_norm.weight", d, 1.0)]
    for i in range(cfg["n_layer"]):
        n = layer_prefix(cfg, i)
        out += [(n + "operator_norm.weight", d, 1.0),
                (n + "ffn_norm.weight", d, 1.0)]
        if attends(cfg, i):
            out += [(n + "self_attn.q_layernorm.weight", hd, 1.0),
                    (n + "self_attn.k_layernorm.weight", hd, 1.0)]
        if routed(cfg, i):
            out.append((n + "feed_forward.expert_bias", cfg["n_experts"],
                        0.0))
    return out


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def swiglu(x, w1, w3, w2, prec):
    return prec.linear(F.silu(prec.linear(x, w1)) * prec.linear(x, w3), w2)


def embed(get, cfg, tokens, positions):
    V = cfg["vocab_size"]
    return get("model.embed_tokens.weight")[
        tokens.long().clamp(0, V - 1)].float()


def block(get, cfg, i, h, bias, positions, prec, mask):
    B, T, d = h.shape
    H, Hkv, hd = cfg["n_head"], cfg["n_kv_head"], cfg["head_dim"]
    eps = cfg["norm_eps"]
    n = layer_prefix(cfg, i)
    x = rms_norm(h, get(n + "operator_norm.weight"), eps)
    if attends(cfg, i):
        a = n + "self_attn."
        q = prec.linear(x, get(a + "q_proj.weight")).reshape(B, T, H, hd)
        k = prec.linear(x, get(a + "k_proj.weight")).reshape(B, T, Hkv, hd)
        v = prec.linear(x, get(a + "v_proj.weight")).reshape(B, T, Hkv, hd)
        q = rotary(rms_norm(q, get(a + "q_layernorm.weight"), eps),
                   positions, hd)
        k = rotary(rms_norm(k, get(a + "k_layernorm.weight"), eps),
                   positions, hd)
        k, v = (t.repeat_interleave(H // Hkv, dim=2) for t in (k, v))
        o = attend(q, k, v, bias, prec).reshape(B, T, H * hd)
        h = h + prec.linear(o, get(a + "out_proj.weight"))
    else:
        c = n + "conv."
        x = x * mask[..., None].float()  # padded inputs zeroed
        gate, out_gate, u = prec.linear(
            x, get(c + "in_proj.weight")).chunk(3, dim=-1)
        u = gate * u
        K = cfg["conv_L_cache"]
        y = F.conv1d(u.transpose(1, 2), get(c + "conv.weight").float(),
                     groups=d, padding=K - 1)[..., :T].transpose(1, 2)
        h = h + prec.linear(out_gate * y, get(c + "out_proj.weight"))
    x = rms_norm(h, get(n + "ffn_norm.weight"), eps)
    f = n + "feed_forward."
    if not routed(cfg, i):
        return h + swiglu(x, get(f + "w1.weight"), get(f + "w3.weight"),
                          get(f + "w2.weight"), prec)
    scores = torch.sigmoid(prec.linear(x, get(f + "gate.weight")))
    top = (scores + get(f + "expert_bias").float()).topk(
        cfg["experts_per_token"], dim=-1).indices
    weight = scores.gather(-1, top)
    weight = weight / weight.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(cfg["n_experts"]):
        share = (weight * (top == e)).sum(-1, keepdim=True)
        out = out + share * swiglu(x, get(f + "experts.w1")[e],
                                   get(f + "experts.w3")[e],
                                   get(f + "experts.w2")[e], prec)
    return h + out


def final_norm(get, cfg, h):
    return rms_norm(h, get("model.embedding_norm.weight"), cfg["norm_eps"])


def lm_logits(get, cfg, hn, prec):
    return prec.linear(hn, get("model.embed_tokens.weight"))


def _third(k):
    return lambda t: t.chunk(3, dim=0)[k]


_L = r"model\\.layers\\.\\d+\\."
LEAVES = [
    (r"model\\.embed_tokens\\.weight", [("embed.wte", None)]),
    (r"model\\.embedding_norm\\.weight", [("ln_f.scale", None)]),
    (_L + r"operator_norm\\.weight", [("blocks.operator_norm", None)]),
    (_L + r"ffn_norm\\.weight", [("blocks.ffn_norm", None)]),
    (_L + r"self_attn\\.(q|k|v|out)_proj\\.weight", [("attn.w", None)]),
    (_L + r"self_attn\\.(q|k)_layernorm\\.weight", [("attn.qk_norm", None)]),
    (_L + r"conv\\.in_proj\\.weight",
     [("conv.w_b", _third(0)), ("conv.w_c", _third(1)),
      ("conv.w_x", _third(2))]),
    (_L + r"conv\\.(conv|out_proj)\\.weight", [("conv.w", None)]),
    (_L + r"feed_forward\\.w\\d\\.weight", [("mlp.w", None)]),
    (_L + r"feed_forward\\.(gate\\.weight|expert_bias)",
     [("moe.router", None)]),
    (_L + r"feed_forward\\.experts\\.w\\d", [("moe.experts", None)]),
]


def layer_flops_per_token(cfg, i):
    d, H, Hkv, hd = (cfg[k] for k in ("d_model", "n_head", "n_kv_head",
                                      "head_dim"))
    if attends(cfg, i):
        mix = 2 * (2 * d * H * hd + 2 * d * Hkv * hd)
    else:
        mix = 2 * (3 * d * d + d * d) + 2 * d * cfg["conv_L_cache"]
    if routed(cfg, i):
        ffn = 2 * d * cfg["n_experts"] \\
            + cfg["experts_per_token"] * 2 * 3 * d * cfg["d_expert"]
    else:
        ffn = 2 * 3 * d * cfg["d_ff"]
    return mix + ffn


def attention_width(cfg, i):
    return cfg["n_head"] * cfg["head_dim"] if attends(cfg, i) else 0


def kv_heads(cfg):
    return cfg["n_kv_head"]
'''

TOY = {"arch": "toy", "vocab_size": 64, "n_layer": 3,
       "layer_types": ["full_attention", "conv", "full_attention"],
       "n_head": 4, "n_kv_head": 2, "head_dim": 6, "d_model": 32,
       "d_ff": 48, "num_dense_layers": 2, "n_experts": 4,
       "experts_per_token": 2, "d_expert": 16, "conv_L_cache": 3,
       "norm_eps": 1e-5}


def files_of(root):
    out = {}
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_an_architecture_added_as_a_file_only(tmp_path, monkeypatch):
    copy = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = files_of(copy)
    (copy / "arch" / "toy.py").write_text(TOY_ARCH)
    monkeypatch.setattr(harness, "HERE", str(copy))
    model = harness.arch(TOY)
    assert model.__file__ == str(copy / "arch" / "toy.py")

    # the seeded checkpoint: shapes of any rank, the same bytes again
    sd = weights.state_dict(TOY, 3000000019, "cpu", torch.float32)
    assert sd["model.layers.1.conv.conv.weight"].shape == (32, 1, 3)
    assert sd["model.layers.2.feed_forward.experts.w2"].shape == (4, 32, 16)
    assert sd["model.layers.0.self_attn.k_proj.weight"].shape == (12, 32)
    assert set(sd) == {n for n, *_ in model.matrices(TOY)} | {
        n for n, *_ in model.vectors(TOY)}
    again = weights.state_dict(TOY, 3000000019, "cpu", torch.float32)
    assert all(torch.equal(sd[n], again[n]) for n in sd)

    # the reference trunk, left-padded: the real tokens' outputs do not
    # depend on what the padding holds
    get = sd.__getitem__
    prec = gpt.Precision("float32")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 64, (2, 7), generator=g)
    mask = torch.ones(2, 7, dtype=torch.long)
    mask[1, :3] = 0
    h = gpt.trunk(get, TOY, tokens, mask, prec)
    logits = model.lm_logits(get, TOY, model.final_norm(get, TOY, h), prec)
    assert logits.shape == (2, 7, 64) and torch.isfinite(logits).all()
    other = tokens.clone()
    other[1, :3] = (other[1, :3] + 5) % 64
    h2 = gpt.trunk(get, TOY, other, mask, prec)
    assert torch.equal(h2[mask > 0], h[mask > 0])
    # ... because the convolution reads the row mask: without it the
    # padding leaks into the first real tokens
    x = model.embed(get, TOY, tokens, gpt.positions_of(mask))
    bias = gpt.causal_bias(mask)
    pos = gpt.positions_of(mask)
    masked = model.block(get, TOY, 1, x, bias, pos, prec, mask)
    unmasked = model.block(get, TOY, 1, x, bias, pos, prec,
                           torch.ones_like(mask))
    assert not torch.equal(masked[1, 3:], unmasked[1, 3:])
    assert torch.equal(masked[0], unmasked[0])

    # names and leaves through the module
    assert ref_ppo.top_prefixes(TOY, 1) == ("model.layers.2.",
                                            "model.embedding_norm.")
    assert set(ref_ppo.layer_weights(sd, TOY, 1)) == {
        n for n in sd if n.startswith("model.layers.1.")}
    assert set(leaf_norms(sd, TOY)) == {
        "embed.wte", "ln_f.scale", "blocks.operator_norm",
        "blocks.ffn_norm", "attn.w", "attn.qk_norm", "conv.w_b",
        "conv.w_c", "conv.w_x", "conv.w", "mlp.w", "moe.router",
        "moe.experts"}

    # FLOPs against a hand count (d 32, H 4, Hkv 2, hd 6, f 48, 4
    # experts of 16, top 2, a kernel of 3)
    attn = 2 * (2 * 32 * 24 + 2 * 32 * 12)  # q and o 24 wide, k and v 12
    conv = 2 * (3 * 32 * 32 + 32 * 32) + 2 * 32 * 3  # in, out, the kernel
    dense = 2 * 3 * 32 * 48
    moe = 2 * 32 * 4 + 2 * (2 * 3 * 32 * 16)  # the router, 2 experts
    per_token = (attn + dense) + (conv + dense) + (attn + moe)
    width = 24 + 0 + 24  # layer 1 does not attend
    n = 5
    assert yardstick.forward_flops(TOY, range(3), [n]) == \
        per_token * n + 4 * width * (n * (n + 1) // 2)
    assert yardstick.forward_flops(TOY, range(2, 3), [n]) == \
        (attn + moe) * n + 4 * 24 * (n * (n + 1) // 2)
    lm = 2 * 32 * 64
    assert yardstick.decode_flops(TOY, range(3), n, 1) == \
        per_token + 4 * width * (n + 1) + lm
    assert yardstick.prefill_flops(TOY, range(3), 4 + n, cached=4) == \
        per_token * n + 4 * width * (4 * n + n * (n + 1) // 2) + lm

    # PPO's cycle trains the top layer by index (2: attention and
    # experts), not the first: one row of 3 + 2 tokens, one epoch
    store = SimpleNamespace(query_masks=torch.tensor([[0, 1, 1, 1]]),
                            response_masks=torch.tensor([[1, 1]]))
    ppo = harness.load_module("drivers", "ppo").make(SimpleNamespace(
        spec=TOY))
    ppo.trainer = SimpleNamespace(
        store=SimpleNamespace(_stacked=lambda: store),
        policy=SimpleNamespace(k=1),
        config=SimpleNamespace(method=SimpleNamespace(ppo_epochs=1)))
    every = per_token * n + 4 * width * (n * (n + 1) // 2)
    top = (attn + moe) * n + 4 * 24 * (n * (n + 1) // 2)
    vh = yardstick.head_flops(32, 1)
    assert ppo.cycle_flops() == \
        yardstick.prefill_flops(TOY, range(3), 3) \
        + yardstick.decode_flops(TOY, range(3), 3, 1) \
        + every + top + 2 * (2 * lm + vh) + every + vh \
        + 3 * (top + 2 * (lm + vh))

    # serving's paged geometry: Hkv 2, hd 6, a call on each of 2 layers
    serve = harness.load_module("drivers", "serve_open_loop")
    assert serve.paged_geometry(TOY, 8, 16, 12) == (8, 4, 2, 6, 16, 12, 2)

    # nothing that was there was edited
    after = files_of(copy)
    del after[os.path.join("arch", "toy.py")]
    assert after == before
