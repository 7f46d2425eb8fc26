"""Speculation proposal tiers for the slot engine (port of
trlx_tpu.serve.speculate).

The verification half of speculative decoding runs on the device
(:func:`trlx_tpu_torch.models.generation.verify_step`); this module is
the host half — WHERE the k candidate tokens come from. Two tiers, one
contract: given a slot's token history, return up to ``serve.spec_k``
continuation tokens, or nothing (the scheduler then runs a plain
``decode_step``, so a dry proposer costs exactly the unspeculated step).

Tier ``lookup`` (draft-free prompt lookup): an n-gram index over the
request's OWN prompt + committed history (:class:`NgramIndex` inside
:class:`SlotSpeculator`), backed by the radix cache's committed blocks
(``RadixCache.peek_continuation``) for prefixes shared across requests.
No model cost.

Tier ``draft`` (:class:`DraftProposer`): a second engine, restored
through ``InferenceEngine.from_checkpoint``, decoding k ahead for every
slot in one fixed-shape ``generate`` call replayed as one CUDA graph on
the card (trlx_tpu_torch.utils.aotjit), so proposals add nothing to
``compile/recompiles``.

Per-slot host state is bounded: the n-gram index LRU-evicts above
``serve.spec_index_max_keys`` match keys and the whole speculator is
dropped at harvest.
"""

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["NgramIndex", "SlotSpeculator", "DraftProposer"]


class NgramIndex:
    """Suffix-gram -> continuation-start index over one growing token
    history, LRU-bounded at ``max_keys`` match keys.

    For every position ``c`` in the history, the grams of length
    ``1..ngram_max`` ENDING just before ``c`` map to ``c`` (latest
    occurrence wins). Lookup tries the longest suffix gram of the
    current history first. The cursor ``_upto`` only indexes positions
    that HAVE a continuation token, so the history's own tail gram can
    never match itself.
    """

    __slots__ = ("ngram_max", "max_keys", "_grams", "_upto")

    def __init__(self, ngram_max: int = 3, max_keys: int = 512):
        if ngram_max < 1:
            raise ValueError(f"ngram_max={ngram_max} must be >= 1")
        if max_keys < 1:
            raise ValueError(f"max_keys={max_keys} must be >= 1")
        self.ngram_max = ngram_max
        self.max_keys = max_keys
        self._grams: "OrderedDict[Tuple[int, ...], int]" = OrderedDict()
        self._upto = 0  # history positions < _upto are indexed

    def __len__(self) -> int:
        return len(self._grams)

    def _put(self, gram: Tuple[int, ...], cont: int) -> None:
        if gram in self._grams:
            del self._grams[gram]  # re-insert at the LRU tail
        self._grams[gram] = cont
        while len(self._grams) > self.max_keys:
            self._grams.popitem(last=False)

    def extend(self, history: Sequence[int]) -> None:
        """Index the not-yet-indexed region of ``history`` (call after
        every append)."""
        for cont in range(max(self._upto, 1), len(history)):
            for n in range(1, self.ngram_max + 1):
                if cont - n < 0:
                    break
                self._put(tuple(history[cont - n:cont]), cont)
        self._upto = max(self._upto, len(history))

    def lookup(self, history: Sequence[int]) -> Optional[int]:
        """Continuation start for the longest indexed suffix gram of
        ``history``, LRU-touching the hit; ``None`` when dry."""
        for n in range(min(self.ngram_max, len(history)), 0, -1):
            gram = tuple(history[-n:])
            cont = self._grams.get(gram)
            if cont is not None:
                self._grams.move_to_end(gram)
                return cont
        return None


class SlotSpeculator:
    """Per-slot lookup-tier state: the request's token history (prompt +
    every committed emission) and its bounded n-gram index. Created at
    admission, fed at harvest, dropped at eviction."""

    __slots__ = ("history", "spec_k", "index")

    def __init__(self, prompt_tokens: Sequence[int], spec_k: int,
                 ngram_max: int = 3, max_keys: int = 512):
        self.history: List[int] = list(prompt_tokens)
        self.spec_k = spec_k
        self.index = NgramIndex(ngram_max, max_keys)
        self.index.extend(self.history)

    def append(self, tokens: Sequence[int]) -> None:
        """Commit freshly accepted tokens into history + index."""
        self.history.extend(int(t) for t in tokens)
        self.index.extend(self.history)

    def propose(self, cache=None) -> List[int]:
        """Up to ``spec_k`` continuation tokens: the own-history n-gram
        match first, then the radix cache's committed blocks (read-only
        ``peek_continuation``), else nothing."""
        cont = self.index.lookup(self.history)
        if cont is not None:
            prop = self.history[cont:cont + self.spec_k]
            if prop:
                return list(prop)
        if cache is not None:
            return list(cache.peek_continuation(self.history, self.spec_k))
        return []


class DraftProposer:
    """Draft-model proposal tier: an engine decoding ``spec_k`` ahead for
    every slot in one fixed-shape call.

    The draft decodes greedily from the last ``window`` tokens of each
    slot's history, left-padded into a fixed ``(batch, window)`` batch:
    one signature whichever slots are live. With eos off and a fixed
    length the whole ``generate`` (prefill and k steps) keeps the graph
    contract, so it runs behind one ``aot_jit``: one CUDA graph on the
    card. Rows without a live slot carry one pad token and are ignored.

    On a serve mesh the draft is sharded on the same mesh (its engine
    built from the serving engine's serve config); process 0 publishes
    each proposal batch on ``channel`` (the serving engine's host
    channel) and the followers run it on their shards (:meth:`run`).
    """

    def __init__(self, engine, spec_k: int, batch: int,
                 window: Optional[int] = None, channel=None):
        from trlx_tpu_torch.models.generation import (
            RolloutDecoder,
            _decode_token,
            generate,
        )
        from trlx_tpu_torch.ops.sampling import SamplingParams
        from trlx_tpu_torch.utils.aotjit import aot_jit

        self.engine = engine
        self.spec_k = int(spec_k)
        self.batch = int(batch)
        self.channel = channel
        n_pos = engine.spec.n_positions
        self.window = int(window) if window is not None \
            else max(1, min(32, n_pos - self.spec_k))
        if self.window + self.spec_k > n_pos:
            raise ValueError(
                f"draft window {self.window} + spec_k {self.spec_k} "
                f"exceeds draft n_positions {n_pos}"
            )
        cfg = engine.gen_config._replace(
            gen_size=self.spec_k,
            eos_token_id=-1,  # verification owns termination
            min_new_tokens=0,
            sampling=SamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                                    do_sample=False),
        )
        spec, compute, tp = engine.spec, engine.compute_dtype, engine.tp
        # the steps run inside this graph, not as graphs of their own
        decoder = RolloutDecoder()
        decoder.step = _decode_token

        def run(blocks, embed, ln_f, tokens, mask):
            return generate(spec, blocks, embed, ln_f, tokens, mask, None,
                            cfg, compute_dtype=compute,
                            decoder=decoder, tp=tp).gen_tokens

        self._run = aot_jit(run)

    @classmethod
    def from_checkpoint(cls, path: str, serve_engine, spec_k: int):
        """The draft restored through the port's
        ``InferenceEngine.from_checkpoint`` with the serving engine's
        serve config (itself not speculating), on its device; the
        draft's architecture and compute dtype are its own checkpoint's."""
        from trlx_tpu_torch.serve.engine import InferenceEngine

        serve = dataclasses.replace(serve_engine.serve, speculation="off",
                                    spec_draft_checkpoint=None)
        draft = InferenceEngine.from_checkpoint(
            path, serve=serve, device=str(serve_engine.device))
        return cls(draft, spec_k, serve_engine.slot_count(),
                   channel=serve_engine.channel)

    def graphs(self):
        """The draft's captured graph (capture seconds, pool bytes)."""
        return self._run.graphs()

    @torch.no_grad()
    def run(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """The draft's device call on one left-padded batch: [B, spec_k]
        tokens on the host (on a serve mesh, published to the followers
        first)."""
        if self.channel is not None and self.channel.leader:
            self.channel.send("draft", tokens, mask)
        e = self.engine
        return self._run(
            e.blocks, e.embed, e.ln_f,
            torch.as_tensor(tokens, device=e.device),
            torch.as_tensor(mask, device=e.device),
        ).cpu().numpy()

    @torch.no_grad()
    def propose(self, histories: Sequence[Optional[Sequence[int]]]
                ) -> List[List[int]]:
        """Draft continuations for each history (``None`` rows are dead
        slots): one device call, one k-token list per row (empty for
        dead rows)."""
        e = self.engine
        W = self.window
        tokens = np.zeros((self.batch, W), dtype=np.int32)
        mask = np.zeros((self.batch, W), dtype=np.int32)
        for i in range(self.batch):
            h = histories[i] if i < len(histories) else None
            if h:
                tail = [int(t) for t in h[-W:]]
                tokens[i, -len(tail):] = tail
                mask[i, -len(tail):] = 1
            else:
                tokens[i, -1] = 0
                mask[i, -1] = 1  # filler row: one real token
        gen = self.run(tokens, mask)
        out: List[List[int]] = []
        for i in range(self.batch):
            h = histories[i] if i < len(histories) else None
            out.append([int(t) for t in gen[i]] if h else [])
        return out
