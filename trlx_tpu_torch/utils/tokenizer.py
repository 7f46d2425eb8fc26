"""Tokenizer loading and the dependency-free byte tokenizer.

Copy of trlx_tpu.utils.tokenizer: 64 or more texts go through the
threaded C++ tokenize-and-pad of :mod:`trlx_tpu_torch.native` when it is
available, with the same layout as the Python loop. ``transformers`` is
imported only when a tokenizer other than ``"byte"`` is asked for.
"""

import os
from typing import List, Optional


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: token i (0..255) is byte i; 256 is
    bos/eos/pad. Deterministic, reversible, needs no vocab files."""

    vocab_size = 257

    def __init__(self):
        self.eos_token_id = 256
        self.bos_token_id = 256
        self.pad_token_id = 256
        self.eos_token = "<|endoftext|>"
        self.padding_side = "left"

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        data = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in batch]

    def __call__(self, texts, max_length: Optional[int] = None,
                 padding="max_length", truncation=True, **kw):
        # padding/truncation accepted for HF-signature compatibility; this
        # tokenizer always left-pads/truncates to max_length.
        import numpy as np

        if isinstance(texts, str):
            texts = [texts]

        from trlx_tpu_torch import native

        if native.available() and len(texts) >= 64:
            # threaded C++ tokenize+pad (trlx_tpu_torch/csrc/hostdata.cpp)
            # for large prompt sets; identical layout to the loop below
            if max_length is None:
                max_length = max(len(t.encode("utf-8")) for t in texts)
            ids, mask = native.byte_tokenize_pad(
                texts, max_length, self.pad_token_id, pad_left=True
            )
            return {"input_ids": ids, "attention_mask": mask}

        enc = [self.encode(t) for t in texts]
        if max_length is None:
            max_length = max(len(e) for e in enc)
        ids = np.full((len(enc), max_length), self.pad_token_id, np.int32)
        mask = np.zeros((len(enc), max_length), np.int32)
        for i, e in enumerate(enc):
            e = e[:max_length]
            ids[i, max_length - len(e):] = e  # left padding
            mask[i, max_length - len(e):] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer(tokenizer_path: str):
    """``"byte"`` -> :class:`ByteTokenizer`; anything else -> an HF
    AutoTokenizer with the reference's settings (left pad, eos as pad),
    local files first, falling back to ByteTokenizer when the path is
    unavailable (as trlx_tpu does)."""
    if tokenizer_path == "byte":  # framework-native name, never a hub repo
        return ByteTokenizer()
    attempts = [{"local_files_only": True}]
    if os.environ.get("HF_HUB_OFFLINE", "") not in ("1", "true", "True"):
        attempts.append({})
    for kw in attempts:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(tokenizer_path, **kw)
        except (ImportError, OSError, ValueError):
            continue
        tok.padding_side = "left"
        if tok.pad_token is None:
            tok.pad_token = tok.eos_token
        return tok
    return ByteTokenizer()
