"""Byte-level tokenizer (reversible, vocab 256 + specials).

A copy of ``src/repro/data/tokenizer.py`` (numpy only), so that the port
imports nothing of the JAX package.

The paper trains on wikitext-103 with the GPT-2 BPE vocab; that tokenizer
is not available offline, so real text files are tokenized at byte level
and the synthetic corpus (repro_torch.data.pipeline) emits ids directly
in any requested vocab.  PPL comparisons between architectures are unaffected by
tokenizer choice as long as it is held fixed (DESIGN.md §7).
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3
VOCAB_SIZE = 256 + N_SPECIAL


def encode(text: str, add_bos: bool = True) -> np.ndarray:
    ids = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
        np.int32) + N_SPECIAL
    if add_bos:
        ids = np.concatenate([[BOS], ids]).astype(np.int32)
    return ids


def decode(ids: Iterable[int]) -> str:
    bs = bytes(int(i) - N_SPECIAL for i in ids
               if int(i) >= N_SPECIAL)
    return bs.decode("utf-8", errors="replace")
