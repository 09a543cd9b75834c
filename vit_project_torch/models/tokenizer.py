"""CLIP BPE tokenizer.

A from-scratch implementation of the byte-pair-encoding scheme OpenAI CLIP uses
(lower-cased, whitespace-collapsed text; byte-to-unicode mapping; merges applied by
rank; word-final '</w>' marker; <|startoftext|>/<|endoftext|> specials; context
length 77). The reference calls the external `clip.tokenize` once per SPoSE class
name (CLIPHBA.__init__, new_cvpr_train_behavior_things_pipeline.py:282).

The merge table ships with OpenAI CLIP as `bpe_simple_vocab_16e6.txt.gz`; this
environment has no network egress, so:
- `ClipTokenizer(vocab_path)` loads a user-provided vocab (gz or plain text);
- `HashTokenizer` is a deterministic fallback producing valid token ids for
  random-weight testing (NOT compatible with pretrained text towers).
"""
from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407


@lru_cache()
def bytes_to_unicode():
    """Map bytes to printable unicode chars (GPT-2 scheme used by CLIP)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's word-splitting pattern. The original uses regex-module unicode classes
# (\p{L}/\p{N}); stdlib `re` lacks them, so letters/digits are matched ASCII-wise
# — identical behavior for the (all-ASCII) SPoSE prompts and English text.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE)


class ClipTokenizer:
    """BPE tokenizer compatible with OpenAI CLIP given its merge table."""

    def __init__(self, bpe_path: str):
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


class HashTokenizer:
    """Deterministic fallback tokenizer: one stable pseudo-token per word.

    Produces valid ids in [0, 49406) so randomly-initialized text towers can be
    exercised without the OpenAI merge table. NOT compatible with pretrained CLIP.
    """

    def encode(self, text: str) -> list[int]:
        words = _whitespace_clean(_basic_clean(text)).lower()
        out = []
        for w in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", words):
            h = 2166136261
            for ch in w.encode("utf-8"):  # FNV-1a, stable across runs
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            out.append(h % (SOT - 1))
        return out


def tokenize(texts, tokenizer=None, context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """texts -> int32 [N, context_length] with SOT/EOT framing (clip.tokenize
    contract; reference tokenizes the 66 SPoSE prompts once at model build).

    Default truncate=False RAISES on over-length input like clip.tokenize —
    silently cutting a prompt would produce different text embeddings where
    the reference fails loudly. (The 66 SPoSE prompts are single words and
    never truncate.)"""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or HashTokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT] + tokenizer.encode(text) + [EOT]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input too long for context "
                                   f"{context_length}: {text!r}")
            ids = ids[:context_length]
            ids[-1] = EOT
        result[i, :len(ids)] = ids
    return result


def default_tokenizer(bpe_path: str | None = None):
    """ClipTokenizer when a vocab is available (explicit path or CLIP_BPE_PATH
    env var), else the hash fallback."""
    path = bpe_path or os.environ.get("CLIP_BPE_PATH")
    if path and os.path.exists(path):
        return ClipTokenizer(path)
    return HashTokenizer()
