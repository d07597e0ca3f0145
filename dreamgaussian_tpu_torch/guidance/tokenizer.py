"""CLIP byte-level BPE tokenizer, the port's own.

Gives the ids that ``transformers.CLIPTokenizer`` gives when ``ftfy`` is
not installed, from the files of a snapshot's ``tokenizer/`` folder
(``vocab.json``, ``merges.txt``, ``tokenizer_config.json``,
``special_tokens_map.json``):

- the text is cleaned as transformers' ``BasicTokenizer(strip_accents=False,
  do_split_on_punc=False)`` cleans it: NUL, U+FFFD and control characters
  dropped, whitespace made a space, spaces put around CJK ideographs, NFC,
  split on whitespace, each word lower-cased, joined by one space;
- it is split as CLIP's pattern splits it (the contractions
  ``'s 't 're 've 'm 'll 'd`` in either case, runs of letters, single
  digits, runs of anything else but whitespace), each piece
  mapped byte by byte to printable characters and merged by rank, its last
  symbol carrying ``</w>``;
- the special tokens (start, end, unknown and pad, as the config files
  name them) are split out of the raw text first and keep their own ids,
  as transformers splits its added tokens out (SD 2.1's pad token ``!``
  so becomes id 0 wherever it stands in a prompt);
- ``<|startoftext|>`` ... ``<|endoftext|>`` around the ids, which are cut to
  ``max_length - 2`` first, so that EOT stays.

Two paddings: ``"max_length"`` with the pad token (from the config files,
``<|endoftext|>`` by default), as the JAX package's ``_encode_text`` asks
transformers for, and ``"zeros"`` after EOT, as ``_tokenize_open_clip``
pads for the OpenCLIP tower. Only the standard library is used: the
letter and number classes of the pattern are read from
``unicodedata.category``.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# transformers keeps the merges file's lines 1 .. 49152 - 256 - 2 (line 0 is
# the version header, and is skipped whatever it holds).
MAX_MERGES = 49152 - 256 - 2


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def clean_text(text: str) -> str:
    """transformers' BasicTokenizer as CLIPTokenizer builds it without ftfy."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (ch not in "\t\n\r" and unicodedata.category(ch)[0] == "C"):
            continue
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(w.lower() for w in words)


def _kind(ch: str) -> str:
    """"L" letter, "N" number, "S" whitespace, "O" anything else."""
    if ch.isspace():
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def split_words(text: str) -> list[str]:
    """The pieces CLIP's pattern finds in ``text`` (without special
    tokens: ``CLIPTokenizer.tokenize`` splits those out first), left to right."""
    out, i, n = [], 0, len(text)
    while i < n:
        low = text[i:i + 3].lower()
        con = next((c for c in CONTRACTIONS if low.startswith(c)), None)
        if con is not None:
            out.append(text[i:i + len(con)])
            i += len(con)
            continue
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        if kind == "N":
            out.append(text[i])
            i += 1
            continue
        j = i + 1
        while j < n and _kind(text[j]) == kind:
            j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """``CLIPTokenizer(folder)``; ``encode(prompts, max_length, padding)``."""

    def __init__(self, folder: str):
        with open(os.path.join(folder, "vocab.json"), encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        with open(os.path.join(folder, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        self.ranks = {tuple(line.split()): r for r, line in enumerate(lines)}
        special = {"bos_token": BOS, "eos_token": EOS, "unk_token": EOS, "pad_token": EOS,
                   "model_max_length": 77}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            path = os.path.join(folder, name)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    raw = json.load(f)
                for key in special:
                    if raw.get(key) is not None:
                        v = raw[key]
                        special[key] = v["content"] if isinstance(v, dict) else v
        self.model_max_length = int(special["model_max_length"])
        names = ("bos_token", "eos_token", "unk_token", "pad_token")
        self.bos_id, self.eos_id, self.unk_id, self.pad_id = (self.encoder[special[k]]
                                                              for k in names)
        # Longest first, so that a special token that starts another loses.
        self.specials = sorted({special[k] for k in names}, key=len, reverse=True)
        self.byte_encoder = bytes_to_unicode()
        self.cache: dict[str, str] = {}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list[int]:
        """The ids of ``text`` without BOS and EOS."""
        ids, start, i = [], 0, 0
        while i <= len(text):
            special = next((t for t in self.specials if text.startswith(t, i)), None)
            if special is None and i < len(text):
                i += 1
                continue
            ids += self._tokenize_piece(text[start:i])
            if special is not None:
                ids.append(self.encoder[special])
                i += len(special)
                start = i
            else:
                break
        return ids

    def _tokenize_piece(self, text: str) -> list[int]:
        ids = []
        for piece in split_words(clean_text(text)):
            chars = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids += [self.encoder.get(t, self.unk_id) for t in self.bpe(chars).split(" ")]
        return ids

    def encode(self, prompts: list[str], max_length: int | None = None,
               padding: str = "max_length") -> list[list[int]]:
        """[BOS] ids[:max_length - 2] [EOS], padded to ``max_length`` (default
        ``model_max_length``) with the pad token (``"max_length"``) or with
        0 (``"zeros"``)."""
        max_length = max_length or self.model_max_length
        if padding not in ("max_length", "zeros"):
            raise ValueError(f"padding must be 'max_length' or 'zeros', not {padding!r}")
        pad = self.pad_id if padding == "max_length" else 0
        out = []
        for p in prompts:
            ids = [self.bos_id] + self.tokenize(p)[:max_length - 2] + [self.eos_id]
            out.append(ids + [pad] * (max_length - len(ids)))
        return out
