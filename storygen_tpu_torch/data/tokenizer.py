"""The CLIP byte-level BPE tokenizer, on the Python standard library.

Counterpart of storygen_tpu/data/loader.py's `Tokenizer`, which wraps
transformers' CLIPTokenizerFast. This one gives the same ids from the same
`vocab.json` and `merges.txt` without transformers, `tokenizers` or
`regex`:

- the text is normalised as the fast tokenizer does: NFC, every run of
  Unicode white space made one space, each character lower-cased on its
  own;
- it is split on the special tokens (bos, eos, unk and pad), each of
  which is its own id;
- each other piece is split into words by CLIP's pattern
  `'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+`, with the
  letter and number classes read from `unicodedata` categories;
- each word's UTF-8 bytes are mapped to GPT-2's byte characters, the last
  one suffixed `</w>`, and merged by rank; a symbol missing from the vocab
  is the unk id.

A call returns (B, max_length) int32 ids: bos, at most max_length - 2
tokens, eos, then pad.
"""
from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "pad_token")
DEFAULT_SPECIAL = {"bos_token": "<|startoftext|>",
                   "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>",
                   "pad_token": "<|endoftext|>"}
# the CLIP reader keeps the first 49152 - 256 - 2 merges after the header
MAX_MERGES = 49152 - 256 - 2
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# Unicode's White_Space property: what `\s` matches in the fast
# tokenizer's patterns (Python's `\s` also matches U+001C..U+001F)
WHITE_SPACE = frozenset(
    [chr(c) for c in range(0x09, 0x0E)]
    + [chr(c) for c in (0x20, 0x85, 0xA0, 0x1680, 0x2028, 0x2029, 0x202F,
                        0x205F, 0x3000)]
    + [chr(c) for c in range(0x2000, 0x200B)])


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTE_CHARS = bytes_to_unicode()


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def normalize(text: str) -> str:
    """NFC, each white-space run one space, lower case per character."""
    text = unicodedata.normalize("NFC", text)
    out: List[str] = []
    in_space = False
    for c in text:
        if c in WHITE_SPACE:
            if not in_space:
                out.append(" ")
            in_space = True
        else:
            out.append(c.lower())
            in_space = False
    return "".join(out)


def words(text: str) -> List[str]:
    """The matches of CLIP's pattern in normalised text, leftmost first;
    white space between them is dropped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            suffix = next((s for s in CONTRACTIONS
                           if text.startswith(s, i + 1)), None)
            if suffix is not None:
                out.append("'" + suffix)
                i += 1 + len(suffix)
                continue
        if c in WHITE_SPACE:
            i += 1
            continue
        j = i + 1
        if _is_letter(c):
            while j < n and _is_letter(text[j]):
                j += 1
        elif not _is_number(c):
            while j < n and not (text[j] in WHITE_SPACE or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _token_content(value) -> Optional[str]:
    """A special token as tokenizer_config.json or special_tokens_map.json
    writes it: a string or {"content": ...}."""
    if isinstance(value, dict):
        return value.get("content")
    return value


def read_special_tokens(path: str) -> Dict[str, str]:
    """bos/eos/unk/pad from tokenizer_config.json, with
    special_tokens_map.json taking precedence unless the config lists its
    added tokens (the precedence of transformers' loader); CLIP's defaults
    for what neither names."""
    tokens = dict(DEFAULT_SPECIAL)
    config: dict = {}
    config_path = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(config_path):
        with open(config_path, encoding="utf-8") as f:
            config = json.load(f)
    smap: dict = {}
    map_path = os.path.join(path, "special_tokens_map.json")
    if os.path.exists(map_path):
        with open(map_path, encoding="utf-8") as f:
            smap = json.load(f)
    first, second = ((smap, config) if "added_tokens_decoder" in config
                     else (config, smap))
    for source in (first, second):
        for key in SPECIAL_KEYS:
            value = _token_content(source.get(key))
            if value is not None:
                tokens[key] = value
    return tokens


class Tokenizer:
    """CLIP BPE from a folder with vocab.json and merges.txt: a list of B
    strings -> (B, max_length) int32 ids."""

    def __init__(self, path: str, max_length: int = 77):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:1 + MAX_MERGES]
        self.merges: List[Tuple[str, ...]] = [tuple(m.split()) for m in lines]
        self.ranks = {m: i for i, m in enumerate(self.merges)}
        self.special = read_special_tokens(path)
        self.max_length = max_length
        self.ids = {k: self.token_id(v) for k, v in self.special.items()}
        # longest first, so that one special token inside another loses
        self._split_on = sorted(set(self.special.values()), key=len,
                                reverse=True)
        self._cache: Dict[str, List[int]] = {}

    def token_id(self, token: str) -> int:
        """A token's id; the unk token's for a token not in the vocab."""
        if token in self.encoder:
            return self.encoder[token]
        return self.encoder[self.special["unk_token"]]

    def _bpe(self, word: str) -> List[int]:
        """The ids of one pre-tokenized word."""
        if word in self._cache:
            return self._cache[word]
        chars = "".join(BYTE_CHARS[b] for b in word.encode("utf-8"))
        parts = list(chars[:-1]) + [chars[-1] + "</w>"]
        while len(parts) > 1:
            pairs = {(a, b) for a, b in zip(parts, parts[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if (i + 1 < len(parts) and parts[i] == best[0]
                        and parts[i + 1] == best[1]):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids = [self.token_id(p) for p in parts]
        self._cache[word] = ids
        return ids

    def _split_special(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is a special token) in order."""
        pieces: List[Tuple[str, bool]] = []
        i = start = 0
        while i < len(text):
            hit = next((s for s in self._split_on if text.startswith(s, i)),
                       None)
            if hit is None:
                i += 1
                continue
            if i > start:
                pieces.append((text[start:i], False))
            pieces.append((hit, True))
            i = start = i + len(hit)
        if start < len(text):
            pieces.append((text[start:], False))
        return pieces

    def encode(self, text: str) -> List[int]:
        """The ids of one text without bos, eos or padding."""
        ids: List[int] = []
        for piece, special in self._split_special(normalize(text)):
            if special:
                ids.append(self.token_id(piece))
                continue
            for word in words(piece):
                ids.extend(self._bpe(word))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        n = self.max_length
        out = np.full((len(texts), n), self.ids["pad_token"], np.int32)
        for row, text in enumerate(texts):
            ids = ([self.ids["bos_token"]] + self.encode(text)[:n - 2]
                   + [self.ids["eos_token"]])
            out[row, :len(ids)] = ids
        return out

    def save_pretrained(self, path: str) -> None:
        """Write vocab.json, merges.txt (with its version header),
        tokenizer_config.json and special_tokens_map.json, which this class
        and transformers' CLIP tokenizers read."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        with open(os.path.join(path, "merges.txt"), "w",
                  encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            f.write("".join(" ".join(m) + "\n" for m in self.merges))
        config = dict(self.special, model_max_length=self.max_length,
                      tokenizer_class="CLIPTokenizer")
        for name, obj in (("tokenizer_config.json", config),
                          ("special_tokens_map.json", self.special)):
            with open(os.path.join(path, name), "w", encoding="utf-8") as f:
                json.dump(obj, f, indent=2, ensure_ascii=False)
