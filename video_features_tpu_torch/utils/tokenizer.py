"""Byte-level BPE tokenizer for CLIP's ``show_pred`` prompts (the port's
copy of ``video_features_tpu/utils/tokenizer.py``, reference
models/clip/clip_src/simple_tokenizer.py:62-132 and clip.py:200-239).

GPT-2's reversible byte <-> unicode map, a lowercased regex pre-split, merge
ranks from the first 48,894 rules of ``bpe_simple_vocab_16e6.txt.gz``, the
vocabulary 256 bytes + 256 ``</w>`` bytes + merges + the two specials, and
fixed-length ``[sot] + bpe(text) + [eot]`` rows zero-padded on the right.

The vocab file is data, not in the repository: it is read from ``bpe_path``
or the weights store's directory, and never fetched. ``regex`` is imported when a tokenizer is built (the
``show_pred`` path only); ``ftfy`` cleans the text when it is installed.
"""
from __future__ import annotations

import gzip
import html
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
#: the pre-split (simple_tokenizer.py:81): the specials, contractions,
#: letter runs, single digits, punctuation runs
_PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (simple_tokenizer.py:15-36):
    printable latin bytes map to themselves, the rest are shifted past 255;
    the insertion order sets the first 256 vocab indices."""
    keep = (list(range(ord("!"), ord("~") + 1)) +
            list(range(ord("¡"), ord("¬") + 1)) +
            list(range(ord("®"), ord("ÿ") + 1)))
    mapping = {b: chr(b) for b in keep}
    shifted = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shifted)
            shifted += 1
    return mapping


def find_bpe_vocab(explicit_path: Optional[str] = None) -> Path:
    """The vocab file at ``bpe_path``, else
    ``bpe_simple_vocab_16e6.txt.gz`` under the weights store's directory
    (``weights/store.py weights_dir``); raises naming both."""
    from ..weights.store import weights_dir
    if explicit_path:
        p = Path(explicit_path)
        if not p.exists():
            raise FileNotFoundError(f"bpe_path does not exist: {p}")
        return p
    p = weights_dir() / "bpe_simple_vocab_16e6.txt.gz"
    if p.exists():
        return p
    raise FileNotFoundError(
        "CLIP BPE vocab not found. Drop `bpe_simple_vocab_16e6.txt.gz` (the "
        f"OpenAI CLIP vocab file) into {weights_dir()} or pass `bpe_path=...`.")


class ClipTokenizer:

    def __init__(self, bpe_path: Optional[str] = None) -> None:
        import regex
        self._regex = regex
        self._pat = regex.compile(_PATTERN, regex.IGNORECASE)
        raw = gzip.open(str(find_bpe_vocab(bpe_path))).read().decode("utf-8")
        # the first line is a version header; only the first 48,894 merges
        # are part of the 49,152-token vocab (simple_tokenizer.py:66-67)
        merges: List[Tuple[str, str]] = []
        for line in raw.split("\n")[1:VOCAB_SIZE - 256 - 2 + 1 - 256]:
            a, b = line.split()
            merges.append((a, b))
        base = list(byte_to_unicode().values())
        vocab = base + [c + "</w>" for c in base]
        vocab += ["".join(m) for m in merges] + [SOT, EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.sot_token = self.encoder[SOT]
        self.eot_token = self.encoder[EOT]
        self._byte_enc = byte_to_unicode()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        self._cache: Dict[str, str] = {SOT: SOT, EOT: EOT}

    def _clean(self, text: str) -> str:
        try:
            import ftfy
            text = ftfy.fix_text(text)
        except ImportError:
            pass
        text = html.unescape(html.unescape(text)).strip()
        return self._regex.sub(r"\s+", " ", text).strip()

    def _bpe(self, token: str) -> str:
        """Apply the lowest-ranked merge until none applies."""
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (word[i] == first and i + 1 < len(word)
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self._pat.findall(self._clean(text).lower()):
            mapped = "".join(self._byte_enc[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        data = bytearray(self._byte_dec[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts: Union[str, Sequence[str]],
                 context_length: int = CONTEXT_LENGTH,
                 truncate: bool = False) -> np.ndarray:
        """Texts -> (N, context_length) int32, ``[sot] + bpe + [eot]``,
        zero-padded (clip.py:200-239)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {texts[i]} is too long for context length "
                        f"{context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot_token
            out[i, :len(ids)] = ids
        return out
