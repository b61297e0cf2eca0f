"""CTC label codec: the port's own copy of ``fots.codec.LabelCodec``.

Ids: blank = 0, ``alphabet[i] = i + 1``; greedy decode collapses repeats,
then drops blanks.  Ported: the batched decode of the serving path, the
per-sequence decode the beam search uses, the encoders of the training path
and the edit distance of the evaluation; the recognition-only stack's
4-offset :class:`Codec4` (with the word-split decode), the token codec
:class:`SepLabelCodec`, :func:`load_charset` and
:func:`build_charset_from_labels`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# The 86-character ICDAR2015 charset (dataset vocabulary).
ICDAR15_ALPHABET = (
    "7BCNTh2!F'P0ouRvz3[Qdesr6#:ÉyU(4bt%\"?´Kl.ZOM8@A1+)/ ki&DW$fwn;=p5HqSjV]JX-GEagxILmYc9,"
)


@dataclass
class LabelCodec:
    """char <-> id codec with the CTC blank at index 0.  ``ignore_case``
    lower-cases the alphabet, and every text before it is encoded."""

    alphabet: str = ICDAR15_ALPHABET
    ignore_case: bool = False
    _dict: Dict[str, int] = field(init=False, repr=False)
    _codes: np.ndarray = field(init=False, repr=False)

    #: ids below this are blank/control, not characters (the serving
    #: confidence mean counts frames with id >= reserved_ids)
    reserved_ids: int = 1

    def __post_init__(self):
        if self.ignore_case:
            self.alphabet = self.alphabet.lower()
        self._dict = {ch: i + 1 for i, ch in enumerate(self.alphabet)}
        self._codes = np.array([ord(c) for c in self.alphabet] or [0], np.uint32)

    @property
    def num_classes(self) -> int:
        return len(self.alphabet) + 1

    def encode(self, texts: Union[Sequence[str], str]) -> Tuple[np.ndarray, np.ndarray]:
        """Flat id array of all texts + per-text lengths; characters outside
        the alphabet are dropped."""
        if isinstance(texts, str):
            texts = [texts]
        ids: List[int] = []
        lengths: List[int] = []
        for t in texts:
            if self.ignore_case:
                t = t.lower()
            enc = [self._dict[c] for c in t if c in self._dict]
            ids.extend(enc)
            lengths.append(len(enc))
        return np.asarray(ids, dtype=np.int32), np.asarray(lengths, dtype=np.int32)

    def encode_padded(self, texts: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-shape ``[N, max_len]`` id matrix (0-padded, truncated at
        ``max_len``) + lengths, the layout the CTC loss takes."""
        out = np.zeros((len(texts), max_len), dtype=np.int32)
        lengths = np.zeros((len(texts),), dtype=np.int32)
        for i, t in enumerate(texts):
            flat, ln = self.encode(t)
            n = min(int(ln[0]), max_len)
            out[i, :n] = flat[:n]
            lengths[i] = n
        return out, lengths

    def decode_ids(self, ids: Sequence[int], raw: bool = False) -> str:
        """CTC-collapse decode of one id sequence: drop blanks (0) and
        repeated ids, map ``i -> alphabet[i - 1]``.  ``raw``: the ids are
        labels already (a beam hypothesis), only mapped."""
        if raw:
            return "".join(self.alphabet[i - 1] for i in ids if 0 < i <= len(self.alphabet))
        chars = []
        prev = 0
        for i in ids:
            if i != 0 and i != prev and 0 < i <= len(self.alphabet):
                chars.append(self.alphabet[i - 1])
            prev = i
        return "".join(chars)

    def decode_batch(self, ids: np.ndarray, lengths: Optional[np.ndarray] = None
                     ) -> List[str]:
        """CTC-collapse decode of a ``[N, T]`` greedy id matrix: drop repeats
        of the previous id, then blanks and out-of-alphabet ids.  ``lengths``
        [N]: a row's frames at or past its length are dropped too."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return [""] * ids.shape[0] if ids.ndim == 2 else []
        n, t = ids.shape
        prev = np.concatenate([np.zeros((n, 1), ids.dtype), ids[:, :-1]], axis=1)
        keep = (ids != prev) & (ids > 0) & (ids <= len(self.alphabet))
        if lengths is not None:
            keep &= np.arange(t)[None, :] < np.asarray(lengths).reshape(n, 1)
        if not self.alphabet:
            return [""] * n
        # gather code points, decode one utf-32 buffer, slice per row
        codes = self._codes[np.clip(ids.astype(np.int64) - 1, 0,
                                    len(self.alphabet) - 1)]
        flat = np.ascontiguousarray(codes[keep], dtype="<u4")
        s = flat.tobytes().decode("utf-32-le")
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(keep.sum(axis=1), out=offs[1:])
        return [s[offs[i]:offs[i + 1]] for i in range(n)]


@dataclass
class Codec4:
    """Multilingual codec with 4 reserved ids: real characters start at id
    4, id 3 is the unknown character, 0 the CTC blank."""

    charset: str
    _dict: Dict[str, int] = field(init=False, repr=False)

    def __post_init__(self):
        self._dict = {ch: i + 4 for i, ch in enumerate(self.charset)}

    @property
    def num_classes(self) -> int:
        return len(self.charset) + 4

    #: ids 0-3 are reserved (blank / control / unknown)
    reserved_ids: int = 4

    def encode(self, text: str) -> List[int]:
        return [self._dict.get(c, 3) for c in text]

    def decode_with_splits(self, frame_ids: np.ndarray):
        """Greedy decode with word-split tracking: collapse repeats; ids >= 4
        are characters; space, '.', ',' and ':' end the current word and
        record the frame of the split; ids 1..3 act as separators.

        Returns ``(text, (start, end), split_positions, words)``."""
        prev = 0
        word = ""
        current_word = ""
        start_pos = 0
        end_pos = 0
        dec_splits: List[int] = []
        splits: List[str] = []
        has_letter = False
        for cx in range(frame_ids.shape[0]):
            c = int(frame_ids[cx])
            if prev == c:
                if c > 2:
                    end_pos = cx
                continue
            if 3 < c < (len(self.charset) + 4):
                char = self.charset[c - 4]
                if char in (" ", ".", ",", ":"):
                    if has_letter:
                        if char != " ":
                            current_word += char
                        splits.append(current_word)
                        dec_splits.append(cx + 1)
                        word += char
                        current_word = ""
                else:
                    has_letter = True
                    word += char
                    current_word += char
                end_pos = cx
            elif c > 0:
                if has_letter:
                    dec_splits.append(cx + 1)
                    word += " "
                    end_pos = cx
                    splits.append(current_word)
                    current_word = ""
            if len(word) == 0:
                start_pos = cx
            prev = c
        dec_splits.append(end_pos + 1)
        return word.strip(), (start_pos, end_pos + 1), np.asarray(dec_splits), splits


@dataclass
class SepLabelCodec:
    """Separator-delimited token codec (multi-character alphabet entries):
    the alphabet is a ``sep``-joined token list; blank 0, tokens 1..N."""

    alphabet_str: str
    sep: str
    tokens: List[str] = field(init=False, repr=False)
    _dict: Dict[str, int] = field(init=False, repr=False)

    def __post_init__(self):
        self.tokens = self.alphabet_str.split(self.sep)
        self._dict = {t: i + 1 for i, t in enumerate(self.tokens)}

    @property
    def num_classes(self) -> int:
        return len(self.tokens) + 1

    def encode(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        toks = [self._dict[t] for t in text.split(self.sep) if t in self._dict]
        return np.asarray(toks, np.int32), np.asarray([len(toks)], np.int32)

    def decode_ids(self, ids: Sequence[int], raw: bool = False) -> str:
        if raw:
            return "".join(self.tokens[i - 1] for i in ids
                           if 0 < i <= len(self.tokens))
        out, prev = [], 0
        for i in ids:
            if i != 0 and i != prev and 0 < i <= len(self.tokens):
                out.append(self.tokens[i - 1])
            prev = i
        return "".join(out)


def load_charset(path: str) -> str:
    """The first line of a one-line charset file (a codec.txt vocabulary)."""
    with open(path, "r", encoding="utf-8") as f:
        return f.readlines()[0].rstrip("\n")


def build_charset_from_labels(labels) -> str:
    """A charset of training transcriptions: their characters, sorted, once
    each."""
    chars = set()
    for t in labels:
        chars.update(t)
    return "".join(sorted(chars))


def levenshtein(a: str, b: str) -> int:
    """Edit distance between two strings."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]
