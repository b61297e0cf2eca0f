"""CTC label codec: the port's own copy of ``fots.codec.LabelCodec``.

Ids: blank = 0, ``alphabet[i] = i + 1``; greedy decode collapses repeats,
then drops blanks.  Ported: the batched decode of the serving path, the
per-sequence decode the beam search uses, the encoders of the training path
and the edit distance of the evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

# The 86-character ICDAR2015 charset (dataset vocabulary).
ICDAR15_ALPHABET = (
    "7BCNTh2!F'P0ouRvz3[Qdesr6#:ÉyU(4bt%\"?´Kl.ZOM8@A1+)/ ki&DW$fwn;=p5HqSjV]JX-GEagxILmYc9,"
)


@dataclass
class LabelCodec:
    """char <-> id codec with the CTC blank at index 0."""

    alphabet: str = ICDAR15_ALPHABET
    _dict: Dict[str, int] = field(init=False, repr=False)
    _codes: np.ndarray = field(init=False, repr=False)

    #: ids below this are blank/control, not characters (the serving
    #: confidence mean counts frames with id >= reserved_ids)
    reserved_ids: int = 1

    def __post_init__(self):
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

    def decode_batch(self, ids: np.ndarray) -> List[str]:
        """CTC-collapse decode of a ``[N, T]`` greedy id matrix: drop repeats
        of the previous id, then blanks and out-of-alphabet ids."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return [""] * ids.shape[0] if ids.ndim == 2 else []
        n = ids.shape[0]
        prev = np.concatenate([np.zeros((n, 1), ids.dtype), ids[:, :-1]], axis=1)
        keep = (ids != prev) & (ids > 0) & (ids <= len(self.alphabet))
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
