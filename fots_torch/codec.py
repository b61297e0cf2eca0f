"""CTC label codec: the port's own copy of ``fots.codec.LabelCodec``.

Ids: blank = 0, ``alphabet[i] = i + 1``; greedy decode collapses repeats,
then drops blanks.  Only the batched decode of the serving path is ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

# The 86-character ICDAR2015 charset (dataset vocabulary).
ICDAR15_ALPHABET = (
    "7BCNTh2!F'P0ouRvz3[Qdesr6#:ÉyU(4bt%\"?´Kl.ZOM8@A1+)/ ki&DW$fwn;=p5HqSjV]JX-GEagxILmYc9,"
)


@dataclass
class LabelCodec:
    """char <-> id codec with the CTC blank at index 0."""

    alphabet: str = ICDAR15_ALPHABET
    _codes: np.ndarray = field(init=False, repr=False)

    #: ids below this are blank/control, not characters (the serving
    #: confidence mean counts frames with id >= reserved_ids)
    reserved_ids: int = 1

    def __post_init__(self):
        self._codes = np.array([ord(c) for c in self.alphabet] or [0], np.uint32)

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
