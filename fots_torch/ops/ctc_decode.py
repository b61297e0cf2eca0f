"""CTC decoders (host, NumPy): greedy and prefix beam search.

The port's own copy of ``fots/ops/ctc_decode.py``, the same arithmetic in
the same order, so the same hypotheses and scores.  Prefix beam search
keeps the ``beam_width`` most probable label prefixes while marginalising
over alignments; :func:`prefix_beam_search_topk` runs it over the per-frame
top-k log-probs that :class:`fots_torch.pipeline.FOTSInference` brings back
from the device when ``beam > 0``.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import List, Tuple

import numpy as np

NEG_INF = -math.inf


def greedy_decode(log_probs: np.ndarray) -> np.ndarray:
    """[T, K] -> frame ids (argmax); collapse with LabelCodec.decode_ids."""
    return np.argmax(log_probs, axis=-1)


def _logsumexp(*xs: float) -> float:
    m = max(xs)
    if m == NEG_INF:
        return NEG_INF
    return m + math.log(sum(math.exp(x - m) for x in xs))


def prefix_beam_search(
    log_probs: np.ndarray,
    beam_width: int = 8,
    blank: int = 0,
    top_k_per_frame: int = 16,
) -> List[Tuple[Tuple[int, ...], float]]:
    """Prefix beam search over [T, K] log-probs.

    Returns up to ``beam_width`` (label_id_tuple, log_prob) pairs, best
    first.  ``top_k_per_frame`` prunes the per-frame symbol fanout.
    """
    T, K = log_probs.shape
    # beams: prefix -> (log p ending in blank, log p ending in non-blank)
    beams = {(): (0.0, NEG_INF)}
    for t in range(T):
        frame = log_probs[t]
        cand = np.argpartition(frame, -min(top_k_per_frame, K))[-top_k_per_frame:]
        next_beams: dict = defaultdict(lambda: (NEG_INF, NEG_INF))

        def accumulate(prefix, pb, pnb):
            opb, opnb = next_beams[prefix]
            next_beams[prefix] = (_logsumexp(opb, pb), _logsumexp(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            p_total = _logsumexp(pb, pnb)
            for s in cand:
                p = float(frame[s])
                if s == blank:
                    accumulate(prefix, p_total + p, NEG_INF)
                    continue
                last = prefix[-1] if prefix else None
                if s == last:
                    # repeat symbol: extends the blank-path only
                    accumulate(prefix, NEG_INF, pnb + p)
                    accumulate(prefix + (s,), NEG_INF, pb + p)
                else:
                    accumulate(prefix + (s,), NEG_INF, p_total + p)
        beams = dict(
            sorted(next_beams.items(),
                   key=lambda kv: -_logsumexp(*kv[1]))[:beam_width]
        )
    out = [(p, _logsumexp(*v)) for p, v in beams.items()]
    out.sort(key=lambda kv: -kv[1])
    return out


def beam_decode_text(log_probs: np.ndarray, codec, beam_width: int = 8) -> str:
    """Best beam -> text through a LabelCodec-style alphabet."""
    beams = prefix_beam_search(np.asarray(log_probs), beam_width=beam_width)
    if not beams:
        return ""
    ids = beams[0][0]
    return "".join(codec.alphabet[i - 1] for i in ids
                   if 0 < i <= len(codec.alphabet))


def prefix_beam_search_topk(
    frame_syms: np.ndarray,
    frame_logps: np.ndarray,
    blank_logps: np.ndarray,
    beam_width: int = 8,
    blank: int = 0,
) -> List[Tuple[Tuple[int, ...], float]]:
    """Prefix beam search over device-pruned per-frame top-k log-probs.

    The serving path ships only each frame's top-``k`` symbols
    (``frame_syms``/``frame_logps``, [T, k]) plus the blank log-prob
    ([T]) instead of the full [T, nclass] matrix — tens of floats per
    frame instead of thousands over the host link.  Identical to
    :func:`prefix_beam_search` with ``top_k_per_frame=k`` whenever blank
    is in every frame's true top-k (it is appended explicitly here, so
    blank transitions are always exact).
    """
    T = frame_syms.shape[0]
    beams = {(): (0.0, NEG_INF)}
    for t in range(T):
        # per-frame candidate (symbol, logp) list: pruned top-k + blank
        cand = {int(blank): float(blank_logps[t])}
        for s, lp in zip(frame_syms[t], frame_logps[t]):
            cand.setdefault(int(s), float(lp))
        next_beams: dict = defaultdict(lambda: (NEG_INF, NEG_INF))

        def accumulate(prefix, pb, pnb):
            opb, opnb = next_beams[prefix]
            next_beams[prefix] = (_logsumexp(opb, pb), _logsumexp(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            p_total = _logsumexp(pb, pnb)
            for s, p in cand.items():
                if s == blank:
                    accumulate(prefix, p_total + p, NEG_INF)
                    continue
                last = prefix[-1] if prefix else None
                if s == last:
                    accumulate(prefix, NEG_INF, pnb + p)
                    accumulate(prefix + (s,), NEG_INF, pb + p)
                else:
                    accumulate(prefix + (s,), NEG_INF, p_total + p)
        beams = dict(
            sorted(next_beams.items(),
                   key=lambda kv: -_logsumexp(*kv[1]))[:beam_width]
        )
    out = [(p, _logsumexp(*v)) for p, v in beams.items()]
    out.sort(key=lambda kv: -kv[1])
    return out
