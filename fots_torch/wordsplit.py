"""Word splitting: divide a detected line box by recognizer frame positions.

The port's own copy of ``fots/wordsplit.py``.  The CTC recognizer emits
per-frame ids; spaces and separators mark word boundaries whose frame
indices are mapped back through the box geometry to per-word sub-boxes
(ICDAR ground truth is word-level, so the end-to-end evaluation needs this).
Ids are :class:`fots_torch.codec.LabelCodec`'s: blank 0, characters from 1.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from fots_torch.codec import LabelCodec

_SPLIT_KEEP = {".", ",", ":"}  # appended to the word, still split after


def decode_with_splits(frame_ids: np.ndarray, codec: LabelCodec):
    """Greedy CTC decode tracking word-boundary frame positions.

    Returns (text, word_splits, split_frames, start_frame, end_frame):
    ``word_splits[i]`` is the i-th word, ``split_frames[i]`` the frame just
    after its last character (matching print_seq_ext's ``dec_splits``).
    """
    prev = 0
    word = ""
    current = ""
    start_pos = 0
    end_pos = 0
    splits: List[str] = []
    split_frames: List[int] = []
    has_letter = False
    n_chars = len(codec.alphabet)
    for cx in range(frame_ids.shape[0]):
        c = int(frame_ids[cx])
        if c == prev:
            if c > 0:
                end_pos = cx
            continue
        if 0 < c <= n_chars:
            ch = codec.alphabet[c - 1]
            if ch == " " or ch in _SPLIT_KEEP:
                if has_letter:
                    if ch != " ":
                        current += ch
                    splits.append(current)
                    split_frames.append(cx + 1)
                    word += ch
                    current = ""
            else:
                has_letter = True
                word += ch
                current += ch
            end_pos = cx
        if len(word) == 0:
            start_pos = cx
        prev = c
    if current:
        splits.append(current)
        split_frames.append(end_pos + 1)
    return word.strip(), splits, np.asarray(split_frames), start_pos, end_pos + 1


def split_line_box(
    box8: np.ndarray,
    words: List[str],
    split_frames: np.ndarray,
    start_frame: int,
    n_frames: int,
) -> List[Tuple[np.ndarray, str]]:
    """Divide a quad along its width by word frame spans.

    Geometry equivalent of process_splits (eval.py:338-365): each word's
    [start,end] frame span scales to a horizontal slice of the box, mapped
    through the box's rotation.  Returns [(quad4x2, word), ...].
    """
    b = np.asarray(box8, np.float64)[:8].reshape(4, 2)
    w_vec = b[2] - b[1]   # width direction (p1 -> p2)
    w_len = float(np.hypot(*w_vec))
    if w_len < 1e-6 or n_frames <= 0:
        return [(b, " ".join(words))]
    u = w_vec / w_len
    out = []
    sf = float(start_frame)
    scalex = w_len / float(n_frames)
    for i, word in enumerate(words):
        ef = float(split_frames[i]) if i < len(split_frames) else n_frames
        poss = sf * scalex
        pose = min((ef + 2) * scalex, w_len)
        # slice corners: translate p0/p1 edge along the width direction
        p1s = b[1] + u * poss
        p1e = b[1] + u * pose
        p0s = b[0] + u * poss
        p0e = b[0] + u * pose
        quad = np.stack([p0s, p1s, p1e, p0e])
        out.append((quad, word))
        sf = ef + 1
    return out


def split_detection(box8, frame_ids, codec: LabelCodec):
    """Full pipeline: decode + split one detection into word boxes.

    Returns [(quad4x2, word)], or [] if nothing decoded.
    """
    text, words, split_frames, start_f, _end = decode_with_splits(
        np.asarray(frame_ids), codec
    )
    if not words:
        return []
    if len(words) == 1:
        return [(np.asarray(box8, np.float64)[:8].reshape(4, 2), words[0])]
    return split_line_box(box8, words, split_frames, start_f, len(frame_ids))
