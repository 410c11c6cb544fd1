"""The reference's input path: frames -> tiles, conversations -> ids.

InternVL's dynamic preprocessing written plainly: the grid of 448 tiles
whose aspect ratio is closest to the frame's (ties to the larger grid when
the frame covers more than half of it), an area-weighted resize computed
in float64 and rounded to uint8, the grid's tiles, the thumbnail, and the
ImageNet normalization. Conversations render each `<image>` as
`<img>` + 256 `<IMG_CONTEXT>` a tile + `</img>`; labels cover the
assistant's words and the end token; rows are packed greedily in order.
"""

from __future__ import annotations

import numpy as np

from .model import MEAN, STD

IGNORE = -100


def grid_for(w: int, h: int, max_tiles: int, size: int) -> tuple[int, int]:
    """(cols, rows) by InternVL's `find_closest_aspect_ratio`."""
    ratios = sorted({(i, j) for n in range(1, max_tiles + 1)
                     for i in range(1, n + 1) for j in range(1, n + 1)
                     if i * j <= max_tiles}, key=lambda r: r[0] * r[1])
    aspect, best, best_diff = w / h, (1, 1), float("inf")
    for r in ratios:
        diff = abs(aspect - r[0] / r[1])
        if diff < best_diff:
            best, best_diff = r, diff
        elif diff == best_diff and w * h > 0.5 * size * size * r[0] * r[1]:
            best = r
    return best


def _area_matrix(src: int, dst: int) -> np.ndarray:
    """`[dst, src]` weights: the share of each destination pixel's
    footprint that each source pixel covers."""
    scale = src / dst
    m = np.zeros((dst, src))
    for i in range(dst):
        a, b = i * scale, (i + 1) * scale
        for s in range(int(np.floor(a)), min(int(np.ceil(b)), src)):
            m[i, s] = max(0.0, min(b, s + 1) - max(a, s)) / scale
    return m


def resize(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    if img.shape[:2] == tuple(hw):
        return img
    my, mx = _area_matrix(img.shape[0], hw[0]), _area_matrix(img.shape[1],
                                                             hw[1])
    h, w, c = img.shape
    rows = (my @ img.astype(np.float64).reshape(h, w * c)).reshape(-1, w, c)
    out = np.einsum("xw,ywc->yxc", mx, rows, optimize=True)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def tile(img: np.ndarray, max_tiles: int, size: int) -> np.ndarray:
    """RGB uint8 frame -> normalized float32 tiles `[n, size, size, 3]`."""
    h, w = img.shape[:2]
    cols, rows = grid_for(w, h, max_tiles, size)
    big = resize(img, (rows * size, cols * size))
    tiles = [big[r * size:(r + 1) * size, c * size:(c + 1) * size]
             for r in range(rows) for c in range(cols)]
    if len(tiles) > 1:
        tiles.append(resize(img, (size, size)))
    x = np.stack(tiles).astype(np.float32) / 255.0
    return (x - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)


def encode(sample: dict, tok, tokens_per_tile: int, n_tiles: list[int]):
    """A conversation -> (ids, labels) at its true length."""
    from ..tokenizer import ASSISTANT, HUMAN, IMG_CONTEXT, IMG_END, IMG_START

    ids, labels, k = [tok.bos_id], [IGNORE], 0
    for turn in sample["conversations"]:
        text = turn["value"]
        while "<image>" in text:
            block = IMG_START + IMG_CONTEXT * (tokens_per_tile * n_tiles[k])
            text = text.replace("<image>", block + IMG_END, 1)
            k += 1
        human = turn["from"] == "human"
        toks = tok.encode((HUMAN if human else ASSISTANT) + text)
        ids += toks
        if human:
            labels += [IGNORE] * len(toks)
        else:
            labels += [IGNORE] + toks[1:] + [tok.eos_id]
            ids.append(tok.eos_id)
    ids, labels = np.asarray(ids), np.asarray(labels)
    labels[ids == tok.img_context_id] = IGNORE
    return ids, labels


def pack(encoded, seq_len: int, max_tiles: int):
    """Greedy in-order packing of (ids, labels, tiles) into rows of
    `seq_len` positions and at most `max_tiles` tiles; a sample that does
    not fit alone is skipped. Yields rows with `ids`, `labels`,
    `positions`, `spans` (each segment's start and end) and `tiles`."""
    row, used, tiles_used = [], 0, 0

    def emit(row):
        ids = np.zeros(seq_len, np.int64)
        labels = np.full(seq_len, IGNORE, np.int64)
        pos = np.zeros(seq_len, np.int64)
        spans, at = [], 0
        for e_ids, e_labels, _ in row:
            n = len(e_ids)
            ids[at:at + n], labels[at:at + n] = e_ids, e_labels
            pos[at:at + n] = np.arange(n)
            spans.append((at, at + n))
            at += n
        used = at
        if at < seq_len:                # the pad tail attends to itself
            spans.append((at, seq_len))
        return {"ids": ids, "labels": labels, "positions": pos,
                "spans": spans, "used": used,
                "tiles": np.concatenate([t for *_, t in row])}

    for e in encoded:
        ids, labels, tiles = e
        if len(ids) > seq_len or len(tiles) > max_tiles:
            continue
        if used + len(ids) > seq_len or tiles_used + len(tiles) > max_tiles:
            if row:
                yield emit(row)
            row, used, tiles_used = [], 0, 0
        row.append(e)
        used += len(ids)
        tiles_used += len(tiles)
    if row:
        yield emit(row)
