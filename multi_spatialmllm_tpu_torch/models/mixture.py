"""Training-data mixtures: InternVL-style meta JSON -> sample stream (the
port's copy of multi_spatialmllm_tpu/models/mixture.py).

The meta JSON maps dataset names to `{root, annotation, repeat_time,
length}`, where `annotation` is a MultiSPA-format JSONL and `repeat_time`
over/under-samples the dataset:

* `load_meta(path)` parses the same JSON shape (unknown keys ignored,
  relative paths resolved against the meta file's directory);
* `mixture_samples(...)` streams records across datasets in a
  DETERMINISTIC per-epoch global shuffle (core.rng named streams, so a
  given (seed, epoch) always yields the same order as in the JAX package —
  restartable and shard-friendly);
* `mixture_batches(...)` feeds the stream through models/data.py's
  padded or packed batch assembly.

JSONL files are indexed by byte offset once and read lazily — a 3M-row
mixture never resides in host memory.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Iterator

import numpy as np

from ..core.rng import stream
from .data import DataConfig, batch_iterator, packed_batch_iterator
from .mllm import MLLMConfig
from .tokenizer import SpatialTokenizer


@dataclasses.dataclass(frozen=True)
class MixtureEntry:
    """One dataset in the mixture (InternVL meta-JSON keys)."""

    name: str
    annotation: str              # JSONL of MultiSPA-format records
    root: str = ""               # prefix for the records' image paths
    repeat_time: float = 1.0     # >1 oversamples; <1 subsamples per epoch

    def rows_per_epoch(self, n_rows: int) -> int:
        return int(round(self.repeat_time * n_rows))


class JsonlIndex:
    """Byte-offset index over a JSONL file: one scan at construction,
    then O(1) random access without holding rows in memory. Random
    access is thread-safe (stats/validation/prefetch producers may
    share one cached index)."""

    def __init__(self, path: str):
        import threading

        self.path = path
        offsets = []
        with open(path, "rb") as f:
            at = 0
            for line in f:
                if line.strip():
                    offsets.append(at)
                at += len(line)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self._f = None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, i: int) -> dict:
        with self._lock:
            if self._f is None:
                self._f = open(self.path, "rb")
            self._f.seek(int(self.offsets[i]))
            return json.loads(self._f.readline())


_INDEX_CACHE: dict[str, tuple[tuple, JsonlIndex]] = {}


def jsonl_index(path: str) -> JsonlIndex:
    """Cached JsonlIndex keyed by (path, mtime, size): stats,
    validation, and the sample stream share one scan per file instead
    of re-indexing a multi-GB annotation three times per run."""
    st = os.stat(path)
    sig = (st.st_mtime_ns, st.st_size)
    hit = _INDEX_CACHE.get(path)
    if hit is None or hit[0] != sig:
        _INDEX_CACHE[path] = (sig, JsonlIndex(path))
    return _INDEX_CACHE[path][1]


def load_meta(path: str) -> list[MixtureEntry]:
    """InternVL-style meta JSON -> ordered entries. Relative
    `annotation`/`root` paths resolve against the meta file's directory;
    extra keys (`length`, `data_augment`, ...) are accepted and ignored
    (`length` is informational in the InternVL format too)."""
    base = os.path.dirname(os.path.abspath(path))

    def resolve(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(base, p)

    with open(path) as f:
        meta = json.load(f)
    entries = []
    for name, spec in meta.items():
        entries.append(MixtureEntry(
            name=name,
            annotation=resolve(spec["annotation"]),
            root=resolve(spec["root"]) if spec.get("root") else "",
            repeat_time=float(spec.get("repeat_time", 1.0))))
    if not entries:
        raise ValueError(f"empty mixture meta: {path}")
    return entries


def epoch_order(counts: list[int], entries: list[MixtureEntry],
                seed: int, epoch: int) -> np.ndarray:
    """`[n_epoch_rows, 2]` of (dataset_idx, row_idx): repeat_time full
    copies of each dataset plus a shuffled fractional prefix, globally
    shuffled. Deterministic in (seed, epoch) via named rng streams."""
    parts = []
    for d, (n, e) in enumerate(zip(counts, entries)):
        if n == 0:
            continue
        want = e.rows_per_epoch(n)
        full, rem = divmod(want, n)
        rows = np.tile(np.arange(n, dtype=np.int64), full)
        if rem:
            r = stream(seed, "mixture", e.name, "fraction", epoch)
            rows = np.concatenate(
                [rows, r.permutation(n)[:rem].astype(np.int64)])
        parts.append(np.stack(
            [np.full(len(rows), d, dtype=np.int64), rows], axis=1))
    order = np.concatenate(parts, axis=0)
    g = stream(seed, "mixture", "order", epoch)
    return order[g.permutation(len(order))]


def mixture_samples(entries: list[MixtureEntry], seed: int = 0,
                    epochs: int | None = None,
                    start_epoch: int = 0,
                    shard_index: int = 0,
                    num_shards: int = 1) -> Iterator[dict]:
    """Stream records across the mixture, epoch by epoch. Each record is
    a copy with its `image` paths joined onto the entry's `root` (so one
    plain file loader serves every dataset) and a `_dataset` tag for
    bookkeeping. `epochs=None` streams forever.

    `num_shards > 1` is the multi-host input pipeline: every host
    computes the SAME deterministic epoch order and takes its
    `order[shard_index::num_shards]` stride — disjoint, covering, no
    coordination or data exchange between hosts."""
    assert 0 <= shard_index < num_shards, (shard_index, num_shards)
    indices = [jsonl_index(e.annotation) for e in entries]
    counts = [len(ix) for ix in indices]
    if sum(e.rows_per_epoch(n) for e, n in zip(entries, counts)) == 0:
        raise ValueError("mixture yields zero rows per epoch")
    epoch = start_epoch
    while epochs is None or epoch < start_epoch + epochs:
        order = epoch_order(counts, entries, seed, epoch)
        for d, row in order[shard_index::num_shards]:
            rec = dict(indices[d][row])
            e = entries[d]
            if "image" in rec and e.root:
                rec["image"] = [os.path.join(e.root, p)
                                for p in rec["image"]]
            rec["_dataset"] = e.name
            yield rec
        epoch += 1


def mixture_batches(
    entries: list[MixtureEntry],
    tokenizer: SpatialTokenizer,
    model_cfg: MLLMConfig,
    image_loader: Callable[[str], np.ndarray],
    batch_size: int,
    config: DataConfig | None = None,
    seed: int = 0,
    epochs: int | None = None,
    packed: bool = False,
    shard_index: int = 0,
    num_shards: int = 1,
    device=None,
) -> Iterator[dict]:
    """Batches over the shuffled mixture stream — padded rows by default,
    sequence-packed rows (`segment_ids`/`positions`) with `packed=True`;
    `shard_index/num_shards` stride the stream for multi-host input; the
    tiles are made for a model on `device` (`tile_image`)."""
    it = mixture_samples(entries, seed=seed, epochs=epochs,
                         shard_index=shard_index, num_shards=num_shards)
    make = packed_batch_iterator if packed else batch_iterator
    return make(it, tokenizer, model_cfg, image_loader, batch_size, config,
                device=device)


def validate_mixture(entries: list[MixtureEntry],
                     image_loader: Callable | None = None,
                     sample: int = 200, seed: int = 0) -> dict:
    """Pre-flight check before a long run: every record of every
    dataset is schema-checked (conversations present, roles alternate
    human/gpt starting with human, image placeholder count == image
    list length), and `sample` random records per dataset additionally
    get their image paths opened through `image_loader`. Returns
    {"ok": bool, "issues": [{dataset, row, problem}, ...], "stats":
    mixture_stats(...)}; issue collection caps at 50 per dataset."""
    issues: list[dict] = []

    def add(ds, row, problem):
        if sum(i["dataset"] == ds for i in issues) < 50:
            issues.append({"dataset": ds, "row": int(row),
                           "problem": problem})

    for e in entries:
        ix = jsonl_index(e.annotation)
        if len(ix) == 0:
            add(e.name, -1, "empty annotation file")
            continue
        for row in range(len(ix)):
            try:
                rec = ix[row]
                conv = rec.get("conversations")
                if not isinstance(conv, list) or not conv:
                    add(e.name, row, "missing/empty conversations")
                    continue
                if not all(isinstance(m, dict)
                           and isinstance(m.get("value"), str)
                           for m in conv):
                    add(e.name, row, "non-dict message or non-str value")
                    continue
                roles = [m.get("from") for m in conv]
                want = ["human", "gpt"] * ((len(roles) + 1) // 2)
                if roles != want[: len(roles)] or len(roles) % 2:
                    add(e.name, row, f"bad role sequence {roles}")
                n_ph = sum(m["value"].count("<image>") for m in conv)
                n_img = len(rec.get("image", []))
                if n_ph != n_img:
                    add(e.name, row,
                        f"{n_ph} <image> placeholders vs {n_img} images")
            except Exception as exc:  # malformed line must not kill
                add(e.name, row, f"unparseable: {exc}")
        if image_loader is not None:
            r = stream(seed, "mixture", e.name, "validate")
            rows = r.permutation(len(ix))[:sample]
            for row in rows:
                for p in ix[int(row)].get("image", []):
                    full = os.path.join(e.root, p) if e.root else p
                    try:
                        img = image_loader(full)
                        assert img is not None and img.ndim == 3
                    except Exception as exc:
                        add(e.name, row, f"unreadable image {p}: {exc}")
    return {"ok": not issues, "issues": issues,
            "stats": mixture_stats(entries)}


def mixture_stats(entries: list[MixtureEntry]) -> dict:
    """Per-dataset row counts and effective per-epoch share."""
    counts = {e.name: len(jsonl_index(e.annotation))
              for e in entries}
    per_epoch = {e.name: e.rows_per_epoch(counts[e.name])
                 for e in entries}
    total = sum(per_epoch.values())
    return {"rows": counts, "rows_per_epoch": per_epoch,
            "epoch_size": total,
            "share": {k: (v / total if total else math.nan)
                      for k, v in per_epoch.items()}}
