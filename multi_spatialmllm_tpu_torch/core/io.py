"""Small host-side IO utilities (replaces the reference's mmengine usage).

Covers: pickle/json/jsonl/parquet round-trips, directory creation, a timing
context, and an append-only warning sink matching the reference's
`*warning*.txt` convention (SURVEY.md §4.3).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from contextlib import contextmanager
from typing import Any, Iterable, Iterator


def mkdir_or_exist(path: str) -> None:
    if path:
        os.makedirs(path, exist_ok=True)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_pickle(obj: Any, path: str) -> None:
    mkdir_or_exist(os.path.dirname(path))
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def write_jsonl(records: Iterable[dict], path: str) -> int:
    """Write records as one JSON object per line; returns the count."""
    mkdir_or_exist(os.path.dirname(path))
    n = 0
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def write_parquet(df, path: str) -> None:
    mkdir_or_exist(os.path.dirname(path))
    df.to_parquet(path, index=False)


class WarningSink:
    """Append-only warning file, mirroring the reference's skip-and-log
    error handling (e.g. make_visibility_info.py:111-113)."""

    def __init__(self, path: str | None):
        self.path = path
        self.count = 0
        if path:
            mkdir_or_exist(os.path.dirname(path))

    def __call__(self, message: str) -> None:
        self.count += 1
        if self.path:
            with open(self.path, "a") as f:
                f.write(message.rstrip("\n") + "\n")


@contextmanager
def timer(tag: str, sink: list | None = None):
    """Wall-clock timing context; appends (tag, seconds) to `sink`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink.append((tag, dt))
