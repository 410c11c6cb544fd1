"""Structured logging + per-stage counters.

Replaces the reference's print/tqdm/warning-file observability (SURVEY.md
§5.5) with one structured logger: JSON-line events to a sink file plus
human-readable stderr, and named counters (samples emitted / skipped per
reason) that every stage and engine can report.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from typing import Any


class StageLogger:
    """Event log + counters for one pipeline stage run."""

    def __init__(self, stage: str, sink_path: str | None = None,
                 echo: bool = True):
        self.stage = stage
        self.sink_path = sink_path
        self.echo = echo
        self.counters: collections.Counter = collections.Counter()
        self._t0 = time.perf_counter()

    def event(self, kind: str, **fields: Any) -> None:
        record = {"stage": self.stage, "kind": kind,
                  "t": round(time.perf_counter() - self._t0, 3), **fields}
        line = json.dumps(record)
        if self.sink_path:
            with open(self.sink_path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(f"[{self.stage}] {kind} "
                  + " ".join(f"{k}={v}" for k, v in fields.items()),
                  file=sys.stderr)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def summary(self) -> dict:
        out = {
            "stage": self.stage,
            "elapsed_s": round(time.perf_counter() - self._t0, 3),
            "counters": dict(self.counters),
        }
        self.event("summary", **out["counters"],
                   elapsed_s=out["elapsed_s"])
        return out
