"""Manifest-driven idempotent stage execution.

The reference's resume story is artifact-level and ad-hoc: partial parquet
saves every 20 scenes, skip-if-exists directories, bash-sharded outputs
merged later (SURVEY.md §5.4). Here every stage unit (scene, shard) is
keyed by (stage, unit, config-hash) in a JSON-lines manifest: re-running a
pipeline skips completed units, config changes invalidate them, and
interrupted runs resume at unit granularity with a single writer per
manifest (share-nothing shards, SURVEY.md §5.2).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Iterable

from ..core.io import mkdir_or_exist


def config_hash(config: Any) -> str:
    """Stable hash of an arbitrary JSON-able config (dataclasses allowed)."""
    import dataclasses

    def canon(obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return {f.name: canon(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if isinstance(obj, dict):
            return {str(k): canon(v) for k, v in sorted(obj.items())}
        if isinstance(obj, (list, tuple)):
            return [canon(v) for v in obj]
        if isinstance(obj, (str, int, float, bool)) or obj is None:
            return obj
        return repr(obj)

    payload = json.dumps(canon(config), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class Manifest:
    """Append-only JSONL manifest of completed stage units."""

    def __init__(self, path: str):
        self.path = path
        self._done: dict[tuple[str, str], dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self._done[(rec["stage"], rec["unit"])] = rec

    def is_done(self, stage: str, unit: str, cfg_hash: str) -> bool:
        rec = self._done.get((stage, unit))
        return rec is not None and rec.get("config") == cfg_hash

    def mark_done(self, stage: str, unit: str, cfg_hash: str,
                  outputs: dict | None = None) -> None:
        rec = {"stage": stage, "unit": unit, "config": cfg_hash,
               "outputs": outputs or {}}
        self._done[(stage, unit)] = rec
        mkdir_or_exist(os.path.dirname(self.path))
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def outputs(self, stage: str, unit: str) -> dict:
        rec = self._done.get((stage, unit))
        return rec.get("outputs", {}) if rec else {}

    def run_units(
        self,
        stage: str,
        units: Iterable[str],
        config: Any,
        fn: Callable[[str], dict | None],
        logger=None,
    ) -> list[str]:
        """Run `fn(unit)` for every unit not yet done under this config;
        returns the list of units that actually ran. `fn` may return an
        outputs dict recorded in the manifest."""
        cfg_hash = config_hash(config)
        ran = []
        for unit in units:
            if self.is_done(stage, unit, cfg_hash):
                if logger is not None:
                    logger.count("skipped_cached")
                continue
            outputs = fn(unit)
            self.mark_done(stage, unit, cfg_hash, outputs)
            ran.append(unit)
            if logger is not None:
                logger.count("ran")
        return ran
