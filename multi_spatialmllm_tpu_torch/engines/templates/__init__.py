"""Template banks for all QA engines.

The reference ships hand-written banks (30 question templates per type, 10
task descriptions, 10-30 answer templates — camera_movement/TEMPLATES.py and
per-engine in-file banks). These banks are *original text* with the same
placeholder variables, the same bank sizes, and the same information content
(coordinate-convention prose, unit statements, definitions); several banks
are produced by composing phrase fragments, which keeps them diverse and
auditable. Label parity depends only on the placeholder values, not the
surrounding prose (BASELINE.md: schema/label parity bar).
"""

from __future__ import annotations

import itertools


def expand(*fragment_groups: list[str], limit: int | None = None,
           joiner: str = " ") -> list[str]:
    """Cartesian composition of phrase fragments into a template bank.

    Fragments are joined with `joiner`; empty fragments are skipped. The
    product is truncated to `limit` in a round-robin order so early entries
    vary in every slot.
    """
    combos = list(itertools.product(*fragment_groups))
    # Reorder so consecutive entries differ in the *first* varying slot.
    combos.sort(key=lambda parts: tuple(
        fragment_groups[i].index(p) for i, p in enumerate(parts)
    ))
    templates = []
    seen = set()
    # round-robin: interleave by sum of indices for variety
    combos = sorted(
        combos,
        key=lambda parts: (
            sum(fragment_groups[i].index(p) for i, p in enumerate(parts)),
            tuple(fragment_groups[i].index(p) for i, p in enumerate(parts)),
        ),
    )
    for parts in combos:
        text = joiner.join(p for p in parts if p)
        if text not in seen:
            seen.add(text)
            templates.append(text)
        if limit is not None and len(templates) >= limit:
            break
    return templates
