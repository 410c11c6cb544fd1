"""The traffic generator: MultiSPA-shaped conversations from a seed.

A cell's `params` (data in its workload file) name the bank of real
records (`traffic/<bank>.json`: per engine, human and assistant turns and
the engine's frame count), the frame pool and, for serving, the answer
budgets. Engines come in shuffled rounds, one record each, so every seed
serves the same mix in another order; frames are drawn from the pool.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .tokenizer import BenchTokenizer

HERE = os.path.dirname(os.path.abspath(__file__))


def load_bank(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)["engines"]


def tokenizer(bank: dict) -> BenchTokenizer:
    return BenchTokenizer([r[k] for recs in bank.values() for r in recs
                           for k in ("human", "gpt")])


def records(bank: dict, seed: int, frame_names: list[str], stream: int,
            budgets=None):
    """Endless records `{"id", "conversations", "image"[, "max_new_tokens"]}`
    for `seed`; `stream` keeps independent sequences apart (the window's
    traffic, the warm-up's). `budgets` is a list the answer budgets cycle
    through, shuffled a round at a time."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, stream])
    engines = sorted(bank)
    n = 0
    queue: list = []
    while True:
        for e in rng.permutation(len(engines)):
            rec = bank[engines[e]][rng.integers(len(bank[engines[e]]))]
            image = [frame_names[i] for i in rng.choice(
                len(frame_names), rec["frames"], replace=False)]
            out = {"id": f"r{n}", "engine": engines[e], "image": image,
                   "conversations": [{"from": "human", "value": rec["human"]},
                                     {"from": "gpt", "value": rec["gpt"]}]}
            if budgets:
                if not queue:
                    queue = [budgets[i] for i in rng.permutation(len(budgets))]
                out["max_new_tokens"] = int(queue.pop())
            n += 1
            yield out
