"""The comparisons that decide `correct`, against the plain reference.

Training: the reference replays the first `check_steps` steps from the
seed (the same weights drawn again, the same conversations and frame
files worked into rows by `reference/data.py`) and compares, by the worst
leaf, each step's loss, the first gradient's norm (the program's read
from AdamW's first moment after step 1) and the change of the weights
after the last check step.

Serving: for a sample of the answered requests drawn from the seed, the
longest among them, the reference runs the prompt with the served tokens
and reads the widest gap by which a served token's logit lies below its
best logit.

The limits are data in the cell's workload file (`limits`).
"""

from __future__ import annotations

import os
import statistics

import numpy as np

from .. import frames, mix, model
from ..harness import Check
from . import data as RD
from . import model as RM


def frame_tiles(root: str, names, d: dict) -> list:
    """Each frame's reference tiles, read from its file."""
    return [RD.tile(frames.read_jpeg(os.path.join(root, n)), d["max_tiles"],
                    d["image"]) for n in names]


def reference_rows(ctx, bank, tok, root, names, n_rows: int) -> list[dict]:
    """The first `n_rows` packed rows of the cell's stream, as tensors."""
    import torch

    p, d = ctx.spec["params"], ctx.dims
    cache: dict = {}

    def encoded():
        for rec in mix.records(bank, ctx.seed, names, stream=0):
            tiles = []
            for n in rec["image"]:
                if n not in cache:
                    cache[n] = frame_tiles(root, [n], d)[0]
                tiles.append(cache[n])
            ids, labels = RD.encode(rec, tok, d["tokens_per_tile"],
                                    [len(t) for t in tiles])
            yield ids, labels, np.concatenate(tiles)

    rows = []
    for row in RD.pack(encoded(), p["seq_len"], p["row_tiles"]):
        rows.append({k: (torch.as_tensor(v, device=ctx.device)
                         if isinstance(v, np.ndarray) else v)
                     for k, v in row.items()})
        if len(rows) == n_rows:
            return rows
    raise ValueError("the stream ended")


def replay(w: dict, d: dict, rows: list, tr: dict, batch: int, steps: int,
           img_id: int, dtype=None):
    """`steps` training steps of the reference over `rows` -> (losses,
    each leaf's clipped first gradient norm). `w` is updated in place."""
    import torch

    ref = RM.Reference(w, d, dtype or torch.float32)
    opt = RM.AdamW(w, tr)
    losses, grad1 = [], None
    for s in range(steps):
        chunk = rows[s * batch:(s + 1) * batch]
        denom = sum(int((r["labels"][1:] != -100).sum()) for r in chunk)
        total = 0.0
        for r in chunk:
            nll, _ = RM.row_nll(ref, r, img_id)
            (nll / denom).backward()
            total += float(nll.detach())
        losses.append(total / denom)
        clipped = opt.step({k: v.grad for k, v in w.items()})
        if s == 0:
            grad1 = {k: float(g.double().norm()) for k, g in clipped.items()}
        for v in w.values():
            v.grad = None
    return losses, grad1


def changes(w: dict, cfg: dict, seed: int) -> dict:
    import torch

    out = {}

    def sink(name, t0):
        out[name] = float((w[name].detach().double()
                           - t0.to(w[name].dtype).double()).norm())

    model.draw_weights(model.weight_spec(cfg), seed,
                       next(iter(w.values())).device, torch.float32, sink)
    return out


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in names)


def train_readings(ctx, bank, tok, root, names, n_check: int,
                   dtype=None) -> dict:
    """The reference's (or, with a lower `dtype`, the control's) losses,
    first gradient norms and weight changes over the first steps."""
    import torch

    RM.strict_float32()
    p, d, cfg = ctx.spec["params"], ctx.dims, ctx.cfg
    rows = reference_rows(ctx, bank, tok, root, names, n_check * p["batch"])
    w = model.draw_weights(model.weight_spec(cfg), ctx.seed, ctx.device,
                           dtype or torch.float32)
    for v in w.values():
        v.requires_grad_(True)
    losses, grad1 = replay(w, d, rows, cfg["train"], p["batch"], n_check,
                           tok.img_context_id, dtype)
    return {"losses": losses, "grad": grad1,
            "change": changes(w, cfg, ctx.seed)}


def train_compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst leaf's first-gradient gap and
    weight-change gap; each step's relative loss gap is reported beside
    them (no control or fault separates it from sound runs: PERF.md).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone under AdamW and are left out of the
    change."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    grad, grad_leaf = leaf_gap(prog["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    keep = {k for k, g in ref["grad"].items() if g >= 1e-3 * med}
    change, change_leaf = leaf_gap(prog["change"], ref["change"], keep)
    return {"loss_gaps": losses, "grad_gap": grad, "change_gap": change,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(ref["grad"]) - keep)}


def train(ctx, bank, tok, root, names, losses, seen, n_check) -> Check:
    import sys

    ref = train_readings(ctx, bank, tok, root, names, n_check)
    got = train_compare({"losses": losses, **seen}, ref)
    print(f"train check: losses {losses} reference {ref['losses']} (gaps "
          f"{got['loss_gaps']}); worst "
          f"leaves {got['grad_leaf']} (gradient), {got['change_leaf']} "
          f"(change); left out of the change: {got['left_out']}",
          file=sys.stderr)
    ctx.counters["check"] = got
    lim = ctx.spec["limits"]
    check = Check()
    for k in ("grad_gap", "change_gap"):
        check.at_most(k, got[k], lim[k])
    return check


def reference_logits(ctx, tok, root, requests: list[dict],
                     tokens: dict) -> dict:
    """For each request (a record with `id`, `image`, `conversations`),
    the reference's logits `[n, vocab]` (on the host) at the positions that
    predict its `tokens[id]`, over the prompt the reference builds itself
    followed by those tokens."""
    import torch

    from ..tokenizer import ASSISTANT, HUMAN, IMG_CONTEXT, IMG_END, IMG_START

    RM.strict_float32()
    d, cfg = ctx.dims, ctx.cfg
    w = model.draw_weights(model.weight_spec(cfg), ctx.seed, ctx.device,
                           torch.float32)
    held = getattr(torch, cfg["serve"]["param_dtype"])
    for k in w:                 # the served weights' dtype; norms float32
        if "norm" not in k:
            w[k] = w[k].to(held).to(torch.float32)
    ref = RM.Reference(w, d)
    out = {}
    with torch.no_grad():
        for rec in requests:
            served = list(tokens[rec["id"]])
            tiles = frame_tiles(root, rec["image"], d)
            text = rec["conversations"][0]["value"]
            for t in tiles:
                block = IMG_START + IMG_CONTEXT * (d["tokens_per_tile"]
                                                   * len(t)) + IMG_END
                text = text.replace("<image>", block, 1)
            prompt = [tok.bos_id] + tok.encode(HUMAN + text + ASSISTANT)
            seq = torch.as_tensor(prompt + served, device=ctx.device)
            vis = ref.encode_tiles(torch.as_tensor(np.concatenate(tiles),
                                                   device=ctx.device))
            h = ref.hidden(seq, vis, torch.arange(len(seq), device=ctx.device),
                           [(0, len(seq))], tok.img_context_id)
            out[rec["id"]] = ref.logits(h[len(prompt) - 1:-1]).cpu()
    return out


def gaps(logits, toks) -> list[float]:
    """Best logit minus the logit of each token, position by position."""
    import torch

    t = torch.as_tensor(list(toks), dtype=torch.long)[:, None]
    return (logits.max(1).values - logits.gather(1, t)[:, 0]).tolist()


def sample_requests(ctx, loop, n: int) -> list[str]:
    """`n` answered request ids: the longest (prompt words and served
    tokens) and the rest drawn from the seed."""
    done = sorted(r for r in loop.done if r not in loop.errors
                  and loop.tokens[r])
    if not done:
        return []
    longest = max(done, key=lambda r: (len(loop.recs[r]["image"]),
                                       len(loop.tokens[r]), r))
    rest = [r for r in done if r != longest]
    rng = np.random.default_rng([int(ctx.seed) % 2 ** 63, 2])
    pick = rng.choice(len(rest), min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def serve(ctx, bank, tok, root, loop) -> Check:
    """The mean gap over the sampled requests' served tokens is compared
    (the widest gap is reported beside it: it does not separate the
    control from sound runs, see PERF.md)."""
    import sys

    ids = sample_requests(ctx, loop, ctx.spec["params"]["check_requests"])
    logits = reference_logits(ctx, tok, root, [loop.recs[r] for r in ids],
                              loop.tokens)
    flat = [g for r in ids for g in gaps(logits[r], loop.tokens[r])]
    read = gap_stats(flat)
    print(f"serve check: {len(ids)} requests, {len(flat)} served tokens, "
          f"mean gap {read['mean']}, widest {read['widest']}, "
          f"{read['agree']} of the tokens the reference's best",
          file=sys.stderr)
    ctx.counters["check"] = {"requests": ids, **read}
    check = Check()
    check.at_most("mean_logit_gap", read["mean"],
                  ctx.spec["limits"]["mean_logit_gap"])
    return check


def gap_stats(flat: list[float]) -> dict:
    """The mean and widest gap, and the share of tokens at gap 0."""
    if not flat:
        return {"mean": float("inf"), "widest": float("inf"), "agree": 0.0,
                "tokens": 0}
    return {"mean": sum(flat) / len(flat), "widest": max(flat),
            "agree": sum(g <= 0 for g in flat) / len(flat),
            "tokens": len(flat)}
