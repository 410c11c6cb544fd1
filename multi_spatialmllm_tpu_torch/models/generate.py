"""Greedy, batched, speculative and sampled decoding over the contiguous kv
cache: port of multi_spatialmllm_tpu/models/generate.py.

Prefill runs once over the right-padded prompt (flash attention within the
fresh kv: right padding and causal attention leave the logits at real
positions untouched) and each row's decode then starts at its own prompt
length, overwriting its pad rows. The JAX package runs the decode loop in
one `lax.while_loop`; here it is a host loop of device steps that reads
the eos state back every `EOS_CHECK` steps and then cuts the output where
the JAX loop stops (every row has emitted eos), so the tokens are the
same: a row is finished once any token it emitted is eos, and undecoded
slots hold the fill (eos). Speculative decoding reads its accept counts
back every iteration.

Sampling draws with `models/prng.py`, JAX's threefry streams: the same
keys, splits and Gumbel noise, so sampled tokens equal the JAX package's
except where the top two of `logits + gumbel` lie within a few float32
ulp. Top-p's softmax and cumulative sum are taken in float64 and rounded
to float32 (the JAX package's float32 sums and their order on XLA's CPU
are not reproduced), so the nucleus boundary can move only where the
exclusive cumulative sum lies within float32 rounding of `top_p`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng
from .llm import init_cache
from .mllm import MultiFrameMLLM

EOS_CHECK = 8   # decode steps between reads of the eos state


def pad_to_bucket(ids: np.ndarray, bucket: int, pad_id: int) -> np.ndarray:
    """Right-pad `[B, T]` ids to the next multiple of `bucket`."""
    t = ids.shape[1]
    target = ((t + bucket - 1) // bucket) * bucket
    if target == t:
        return ids
    pad = np.full((ids.shape[0], target - t), pad_id, dtype=ids.dtype)
    return np.concatenate([ids, pad], axis=1)


def model_device(model: MultiFrameMLLM) -> torch.device:
    return model.llm.embed.weight.device


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device).long()


def llm_forward(model: MultiFrameMLLM, tokens: torch.Tensor,
                positions: torch.Tensor, caches: list) -> torch.Tensor:
    """Token ids `[B, t]` at `positions` `[B, t]` through the decoder over
    `caches` (updated in place) -> logits `[B, t, V]`."""
    llm = model.llm
    logits, _ = llm(llm.embed(tokens), positions, caches, inference=True)
    return logits


def decode_logits(model: MultiFrameMLLM, token: torch.Tensor,
                  positions: torch.Tensor, caches: list) -> torch.Tensor:
    """One decode step at per-row positions `[B]`: every layer's cache
    index is set to them, the last tokens `[B, 1]` are embedded, and the
    last-position logits `[B, V]` come back (caches updated in place)."""
    for c in caches:
        c["index"] = positions
    return llm_forward(model, token, positions[:, None], caches)[:, -1]


def decode_step(model: MultiFrameMLLM, token, positions, caches):
    """Greedy `decode_logits`: the next tokens `[B, 1]`."""
    return torch.argmax(decode_logits(model, token, positions, caches),
                        dim=-1, keepdim=True)


@torch.no_grad()
def prefill(model: MultiFrameMLLM, input_ids, tiles, max_len: int):
    """Prompt prefill of right-padded `input_ids` `[B, T]` with `tiles`
    `[B, n, H, W, 3]` into a fresh contiguous cache of `max_len` rows ->
    `(logits [B, T, V], caches)`."""
    dev = model_device(model)
    ids = _long(input_ids, dev)
    caches = init_cache(model.cfg.llm, ids.shape[0], max_len, dev)
    logits, _ = model.prefill(
        ids, torch.as_tensor(np.asarray(tiles, np.float32), device=dev),
        caches)
    return logits, caches


def _finish(out: torch.Tensor, eos_id: int | None) -> torch.Tensor:
    """Cut `out` `[B, n]` where the JAX loop stops: after the step at
    which every row has emitted eos; later slots hold the fill (eos)."""
    if eos_id is None:
        return out
    hit = out == eos_id
    if not bool(hit.any(dim=1).all()):
        return out
    stop = int(hit.int().argmax(dim=1).max()) + 1
    out[:, stop:] = eos_id
    return out


def _decode_loop(step, first: torch.Tensor, positions: torch.Tensor,
                 max_new_tokens: int, eos_id: int | None):
    """`[B, max_new_tokens]` tokens: `first` `[B, 1]` then `step(token,
    positions) -> next token [B, 1]` at per-row positions advancing by
    one, until every row has emitted eos or the budget is spent."""
    b = first.shape[0]
    fill = eos_id if eos_id is not None else 0
    out = torch.full((b, max_new_tokens), fill, dtype=torch.long,
                     device=first.device)
    out[:, 0] = first[:, 0]
    token = first
    for i in range(1, max_new_tokens):
        if eos_id is not None and (i - 1) % EOS_CHECK == 0 \
                and bool((out[:, :i] == eos_id).any(dim=1).all()):
            break
        token = step(token, positions)
        out[:, i] = token[:, 0]
        positions = positions + 1
    return _finish(out, eos_id)


def _first_tokens(logits: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Greedy token at each row's last real position: `[B, 1]`."""
    return torch.gather(torch.argmax(logits, dim=-1), 1, (lens - 1)[:, None])


@torch.no_grad()
def _generate(model, input_ids, tiles, lens, max_new_tokens, eos_id):
    t = np.asarray(input_ids).shape[1]
    logits, caches = prefill(model, input_ids, tiles, t + max_new_tokens)
    lens = _long(lens, logits.device)
    first = _first_tokens(logits, lens)
    return _decode_loop(
        lambda tok, pos: decode_step(model, tok, pos, caches), first, lens,
        int(max_new_tokens), eos_id)


def greedy_generate(model: MultiFrameMLLM, input_ids, tiles,
                    max_new_tokens: int = 32, eos_id: int | None = None,
                    prompt_len: int | None = None) -> torch.Tensor:
    """`[B, T]` prompt -> `[B, max_new_tokens]` generated ids; `prompt_len`
    marks the real length of a padded prompt (shared by all rows)."""
    b, t = np.asarray(input_ids).shape
    real = t if prompt_len is None else int(prompt_len)
    return _generate(model, input_ids, tiles, np.full(b, real),
                     max_new_tokens, eos_id)


def greedy_generate_batched(model: MultiFrameMLLM, input_ids, tiles,
                            prompt_lens, max_new_tokens: int = 32,
                            eos_id: int | None = None) -> torch.Tensor:
    """Batched greedy decoding with per-row prompt lengths `[B]` of a
    right-padded `[B, T]` prompt: each row's cache index starts at its own
    length, so every row's tokens equal `greedy_generate` of it alone."""
    lens = np.asarray(prompt_lens)
    if lens.shape != (np.asarray(input_ids).shape[0],):
        raise ValueError(f"prompt_lens of shape {lens.shape} for "
                         f"{np.asarray(input_ids).shape[0]} rows")
    return _generate(model, input_ids, tiles, lens, max_new_tokens, eos_id)


# -- speculative decoding (prompt-lookup drafts, greedy-exact) --------------


def draft_lookup(hist: torch.Tensor, positions: torch.Tensor, k: int):
    """Prompt-lookup drafting over per-row histories `[B, L]` (-1 =
    unknown): the latest earlier occurrence of the (prev, cur) bigram
    ending at `positions` `[B]`, and the k tokens that followed it.
    Returns (cur `[B]`, draft `[B, k]`; unknown slots draft token 0)."""
    hist_len = hist.shape[1]
    rows = torch.arange(hist.shape[0], device=hist.device)
    # JAX clamps an out-of-range gather (a slot past its budget); -1 wraps
    cur = hist[rows, positions.clamp(max=hist_len - 1)]
    prev = hist[rows, (positions - 1).clamp(max=hist_len - 1)]
    m = (hist[:, :-1] == prev[:, None]) & (hist[:, 1:] == cur[:, None])
    j = torch.arange(hist_len - 1, device=hist.device)
    m &= (j + 1)[None, :] < positions[:, None]
    jbest = torch.where(m, j[None, :], -1).amax(dim=1)
    dpos = jbest[:, None] + 2 + torch.arange(k, device=hist.device)[None, :]
    known = (jbest[:, None] >= 0) & (dpos <= positions[:, None])
    draft = torch.gather(hist, 1, dpos.clamp(0, hist_len - 1))
    return cur, torch.where(known & (draft >= 0), draft, 0)


def accept_chain(draft: torch.Tensor, logits: torch.Tensor):
    """Greedy verification of a drafted chain: the longest prefix where
    the argmax agrees, plus one model token. Returns (cand `[B, k+1]`,
    n_emit `[B]`)."""
    kk = draft.shape[1]
    g = torch.argmax(logits, dim=-1)
    n_acc = torch.cumprod((draft == g[:, :kk]).long(), dim=1).sum(dim=1)
    slot = torch.arange(kk + 1, device=draft.device)[None, :]
    cand = torch.where(slot < n_acc[:, None],
                       torch.cat([draft, draft[:, -1:]], dim=1), g)
    return cand, n_acc + 1


def scatter_drop(dst: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, keep: torch.Tensor) -> None:
    """`dst[rows, cols] = vals` where `keep` and the column is in range,
    in place (JAX's `.at[].set(mode="drop")`): dropped entries rewrite
    their destination's own value."""
    keep = keep & (cols >= 0) & (cols < dst.shape[1])
    cols = torch.where(keep, cols, 0)
    vals = torch.where(keep, vals, dst[rows, cols])
    dst[rows, cols] = vals


@torch.no_grad()
def speculative_generate(model: MultiFrameMLLM, input_ids, tiles,
                         max_new_tokens: int = 32, eos_id: int | None = None,
                         prompt_lens=None, n_draft: int = 4,
                         return_stats: bool = False):
    """Greedy decoding with prompt-lookup speculation: each iteration
    drafts `n_draft` tokens by bigram lookup over the prompt and the
    tokens so far and verifies them in one forward over n_draft + 1
    positions; the tokens equal `greedy_generate_batched`'s. With
    `return_stats` also the number of verify forwards."""
    ids_np = np.asarray(input_ids)
    b, t = ids_np.shape
    lens_np = np.full(b, t) if prompt_lens is None else np.asarray(
        prompt_lens)
    k = int(n_draft)
    max_new = int(max_new_tokens)
    logits, caches = prefill(model, ids_np, tiles, t + max_new + k)
    dev = logits.device
    lens = _long(lens_np, dev)
    first = _first_tokens(logits, lens)
    hist_len = t + max_new + 1
    ids = _long(ids_np, dev)
    hist = torch.full((b, hist_len), -1, dtype=torch.long, device=dev)
    hist[:, :t] = torch.where(torch.arange(t, device=dev)[None, :]
                              < lens[:, None], ids, -1)
    rows = torch.arange(b, device=dev)
    hist[rows, lens] = first[:, 0]
    fill = eos_id if eos_id is not None else 0
    out = torch.full((b, max_new), fill, dtype=torch.long, device=dev)
    out[:, 0] = first[:, 0]
    written = torch.ones(b, dtype=torch.long, device=dev)
    slot = torch.arange(k + 1, device=dev)[None, :]
    iters = 0

    def finished():
        full = written >= max_new
        if eos_id is None:
            return full
        emitted = torch.arange(max_new, device=dev)[None, :] \
            < written[:, None]
        return ((out == eos_id) & emitted).any(dim=1) | full

    while not bool(finished().all()):
        pos_last = lens + written - 1
        cur, draft = draft_lookup(hist, pos_last, k)
        tokens_in = torch.cat([cur[:, None], draft], dim=1)
        for c in caches:
            c["index"] = pos_last
        logits = llm_forward(model, tokens_in, pos_last[:, None] + slot,
                             caches)
        cand, n_acc1 = accept_chain(draft, logits)
        n_emit = torch.minimum(n_acc1, max_new - written)
        emit = slot < n_emit[:, None]
        scatter_drop(out, rows[:, None], written[:, None] + slot, cand, emit)
        scatter_drop(hist, rows[:, None], pos_last[:, None] + 1 + slot,
                     cand, emit)
        written = written + n_emit
        iters += 1
    return (out, iters) if return_stats else out


# -- sampling ----------------------------------------------------------------


def _per_row(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or `[B]` knob as float32, broadcastable along the vocab."""
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return x[:, None] if x.dim() == 1 else x


def mask_logits(logits: torch.Tensor, temperature, top_k: int | None,
                top_p) -> torch.Tensor:
    """`[B, V]` logits -> float32 logits to sample from: temperature
    scaling, then top-k, then top-p on the renormalised distribution with
    the exclusive cumulative sum (1.0 keeps everything); `top_k` None and
    `top_p` None disable theirs. JAX's `_mask_logits`."""
    logits = logits.float()
    logits = logits / torch.clamp(_per_row(temperature, logits), min=1e-6)
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits.double(), dim=-1)
        cum = torch.cumsum(probs, dim=-1).float() - probs.float()
        cutoff_idx = (cum < _per_row(top_p, logits)).sum(
            dim=-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_logits, -1,
                              cutoff_idx % logits.shape[-1])
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def draw(keys: torch.Tensor, logits: torch.Tensor, temperature,
         top_k: int | None, top_p, sampled: bool = True) -> torch.Tensor:
    """Sample `[B]` token ids from `[B, V]` logits: rows with temperature
    0 take the exact argmax of the masked logits. `keys` is one key `[2]`
    (noise over the whole batch) or one per row `[B, 2]`; `temperature`
    and `top_p` are scalars or per-row `[B]`. `sampled=False` (no row
    samples) skips the draw."""
    masked = mask_logits(logits, temperature, top_k, top_p)
    greedy = torch.argmax(masked, dim=-1)
    if not sampled:
        return greedy
    drawn = prng.categorical(keys, masked)
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=logits.device)
    return torch.where(temp > 0, drawn, greedy)


@torch.no_grad()
def sample_generate(model: MultiFrameMLLM, input_ids, tiles,
                    key: torch.Tensor, max_new_tokens: int = 32,
                    eos_id: int | None = None, prompt_lens=None,
                    temperature: float = 1.0, top_k: int | None = None,
                    top_p: float | None = None) -> torch.Tensor:
    """Sampled decoding with temperature and optional top-k / top-p, drawn
    from `key` (`prng.key(seed)`) split once a step as the JAX package
    splits its key; temperature 0 is exact greedy. `prompt_lens` as in
    `greedy_generate_batched`."""
    ids_np = np.asarray(input_ids)
    b, t = ids_np.shape
    lens_np = np.full(b, t) if prompt_lens is None else np.asarray(
        prompt_lens)
    logits, caches = prefill(model, ids_np, tiles, t + max_new_tokens)
    dev = logits.device
    lens = _long(lens_np, dev)
    first_logits = logits[torch.arange(b, device=dev), lens - 1]
    key = torch.as_tensor(key, device=dev).long()
    state = {"key": key}
    sampled = float(temperature) > 0

    def next_token(lg):
        key, sub = prng.split(state["key"])
        state["key"] = key
        return draw(sub, lg, temperature, top_k, top_p, sampled)[:, None]

    first = next_token(first_logits)
    return _decode_loop(
        lambda tok, pos: next_token(decode_logits(model, tok, pos, caches)),
        first, lens, int(max_new_tokens), eos_id)
