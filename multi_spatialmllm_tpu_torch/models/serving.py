"""Continuous batching over a fixed pool of decode slots with contiguous
kv caches: port of multi_spatialmllm_tpu/models/serving.py.

Each request is prefilled alone (B=1, any tile count and prompt length)
and its kv rows are copied into a free slot of the batch cache; decoding
then runs in chunks of `chunk` steps over every slot at per-slot
positions, the tokens read back once a chunk, and a slot is refilled the
moment its request finishes. Greedy outputs equal `greedy_generate` per
request.

Per-request sampling (`ServeConfig(sampling=True)` and a `SamplingParams`
a request) draws each token with the key `fold_in(key(seed), position)`,
the request's seed folded with the absolute position of the logits row
(`models/prng.py` reproduces JAX's threefry streams), so a stream does not
depend on slot, chunk boundaries, batch composition or preemption, and is
the JAX package's stream from the same logits. Temperature 0 rows take
the exact argmax. `speculate=n` verifies prompt-lookup drafts of n tokens
in one forward (greedy-exact); `logprobs` records each emitted token's
float32 log-probability under the raw logits.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..utils.profiling import span
from . import prng
from .generate import (
    accept_chain,
    decode_logits,
    draft_lookup,
    draw,
    llm_forward,
    model_device,
    pad_to_bucket,
    scatter_drop,
)
from .llm import init_cache
from .mllm import MultiFrameMLLM


@dataclasses.dataclass
class ServeConfig:
    slots: int = 4                 # concurrent decode rows
    max_prompt_len: int = 512      # prompts padded up to this bucket
    max_new_tokens: int = 32
    chunk: int = 8                 # decode steps per host read
    length_bucket: int = 128       # prefill shape bucketing
    sampling: bool = False         # enable per-request SamplingParams
    top_k: int | None = None       # static top-k when sampling
    speculate: int = 0             # >0: prompt-lookup drafts a verify
    logprobs: bool = False         # record emitted tokens' logprobs


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode knobs (`sampling=True` in the batcher's config).

    temperature 0 (the default) is exact greedy; `seed` names the
    request's draw stream, `fold_in(key(seed), position)` a token, the
    JAX package's stream (models/prng.py)."""
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0


def row_keys(seed: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One key a row `[B, 2]`: the row's seed (int32, as the batchers hold
    them) folded with the absolute position of the logits row sampled."""
    return prng.fold_in(prng.key(seed.to(torch.int32)), positions)


def token_logprob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """float32 log-softmax of `logits` `[B, V]` at `token` `[B, 1]` -> `[B]`:
    the emitted token's probability before temperature and top-p."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, token.long())[..., 0]


def next_tokens(logits: torch.Tensor, positions: torch.Tensor, samp):
    """The tokens `[B, 1]` drawn from last-position logits `[B, V]`: the
    argmax, or with `samp` (temperature, top_p, seed `[B]` tensors, top_k,
    any row sampling) the keyed draw at `positions`."""
    if samp is None:
        return torch.argmax(logits, dim=-1, keepdim=True)
    temperature, top_p, seed, top_k, any_sampled = samp
    keys = row_keys(seed, positions) if any_sampled else None
    return draw(keys, logits, temperature, top_k, top_p,
                any_sampled)[:, None]


def sampling_state(cfg, temperature, top_p, seed, device):
    """`next_tokens`'s `samp` for per-slot knobs (host arrays), or None
    when the config does not sample."""
    if not cfg.sampling:
        return None
    return (torch.as_tensor(temperature, device=device),
            torch.as_tensor(top_p, device=device),
            torch.as_tensor(seed, device=device), cfg.top_k,
            bool((np.asarray(temperature) > 0).any()))


@torch.no_grad()
def prefill_one(model: MultiFrameMLLM, ids: np.ndarray, tiles: np.ndarray,
                true_len: int, samp=None, logprobs: bool = False,
                lora: dict | None = None):
    """B=1 prefill of a bucketed prompt `ids` `[1, T]` with tiles
    `[1, n, H, W, 3]` -> `(first token, its logprob or None, kv rows per
    layer)`, each kv row pair `[1, KVH, T, hd]`; `samp` as `next_tokens`
    takes it, for one row; `lora` the row's serving adapters."""
    device = model_device(model)
    logits, kvs = model.prefill(
        torch.as_tensor(ids, dtype=torch.long, device=device),
        torch.as_tensor(tiles, dtype=torch.float32, device=device),
        lora=lora)
    last = logits[:, true_len - 1]
    pos = torch.full((1,), true_len - 1, dtype=torch.long, device=device)
    first = next_tokens(last, pos, samp)
    lp = float(token_logprob(last, first)[0]) if logprobs else None
    return int(first[0, 0]), lp, kvs


@torch.no_grad()
def decode_chunk(step_logits, last_token: torch.Tensor,
                 positions: torch.Tensor, chunk: int, samp=None,
                 logprobs: bool = False):
    """`chunk` decode steps for every slot: `step_logits(token, positions)
    -> [B, V]` runs one forward. Returns device tensors `(tokens [B,
    chunk], logprobs [B, chunk] or None, last token [B, 1], positions)`."""
    token, toks, lps = last_token, [], []
    for _ in range(chunk):
        logits = step_logits(token, positions)
        token = next_tokens(logits, positions, samp)
        toks.append(token[:, 0])
        if logprobs:
            lps.append(token_logprob(logits, token))
        positions = positions + 1
    return (torch.stack(toks, dim=1),
            torch.stack(lps, dim=1) if logprobs else None, token, positions)


@torch.no_grad()
def spec_chunk(verify_logits, positions: torch.Tensor, hist: torch.Tensor,
               chunk: int, n_draft: int):
    """`chunk` speculative iterations for every slot: each drafts
    `n_draft` tokens by bigram lookup over the slot's history `[B, L]`,
    verifies them with `verify_logits(tokens [B, k+1], positions [B])`,
    and emits 1..n_draft+1 tokens. Returns device tensors (cands `[B,
    chunk, k+1]`, counts `[B, chunk]`, positions); `hist` is updated in
    place. Idle slots draft from -1 rows (clipped to token 0)."""
    k = n_draft
    rows = torch.arange(hist.shape[0], device=hist.device)[:, None]
    slot = torch.arange(k + 1, device=hist.device)[None, :]
    cands, counts = [], []
    for _ in range(chunk):
        cur, draft = draft_lookup(hist, positions, k)
        tokens_in = torch.cat([cur[:, None], draft], dim=1).clamp(min=0)
        cand, n_emit = accept_chain(draft, verify_logits(tokens_in,
                                                         positions))
        scatter_drop(hist, rows, positions[:, None] + 1 + slot, cand,
                     slot < n_emit[:, None])
        positions = positions + n_emit
        cands.append(cand)
        counts.append(n_emit)
    return torch.stack(cands, dim=1), torch.stack(counts, dim=1), positions


@torch.no_grad()
def dispatch(batcher, step_logits, verify_logits):
    """One decode dispatch over every slot of `batcher` (a
    `ContinuousBatcher` or `PagedBatcher`: its `config`, `device` and the
    host arrays `positions`, `last_token`, `temperature`, `top_p`, `seed`
    and `hist`, which it advances): `chunk` speculative iterations through
    `verify_logits` (as `spec_chunk` takes it), or `chunk` decode steps
    through `step_logits` (as `decode_chunk` takes it). Returns (per slot,
    per step, the emitted tokens; logprobs `[B, chunk]` or None)."""
    b, cfg, dev = batcher, batcher.config, batcher.device
    dtype = b.positions.dtype
    positions = torch.as_tensor(b.positions, device=dev)
    if cfg.speculate:
        hist = torch.as_tensor(b.hist, device=dev)
        with span("msm.serve.decode_launch"):
            cands, counts, positions = spec_chunk(
                verify_logits, positions.long(), hist, cfg.chunk,
                cfg.speculate)
        with span("msm.serve.decode_read"):
            cands, counts = cands.cpu().numpy(), counts.cpu().numpy()
            b.hist = hist.cpu().numpy()
            b.positions = positions.cpu().numpy().astype(dtype)
        return [[list(cands[s, i, :counts[s, i]])
                 for i in range(cfg.chunk)]
                for s in range(cfg.slots)], None
    with span("msm.serve.decode_launch"):
        toks, lps, last, positions = decode_chunk(
            step_logits, torch.as_tensor(b.last_token, device=dev),
            positions, cfg.chunk,
            sampling_state(cfg, b.temperature, b.top_p, b.seed, dev),
            cfg.logprobs)
    with span("msm.serve.decode_read"):
        toks = toks.cpu().numpy()           # the chunk's one host read
        b.last_token = last.cpu().numpy()
        b.positions = positions.cpu().numpy().astype(dtype)
        lps = None if lps is None else lps.cpu().numpy()
    return [[[t] for t in row] for row in toks], lps


def unpack_request(request, max_new_tokens: int, allow_adapter=False):
    """(ids, tiles[, SamplingParams][, max_new_tokens int][, adapter str,
    with `allow_adapter`]) in any trailing order -> (ids, tiles, adapter,
    sp, max_new)."""
    ids, tiles, adapter, sp, max_new = (request[0], request[1], None, None,
                                        None)
    for extra in request[2:]:
        if isinstance(extra, SamplingParams):
            sp = extra
        elif isinstance(extra, str) and allow_adapter:
            adapter = extra
        elif isinstance(extra, int) and not isinstance(extra, bool):
            if not 1 <= extra <= max_new_tokens:
                raise ValueError(
                    f"per-request max_new_tokens {extra} outside "
                    f"1..{max_new_tokens} (the config's max_new_tokens is "
                    f"the cap)")
            max_new = extra
        else:
            raise TypeError(
                f"request extras must be "
                f"{'an adapter name (str), ' if allow_adapter else ''}"
                f"SamplingParams or a max_new_tokens int, got "
                f"{type(extra).__name__}")
    return ids, tiles, adapter, sp or SamplingParams(), max_new


class ContinuousBatcher:
    """Serving over a fixed pool of decode slots with contiguous caches
    (greedy by default; per-request sampling with `sampling=True`;
    greedy-exact speculation with `speculate=n`)."""

    def __init__(self, model: MultiFrameMLLM,
                 config: ServeConfig | None = None, pad_id: int = 0,
                 eos_id: int = 2, stop_ids: tuple = ()):
        """`stop_ids`: extra token ids that end a request as eos does (the
        first stop wins, excluded from the output)."""
        self.model = model
        self.config = config or ServeConfig()
        self.pad_id = pad_id
        self.eos_id = eos_id
        self.stop_ids = frozenset({int(eos_id), *map(int, stop_ids)})
        cfg = self.config
        if cfg.speculate and cfg.sampling:
            raise ValueError("speculative decoding is greedy-exact; "
                             "disable sampling")
        if cfg.speculate and cfg.logprobs:
            raise ValueError("logprobs are not recorded on the speculative "
                             "path")
        self.device = model_device(model)
        self.request_logprobs: dict[int, list[float]] = {}
        # a slot one token from its budget still runs a whole verify chain
        self.max_len = cfg.max_prompt_len + cfg.max_new_tokens \
            + (cfg.speculate + 1 if cfg.speculate else 0)
        self.caches = init_cache(model.cfg.llm, cfg.slots, self.max_len,
                                 self.device, model.llm.kv_heads)
        self.positions = np.zeros(cfg.slots, dtype=np.int64)
        self.last_token = np.zeros((cfg.slots, 1), dtype=np.int64)
        self.temperature = np.zeros(cfg.slots, dtype=np.float32)
        self.top_p = np.ones(cfg.slots, dtype=np.float32)
        self.seed = np.zeros(cfg.slots, dtype=np.int32)
        self.hist_len = cfg.max_prompt_len + cfg.max_new_tokens + 1
        self.hist = np.full((cfg.slots, self.hist_len), -1, np.int64)
        self.stats = {"prefill_full": 0, "prefill_seconds": 0.0,
                      "decode_seconds": 0.0, "decode_dispatches": 0,
                      "decode_tokens": 0, "spec_verifies": 0}

    def _unpack(self, request):
        ids, tiles, _, sp, max_new = unpack_request(
            request, self.config.max_new_tokens)
        return ids, tiles, sp, max_new

    def _samp(self, temperature, top_p, seed):
        return sampling_state(self.config, temperature, top_p, seed,
                              self.device)

    @torch.no_grad()
    def _prefill_into(self, slot: int, prompt_ids: np.ndarray, tiles,
                      sp: SamplingParams):
        cfg = self.config
        if not cfg.sampling and sp.temperature != 0.0:
            raise ValueError("pass ServeConfig(sampling=True) to use "
                             "SamplingParams")
        ids = pad_to_bucket(np.asarray(prompt_ids)[None], cfg.length_bucket,
                            self.pad_id)
        t = ids.shape[1]
        if t > cfg.max_prompt_len:
            raise ValueError(f"prompt of {t} tokens (bucketed) exceeds "
                             f"max_prompt_len {cfg.max_prompt_len}")
        true_len = len(prompt_ids)
        t0 = time.perf_counter()
        first, lp, kvs = prefill_one(
            self.model, ids, np.asarray(tiles)[None], true_len,
            self._samp([sp.temperature], [sp.top_p],
                       np.asarray([sp.seed], np.int32)), cfg.logprobs)
        for c, (k, v) in zip(self.caches, kvs):
            c["k"][slot, :, :t] = k[0]
            c["v"][slot, :, :t] = v[0]
        self.stats["prefill_full"] += 1
        self.stats["prefill_seconds"] += time.perf_counter() - t0
        self.positions[slot] = true_len
        self.last_token[slot, 0] = first
        self.temperature[slot] = sp.temperature
        self.top_p[slot] = sp.top_p
        self.seed[slot] = sp.seed
        if cfg.speculate:
            self.hist[slot, :] = -1
            self.hist[slot, :true_len] = prompt_ids
            self.hist[slot, true_len] = first
        return first, lp

    def _decode(self):
        """One dispatch over every slot (`dispatch`)."""
        def verify(tokens, pos):
            for c in self.caches:
                c["index"] = pos
            slot = torch.arange(tokens.shape[1], device=self.device)
            return llm_forward(self.model, tokens,
                               pos[:, None] + slot[None, :], self.caches)

        return dispatch(self, lambda tok, pos: decode_logits(
            self.model, tok, pos, self.caches), verify)

    def generate_all(self, requests) -> list[np.ndarray]:
        """requests: iterable of (prompt_ids int32 [T], tiles [n,H,W,3])
        plus an optional `SamplingParams` and/or a per-request
        max_new_tokens int (<= the config's cap, the default). Returns the
        generated token arrays (cut at the first stop id), in order; with
        `logprobs`, `request_logprobs[rid]` aligned with them."""
        cfg = self.config
        queue = list(enumerate(requests))
        results: dict[int, list[int]] = {}
        lprobs: dict[int, list] = {}
        budgets: dict[int, int] = {}
        self.request_logprobs = {}
        slot_req = [-1] * cfg.slots

        def finished(rid):
            toks = results[rid]
            return (len(toks) >= budgets[rid]
                    or (toks and toks[-1] in self.stop_ids))

        while queue or any(r >= 0 for r in slot_req):
            for slot in range(cfg.slots):
                if slot_req[slot] < 0 and queue:
                    rid, request = queue.pop(0)
                    ids, tiles, sp, max_new = self._unpack(request)
                    budgets[rid] = max_new or cfg.max_new_tokens
                    first, first_lp = self._prefill_into(slot, ids, tiles,
                                                         sp)
                    slot_req[slot] = rid
                    results[rid] = [first]
                    lprobs[rid] = [first_lp]
                    if finished(rid):
                        slot_req[slot] = -1
            if not any(r >= 0 for r in slot_req):
                continue
            t0 = time.perf_counter()
            steps, lps = self._decode()
            self.stats["decode_seconds"] += time.perf_counter() - t0
            self.stats["decode_dispatches"] += 1
            for slot in range(cfg.slots):
                rid = slot_req[slot]
                if rid < 0:
                    continue
                for i, emitted in enumerate(steps[slot]):
                    if finished(rid):
                        break
                    self.stats["spec_verifies"] += bool(cfg.speculate)
                    for tok in emitted:
                        if finished(rid):
                            break
                        results[rid].append(int(tok))
                        self.stats["decode_tokens"] += 1
                        if lps is not None:
                            lprobs[rid].append(float(lps[slot, i]))
                if finished(rid):
                    slot_req[slot] = -1    # refilled next loop turn

        out = []
        for rid in sorted(results):
            toks = results[rid]
            n = next((i for i, t in enumerate(toks) if t in self.stop_ids),
                     len(toks))
            if cfg.logprobs:
                self.request_logprobs[rid] = lprobs[rid][:n]
            out.append(np.asarray(toks[:n], dtype=np.int32))
        return out
