"""Paged KV cache + paged continuous batching in PyTorch.

Port of multi_spatialmllm_tpu/models/paged_kv.py for the greedy,
one-shot-prefill path: a device page pool shared by all decode slots, in
the model dtype or int8 with per-row float32 scales (`kv_dtype`), a
host-side page allocator, per-request B=1 prefill whose kv rows are
scattered (quantised, for int8 pools) into whole pages, and decode in
chunks of `chunk` steps over every slot through the paged decode op (the
CUDA kernel on the card), with the tokens read back to the host once per
chunk. When the pool runs dry a refill is deferred and, if a running slot
cannot extend, it is preempted (pages freed, request re-queued and
replayed from prefill; greedy decoding reproduces its tokens).

Key invariants (as in the JAX package):
* Page 0 is a SINK page, never allocated: freed/idle slots' table rows
  point at it, so their discarded decode writes cannot corrupt pages
  re-allocated to another slot.
* Idle slots' positions are re-zeroed after every dispatch, so the
  kernel never indexes past a table row.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ops.paged_attention import quantize_kv_rows
from .generate import pad_to_bucket
from .llm import DTYPES, LLMConfig
from .mllm import MLLMConfig, MultiFrameMLLM
from .serving import SamplingParams, prefill_one

KV_DTYPES = ("native", "int8")
# PagedConfig options of the JAX package ported only at their defaults
_NOT_PORTED = {
    "prefill_chunk": ("chunked prefill", "queue 1, item 15"),
    "vision_cache": ("the vision-feature cache", "queue 1, item 15"),
    "speculate": ("speculative decoding", "queue 1, item 15"),
    "prefix_cache": ("the prefix cache", "queue 1, item 15"),
    "sampling": ("sampling", "queue 1, item 15"),
    "logprobs": ("logprobs", "queue 1, item 15"),
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to multi_spatialmllm_tpu_torch yet "
        f"(ROADMAP, {item})")


@dataclasses.dataclass
class PagedConfig:
    slots: int = 4                 # concurrent decode rows
    page_size: int = 64            # kv rows per page
    num_pages: int = 64            # pool size (page 0 is the sink)
    max_prompt_len: int = 512
    max_new_tokens: int = 32
    chunk: int = 8                 # decode steps per host round trip
    length_bucket: int = 128       # prefill shape bucketing
    kv_dtype: str = "native"       # "int8": int8 pools + per-row scales
    # The JAX package's further options; only their defaults are ported.
    prefill_chunk: int = 0
    vision_cache: int = 0
    speculate: int = 0
    prefix_cache: bool = False
    sampling: bool = False
    logprobs: bool = False

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in "
                             f"{KV_DTYPES}")
        for field in dataclasses.fields(self):
            if field.name in _NOT_PORTED \
                    and getattr(self, field.name) != field.default:
                raise _not_ported(*_NOT_PORTED[field.name])

    @property
    def max_len(self) -> int:
        return self.max_prompt_len + self.max_new_tokens

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_len // self.page_size)


class PageAllocator:
    """Host-side free list over pages 1..num_pages-1 (0 is the sink);
    allocation is all-or-nothing."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n pages, or None."""
        if n < 0 or len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, pages) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} is not an allocatable page")
            self._free.append(p)


def init_paged_pools(cfg: LLMConfig, pcfg: PagedConfig, device) -> list:
    """Per-layer page pools `[num_pages, kv_heads, page_size, head_dim]`
    in the model dtype, or int8 with float32 scale pools
    `[num_pages, kv_heads, page_size]` (`k_scale`, `v_scale`) when
    `pcfg.kv_dtype == "int8"`."""
    shape = (pcfg.num_pages, cfg.num_kv_heads, pcfg.page_size, cfg.head_dim)
    quant = pcfg.kv_dtype == "int8"
    dtype = torch.int8 if quant else DTYPES[cfg.dtype]
    pools = []
    for _ in range(cfg.num_layers):
        pool = {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
        if quant:
            for key in ("k_scale", "v_scale"):
                pool[key] = torch.zeros(shape[:3], dtype=torch.float32,
                                        device=device)
        pools.append(pool)
    return pools


@torch.no_grad()
def paged_insert(pools: list, row_kvs: list, page_ids: list[int]) -> None:
    """Scatter a B=1 prefilled row cache (`[1, KVH, T, hd]` k/v per
    layer) into the pool pages `page_ids`, in place (int8 pools: each row
    quantised with `quantize_kv_rows`, its scale beside it). The rows are
    padded up to whole pages; rows past the true length hold pad-key
    values that the decode mask never admits and later decode writes
    overwrite."""
    page_size = pools[0]["k_pages"].shape[2]
    n = len(page_ids)
    device = pools[0]["k_pages"].device
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=device)

    def to_pages(rows):                   # [1, KVH, T, hd] -> [n, KVH, ps, hd]
        pad = n * page_size - rows.shape[2]
        r = torch.nn.functional.pad(rows[0], (0, 0, 0, pad))
        kvh, _, hd = r.shape
        return r.reshape(kvh, n, page_size, hd).transpose(0, 1)

    for pool, (k, v) in zip(pools, row_kvs):
        kr, vr = to_pages(k), to_pages(v)
        if "k_scale" in pool:
            kr, pool["k_scale"][ids] = quantize_kv_rows(kr)
            vr, pool["v_scale"][ids] = quantize_kv_rows(vr)
        pool["k_pages"][ids] = kr.to(pool["k_pages"].dtype)
        pool["v_pages"][ids] = vr.to(pool["v_pages"].dtype)


@torch.no_grad()
def paged_decode_chunk(model: MultiFrameMLLM, last_token: torch.Tensor,
                       positions: torch.Tensor, pools: list,
                       page_table: torch.Tensor, chunk: int):
    """`chunk` greedy decode steps for every slot over the paged pools.
    last_token `[B, 1]`, positions `[B]` int32, page_table `[B, PPS]`
    int32 (fixed for the chunk; the host pre-extends coverage). Returns
    device tensors `(tokens [B, chunk], last token [B, 1], positions)`."""
    llm = model.llm
    token, outs = last_token, []
    for _ in range(chunk):
        paged = [dict(p, page_table=page_table, index=positions)
                 for p in pools]
        logits, _ = llm(llm.embed(token), positions[:, None].long(), paged,
                        inference=True)
        token = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        outs.append(token[:, 0])
        positions = positions + 1
    return torch.stack(outs, dim=1), token, positions


class PagedBatcher:
    """Greedy continuous batching over a shared KV page pool."""

    def __init__(self, model: MultiFrameMLLM,
                 config: PagedConfig | None = None, pad_id: int = 0,
                 eos_id: int = 2, stop_ids: tuple = (),
                 adapters: dict | None = None):
        """`stop_ids`: extra token ids that terminate like eos (first stop
        wins, excluded from the output)."""
        if adapters:
            raise _not_ported("LoRA adapter serving", "queue 1, item 15")
        self.model = model
        self.config = config or PagedConfig()
        self.pad_id = pad_id
        self.eos_id = eos_id
        self.stop_ids = frozenset({int(eos_id), *map(int, stop_ids)})
        cfg = self.config
        self.device = model.llm.embed.weight.device
        self.pools = init_paged_pools(model.cfg.llm, cfg, self.device)
        self.allocator = PageAllocator(cfg.num_pages)
        # host-side mirrors; uploaded per chunk (a few hundred int32s).
        # A slot near max_len keeps decoding (discarded tokens) to the end
        # of its chunk, up to chunk - 1 positions past its coverage: the
        # table is that much wider, so those steps index sink entries of
        # their own row and never the next slot's row.
        width = -(-(cfg.max_len + cfg.chunk) // cfg.page_size)
        self.page_table = np.zeros((cfg.slots, width), dtype=np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(cfg.slots)]
        self.positions = np.zeros(cfg.slots, dtype=np.int32)
        self.last_token = np.zeros((cfg.slots, 1), dtype=np.int64)
        # prefills run (replays included), and host-clock seconds spent in
        # prefill and decode dispatches (each ends in a device->host read)
        self.stats = {"prefill_full": 0, "prefill_seconds": 0.0,
                      "decode_seconds": 0.0, "decode_dispatches": 0,
                      "decode_tokens": 0}

    # -- page management ---------------------------------------------------

    def _free_slot(self, slot: int) -> None:
        self.allocator.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot, :] = 0            # sink: writes can't corrupt
        self.positions[slot] = 0                # idle decode stays in-range
        self.last_token[slot, 0] = 0

    def _extend_to(self, slot: int, n_positions: int) -> bool:
        """Ensure the slot's table covers logical positions < n_positions."""
        cfg = self.config
        need = -(-n_positions // cfg.page_size)
        have = len(self.slot_pages[slot])
        if need <= have:
            return True
        got = self.allocator.alloc(need - have)
        if got is None:
            return False
        self.page_table[slot, have:need] = got
        self.slot_pages[slot].extend(got)
        return True

    # -- request lifecycle ---------------------------------------------------

    def _unpack(self, request):
        """(ids, tiles[, SamplingParams][, max_new]) in any trailing order;
        a per-request token budget is an int in 1..config.max_new_tokens."""
        ids, tiles, max_new = request[0], request[1], None
        for extra in request[2:]:
            if isinstance(extra, SamplingParams):
                if extra.temperature != 0.0:
                    raise _not_ported("sampling", "queue 1, item 15")
            elif isinstance(extra, str):
                raise _not_ported("LoRA adapter serving", "queue 1, item 15")
            elif isinstance(extra, int) and not isinstance(extra, bool):
                if not 1 <= extra <= self.config.max_new_tokens:
                    raise ValueError(
                        f"per-request max_new_tokens {extra} outside "
                        f"1..{self.config.max_new_tokens} "
                        f"(PagedConfig.max_new_tokens is the cap)")
                max_new = extra
            else:
                raise TypeError(
                    f"request extras must be SamplingParams or a "
                    f"max_new_tokens int, got {type(extra).__name__}")
        return ids, tiles, max_new

    def _prefill_into(self, slot: int, prompt_ids: np.ndarray, tiles):
        """Returns the first generated token id, or None if the pool cannot
        cover the prompt right now."""
        cfg = self.config
        ids = pad_to_bucket(np.asarray(prompt_ids)[None], cfg.length_bucket,
                            self.pad_id)
        t = ids.shape[1]
        if t > cfg.max_prompt_len:
            raise ValueError(f"prompt of {t} tokens (bucketed) exceeds "
                             f"max_prompt_len {cfg.max_prompt_len}")
        true_len = len(prompt_ids)
        n_cover = -(-t // cfg.page_size)
        pages = self.allocator.alloc(n_cover)
        if pages is None:
            return None
        self.slot_pages[slot] = pages
        self.page_table[slot, :n_cover] = pages
        self.stats["prefill_full"] += 1
        t0 = time.perf_counter()
        first, row_kvs = prefill_one(self.model, ids,
                                     np.asarray(tiles)[None], true_len)
        paged_insert(self.pools, row_kvs, pages)
        self.stats["prefill_seconds"] += time.perf_counter() - t0
        self.positions[slot] = true_len
        self.last_token[slot, 0] = first
        return first

    def generate_all(self, requests) -> list[np.ndarray]:
        """requests: iterable of (prompt_ids int32 [T], tiles [n,H,W,3])
        plus optional trailing elements (see `_unpack`). Returns generated
        token arrays (cut at the first stop id, <= the token budget), in
        request order."""
        requests = list(requests)
        acc: dict[int, list[int]] = {i: [] for i in range(len(requests))}
        for rid, toks, _done in self.generate_stream(requests):
            acc[rid].extend(toks)
        return [np.asarray(acc[i], dtype=np.int32) for i in sorted(acc)]

    def generate_stream(self, requests):
        """Incremental serving: yields `(request_id, new_tokens, done)`
        after every prefill / decode dispatch, where `new_tokens` are the
        fresh stop-cut tokens of that request (possibly empty on the final
        `done` event). A preempted request's greedy replay re-derives the
        same prefix, and only tokens past the already-streamed count are
        emitted."""
        cfg = self.config
        unpacked = {rid: self._unpack(req) for rid, req in enumerate(requests)}
        queue = sorted(unpacked)
        results: dict[int, list[int]] = {}
        emitted: dict[int, int] = {}      # clean tokens already yielded
        slot_req = [-1] * cfg.slots
        stalled = 0  # consecutive loop turns with no decode/finish progress
        budgets = {rid: u[2] or cfg.max_new_tokens
                   for rid, u in unpacked.items()}

        def finished(rid):
            toks = results[rid]
            return (len(toks) >= budgets[rid]
                    or (toks and toks[-1] in self.stop_ids))

        def increment(rid):
            toks = results[rid]
            cut = next((i for i, t in enumerate(toks)
                        if t in self.stop_ids), len(toks))
            new = toks[emitted.get(rid, 0):cut]
            emitted[rid] = max(emitted.get(rid, 0), cut)
            return new

        while queue or any(r >= 0 for r in slot_req):
            if stalled > 2 * cfg.slots + 4:
                raise RuntimeError(
                    f"paged pool too small to make progress: "
                    f"{cfg.num_pages} pages, {self.allocator.available} "
                    f"free, {len(queue)} queued")
            stalled += 1
            # refill free slots while pages allow
            for slot in range(cfg.slots):
                if slot_req[slot] < 0 and queue:
                    rid = queue[0]
                    ids_r, tiles_r, _ = unpacked[rid]
                    first = self._prefill_into(slot, ids_r, tiles_r)
                    if first is None:           # pool dry: defer refill
                        break
                    queue.pop(0)
                    slot_req[slot] = rid
                    results[rid] = [first]
                    done = finished(rid)
                    yield rid, increment(rid), done
                    if done:
                        stalled = 0
                        slot_req[slot] = -1
                        self._free_slot(slot)
            # extend page coverage for this chunk; preempt on dry pool
            for slot in range(cfg.slots):
                rid = slot_req[slot]
                if rid < 0:
                    continue
                horizon = min(int(self.positions[slot]) + cfg.chunk,
                              cfg.max_len)
                if not self._extend_to(slot, horizon):
                    queue.insert(0, rid)        # preempt: retry from prefill
                    del results[rid]
                    slot_req[slot] = -1
                    self._free_slot(slot)
            if not any(r >= 0 for r in slot_req):
                continue
            t0 = time.perf_counter()
            toks, last, positions = paged_decode_chunk(
                self.model,
                torch.as_tensor(self.last_token, device=self.device),
                torch.as_tensor(self.positions, device=self.device),
                self.pools,
                torch.as_tensor(self.page_table, device=self.device),
                cfg.chunk)
            toks = toks.cpu().numpy()           # the chunk's one host read
            self.last_token = last.cpu().numpy()
            self.positions = positions.cpu().numpy().astype(np.int32)
            self.stats["decode_seconds"] += time.perf_counter() - t0
            self.stats["decode_dispatches"] += 1
            stalled = 0
            # idle slots decode into the sink page but their positions
            # still advance by `chunk` each dispatch; re-zero them so a
            # long pool-dry stretch cannot walk index // page_size past
            # the slot's page-table row (out-of-window reads in the kernel)
            for slot in range(cfg.slots):
                if slot_req[slot] < 0:
                    self.positions[slot] = 0
                    self.last_token[slot, 0] = 0
            for slot in range(cfg.slots):
                rid = slot_req[slot]
                if rid < 0:
                    continue
                for tok in toks[slot]:
                    if finished(rid):
                        break
                    results[rid].append(int(tok))
                    self.stats["decode_tokens"] += 1
                done = finished(rid)
                yield rid, increment(rid), done
                if done:
                    slot_req[slot] = -1
                    self._free_slot(slot)


def bench_paged_config(chunk: int = 32, max_new_tokens: int = 128,
                       kv_dtype: str = "native",
                       prefix_cache: bool = False) -> PagedConfig:
    """The JAX package's serving-benchmark configuration: 8 slots, prompts
    up to 512; native pools of page 64 and 105 pages, int8 pools of page
    128 and 53 pages (the same rows within one page; the page size is the
    TPU kernel's layout rule, kept so the two packages serve alike)."""
    page_size, num_pages = (128, 53) if kv_dtype == "int8" else (64, 105)
    return PagedConfig(slots=8, page_size=page_size, num_pages=num_pages,
                       max_prompt_len=512, max_new_tokens=max_new_tokens,
                       chunk=chunk, length_bucket=128, kv_dtype=kv_dtype,
                       prefix_cache=prefix_cache)


def make_serve_requests(cfg: MLLMConfig, n: int, seed: int = 5,
                        questions_per_image: int = 1) -> list:
    """MultiSPA-shaped serving requests: an image-context prompt (one
    tile's worth of img_context_id tokens) followed by a random text tail
    of 16-175 tokens. Deterministic in (n, seed). The tiles are standard
    normal draws from `np.random.default_rng(100 + i)` (the JAX package
    draws them with `jax.random`, so the values differ).

    `questions_per_image > 1` groups consecutive requests onto one image
    and one shared leading text stretch."""
    rng = np.random.default_rng(seed)
    t_img = cfg.tokens_per_tile
    out = []
    head = tiles = None
    for i in range(n):
        if i % questions_per_image == 0:
            head = rng.integers(10, cfg.llm.vocab_size,
                                size=t_img + 2 + 24).astype(np.int32)
            head[1:1 + t_img] = cfg.img_context_id
            tiles = np.random.default_rng(100 + i).standard_normal(
                (1, cfg.vit.image_size, cfg.vit.image_size, 3),
                dtype=np.float32)
        text = int(rng.integers(16, 176))
        tail = rng.integers(10, cfg.llm.vocab_size,
                            size=text).astype(np.int32)
        out.append((np.concatenate([head, tail]), tiles))
    return out
