"""Paged KV cache + paged continuous batching in PyTorch: port of
multi_spatialmllm_tpu/models/paged_kv.py.

A device page pool shared by all decode slots, in the model dtype or int8
with per-row float32 scales (`kv_dtype`), a host-side refcounted page
allocator, per-request prefill into whole pages, and decode in chunks of
`chunk` steps over every slot through the paged decode op (the CUDA kernel
on the card), the tokens read back to the host once a chunk. When the pool
runs dry a refill is deferred and, if a running slot cannot extend, it is
preempted (pages freed, request re-queued and replayed from prefill).

The JAX package's options, each composing with the others and with int8
pools:

* `prefill_chunk=c`: the prompt's spliced embeddings stream through the
  decoder c rows at a time over the paged pools (the multi-token paged
  forward), instead of one bucketed prefill.
* `prefix_cache`: full prompt pages whose token prefix (and tile pixels,
  once a vision position precedes the page's end) match an earlier
  request's are shared by reference count; prefill runs only the rest
  (resumed at the shared-page boundary: through the chunks, or through
  the contiguous-cache chunked-decode branch over the gathered prefix for
  a text-only suffix). Cached pages are evicted LRU when the pool runs
  dry. Outputs agree with the uncached ones to float tolerance (only the
  reduction order of the suffix attention differs).
* `vision_cache=n` (chunked prefill only): the projected vision features
  of up to n tile stacks, by pixel digest, skip the ViT for a repeated
  image.
* `speculate=n`: prompt-lookup drafts of n tokens verified in one
  multi-token paged forward; tokens equal the greedy chunk loop's.
* `sampling`: per-request `SamplingParams` drawn with the key
  `fold_in(key(seed), position)` (models/prng.py, JAX's streams).
* `logprobs`: each emitted token's float32 log-probability, in
  `request_logprobs[rid]`.

Multi-LoRA serving (`adapters=`, `lora_config=`): LoRA adapters served
unmerged per request (parallel/lora_serving.py): a request may name its
adapter, one batch mixes adapters and base rows, and each row's deltas
apply on every path (prefill, chunked prefill, prefix resume, decode and
the speculative verify chain). Prefix-cache pages are keyed by the adapter
too, so pages are never shared across adapters; the vision cache is not
(the ViT takes no adapter).

Key invariants (as in the JAX package):
* Page 0 is a SINK page, never allocated: freed/idle slots' table rows
  point at it, so their discarded decode writes cannot corrupt pages
  re-allocated to another slot. The table is wider than a slot's longest
  coverage by a dispatch's advance, so steps a slot takes past its
  coverage in its last dispatch land in the sink too.
* Idle slots' positions are re-zeroed after every dispatch, so the
  kernel never indexes past a table row.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.paged_attention import gather_window, quantize_kv_rows
from ..parallel.lora_serving import shard_serving_tables, stack_adapters
from .generate import model_device, pad_to_bucket
from .llm import DTYPES, LLMConfig
from .mllm import MLLMConfig, MultiFrameMLLM
from .serving import (
    SamplingParams,
    decode_chunk,
    dispatch,
    next_tokens,
    prefill_one,
    sampling_state,
    token_logprob,
    unpack_request,
)

KV_DTYPES = ("native", "int8")


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
    prefill_chunk: int = 0         # >0: chunked prefill of this many rows
    vision_cache: int = 0          # >0 (chunked): cached vision features
    speculate: int = 0             # >0: prompt-lookup drafts a verify
    prefix_cache: bool = False     # share matching full prompt pages
    sampling: bool = False         # per-request SamplingParams
    top_k: int | None = None       # static top-k when sampling
    logprobs: bool = False         # record emitted tokens' logprobs

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in "
                             f"{KV_DTYPES}")

    @property
    def max_len(self) -> int:
        # a speculative verify writes up to `speculate` rows past the last
        # emitted position, and a chunked prefill's last chunk writes pad
        # rows up to `prefill_chunk - 1` past the prompt's end
        return (self.max_prompt_len + self.max_new_tokens + self.speculate
                + self.prefill_chunk)

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_len // self.page_size)

    @property
    def advance(self) -> int:
        """Logical positions a dispatch can cover."""
        return self.chunk * (self.speculate + 1)


class PageAllocator:
    """Host-side refcounted free list over pages 1..num_pages-1 (0 is the
    sink). A fresh page has one reference; prefix sharing adds references
    (`retain`) and `release` returns a page to the free list when its last
    reference drops. Allocation is all-or-nothing."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self.refs: dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n pages, or None."""
        if n < 0 or len(self._free) < n:
            return None
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            self.refs[p] = 1
        return got

    def retain(self, page: int) -> None:
        self.refs[page] += 1

    def release(self, pages) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} is not an allocatable page")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                del self.refs[p]
                self._free.append(p)


def init_paged_pools(cfg: LLMConfig, pcfg: PagedConfig, device,
                     kv_heads: int | None = None) -> list:
    """Per-layer page pools `[num_pages, kv_heads, page_size, head_dim]`
    in the model dtype, or int8 with float32 scale pools
    `[num_pages, kv_heads, page_size]` (`k_scale`, `v_scale`) when
    `pcfg.kv_dtype == "int8"`. `kv_heads`: those a process holds on the
    model axis (`DecoderLM.kv_heads`), all of them by default."""
    shape = (pcfg.num_pages, kv_heads or cfg.num_kv_heads, pcfg.page_size,
             cfg.head_dim)
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


def _rows_to_pages(rows: torch.Tensor, n: int, page_size: int):
    """`[KVH, T, hd]` rows padded to n whole pages -> `[n, KVH, ps, hd]`."""
    r = F.pad(rows, (0, 0, 0, n * page_size - rows.shape[1]))
    kvh, _, hd = r.shape
    return r.reshape(kvh, n, page_size, hd).transpose(0, 1)


def _store_pages(pool: dict, name: str, pages: torch.Tensor,
                 ids: torch.Tensor) -> None:
    """Write whole pages `[n, KVH, ps, hd]` at page ids, in place (int8
    pools: quantised per row, the scales beside them)."""
    if f"{name}_scale" in pool:
        pages, pool[f"{name}_scale"][ids] = quantize_kv_rows(pages)
    pool[f"{name}_pages"][ids] = pages.to(pool[f"{name}_pages"].dtype)


@torch.no_grad()
def paged_insert(pools: list, row_kvs: list, page_ids: list[int]) -> None:
    """Scatter a B=1 prefilled row cache (`[1, KVH, T, hd]` k/v per
    layer) into the pool pages `page_ids`, in place (int8 pools: each row
    quantised with `quantize_kv_rows`, its scale beside it). The rows are
    padded up to whole pages; rows past the true length hold pad-key
    values that the decode mask never admits and later decode writes
    overwrite."""
    page_size = pools[0]["k_pages"].shape[2]
    ids = torch.as_tensor(page_ids, dtype=torch.long,
                          device=pools[0]["k_pages"].device)
    for pool, (k, v) in zip(pools, row_kvs):
        _store_pages(pool, "k", _rows_to_pages(k[0], len(page_ids),
                                               page_size), ids)
        _store_pages(pool, "v", _rows_to_pages(v[0], len(page_ids),
                                               page_size), ids)


def _paged_caches(pools: list, page_table: torch.Tensor,
                  index: torch.Tensor) -> list:
    return [dict(p, page_table=page_table, index=index) for p in pools]


def _paged_forward(model: MultiFrameMLLM, embeds: torch.Tensor,
                   positions: torch.Tensor, pools: list,
                   page_table: torch.Tensor, lora=None) -> torch.Tensor:
    """Embeddings `[B, t, D]` at positions `[B, t]` (each row's first at
    its cache index) through the decoder over the paged pools -> logits;
    `lora` the rows' serving adapters."""
    caches = _paged_caches(pools, page_table,
                           positions[:, 0].to(torch.int32))
    logits, _ = model.llm(embeds, positions, caches, inference=True,
                          lora=lora)
    return logits


def _paged_step(model: MultiFrameMLLM, pools: list,
                page_table: torch.Tensor, lora=None):
    """`step(token [B, 1], positions [B]) -> logits [B, V]`: one decode
    step over the paged pools (K7 on the card)."""
    llm = model.llm

    def step(token, pos):
        return _paged_forward(model, llm.embed(token), pos[:, None].long(),
                              pools, page_table, lora)[:, -1]

    return step


@torch.no_grad()
def paged_decode_chunk(model: MultiFrameMLLM, last_token: torch.Tensor,
                       positions: torch.Tensor, pools: list,
                       page_table: torch.Tensor, chunk: int, samp=None,
                       logprobs: bool = False):
    """`chunk` decode steps for every slot over the paged pools. last_token
    `[B, 1]`, positions `[B]` int32, page_table `[B, PPS]` int32 (fixed for
    the chunk; the host pre-extends coverage); `samp` as
    serving.next_tokens takes it (None: greedy). Returns device tensors
    `(tokens [B, chunk], logprobs [B, chunk] or None, last token [B, 1],
    positions)`."""
    return decode_chunk(_paged_step(model, pools, page_table), last_token,
                        positions, chunk, samp, logprobs)


class PagedBatcher:
    """Continuous batching over a shared KV page pool (greedy by default;
    see the module docstring for the options)."""

    def __init__(self, model: MultiFrameMLLM,
                 config: PagedConfig | None = None, pad_id: int = 0,
                 eos_id: int = 2, stop_ids: tuple = (),
                 adapters: dict | None = None, lora_config=None):
        """`stop_ids`: extra token ids that terminate like eos (first stop
        wins, excluded from the output). `adapters`: `{name: adapter dict}`
        (parallel/lora.init_lora's structure) served unmerged per request,
        a request naming its adapter by a str extra; `lora_config` is the
        adapters' LoRAConfig (their alpha is not in the tensors)."""
        self.model = model
        self.config = config or PagedConfig()
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
        self.request_logprobs: dict[int, list[float]] = {}
        self.device = model_device(model)
        self.lora_tables = None
        self.adapter_index: dict[str, int] = {}
        if adapters:
            if lora_config is None:
                raise ValueError(
                    "PagedBatcher(adapters=...) needs lora_config: the "
                    "adapters carry rank but not alpha, and a default "
                    "scale would silently mis-serve them")
            names = list(adapters)
            tables = shard_serving_tables(
                model, stack_adapters([adapters[n] for n in names],
                                      model.cfg.llm.num_layers, lora_config))
            tables["layers"] = [
                {t: (a.to(self.device), b.to(self.device))
                 for t, (a, b) in layer.items()}
                for layer in tables["layers"]]
            self.lora_tables = tables
            self.adapter_index = {n: i + 1 for i, n in enumerate(names)}
        self.slot_adapter = np.zeros(cfg.slots, dtype=np.int64)
        self.pools = init_paged_pools(model.cfg.llm, cfg, self.device,
                                      model.llm.kv_heads)
        self.allocator = PageAllocator(cfg.num_pages)
        # host-side mirrors; uploaded per chunk (a few hundred int32s).
        # A slot near max_len keeps decoding (discarded tokens) to the end
        # of its dispatch, up to a dispatch's advance past its coverage:
        # the table is that much wider, so those steps index sink entries
        # of their own row and never the next slot's row.
        width = -(-(cfg.max_len + cfg.advance + cfg.speculate)
                  // cfg.page_size)
        self.page_table = np.zeros((cfg.slots, width), dtype=np.int32)
        self.slot_pages: list[list[int]] = [[] for _ in range(cfg.slots)]
        self.positions = np.zeros(cfg.slots, dtype=np.int32)
        self.last_token = np.zeros((cfg.slots, 1), dtype=np.int64)
        self.temperature = np.zeros(cfg.slots, dtype=np.float32)
        self.top_p = np.ones(cfg.slots, dtype=np.float32)
        self.seed = np.zeros(cfg.slots, dtype=np.int32)
        # prefix cache: page key -> page id, LRU-ordered; the cache holds
        # one reference per entry so shared pages survive slot frees
        self.prefix_pages: OrderedDict[bytes, int] = OrderedDict()
        self._page_key: dict[int, bytes] = {}
        # tile digest -> projected vision features (chunked prefill)
        self.vision_feats: OrderedDict[bytes, torch.Tensor] = OrderedDict()
        self.hist_len = cfg.max_prompt_len + cfg.max_new_tokens + 1
        self.hist = np.full((cfg.slots, self.hist_len), -1, np.int64)
        # the JAX package's counters (prefills full and resumed, pages
        # reused and evicted, vision-cache hits), the speculative verifies
        # of live slots, and host-clock seconds of prefill and decode
        # dispatches (each ends in a device->host read)
        self.stats = {"prefill_full": 0, "prefill_resumed": 0,
                      "pages_reused": 0, "pages_evicted": 0,
                      "vision_hits": 0, "spec_verifies": 0,
                      "prefill_seconds": 0.0, "decode_seconds": 0.0,
                      "decode_dispatches": 0, "decode_tokens": 0}

    # -- page management ---------------------------------------------------

    def _free_slot(self, slot: int) -> None:
        self.allocator.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot, :] = 0            # sink: writes can't corrupt
        self.positions[slot] = 0                # idle decode stays in-range
        self.last_token[slot, 0] = 0
        self.slot_adapter[slot] = 0
        self.temperature[slot] = 0.0
        self.top_p[slot] = 1.0
        self.seed[slot] = 0
        self.hist[slot, :] = -1

    def _alloc(self, n: int) -> list[int] | None:
        """n pages, evicting LRU prefix-cache entries whose only reference
        is the cache itself while the free list runs dry."""
        got = self.allocator.alloc(n)
        while got is None:
            victim = next((k for k, p in self.prefix_pages.items()
                           if self.allocator.refs.get(p) == 1), None)
            if victim is None:
                return None
            page = self.prefix_pages.pop(victim)
            del self._page_key[page]
            self.allocator.release([page])
            self.stats["pages_evicted"] += 1
            got = self.allocator.alloc(n)
        return got

    def _extend_to(self, slot: int, n_positions: int) -> bool:
        """Ensure the slot's table covers logical positions < n_positions."""
        cfg = self.config
        need = -(-n_positions // cfg.page_size)
        have = len(self.slot_pages[slot])
        if need <= have:
            return True
        got = self._alloc(need - have)
        if got is None:
            return False
        self.page_table[slot, have:need] = got
        self.slot_pages[slot].extend(got)
        return True

    def _page_keys(self, prompt_ids: np.ndarray, tiles,
                   adapter: str | None = None) -> list[bytes]:
        """Digest per full page of real prompt tokens: every token id up to
        the page's end, the adapter name (adapted projections change every
        kv row, so pages are never shared across adapters) and, once a
        vision position precedes the page's end, the tile pixels (vision kv
        depends on the pixels, not the placeholder id)."""
        ps = self.config.page_size
        img = int(self.model.cfg.img_context_id)
        ids = np.asarray(prompt_ids, dtype=np.int32)
        tiles_digest = None
        keys = []
        for p in range(len(ids) // ps):
            head = ids[: (p + 1) * ps]
            h = hashlib.blake2b(head.tobytes(), digest_size=16)
            h.update(repr(adapter).encode())
            if (head == img).any():
                if tiles_digest is None:
                    tiles_digest = hashlib.blake2b(
                        np.ascontiguousarray(tiles).tobytes(),
                        digest_size=16).digest()
                h.update(tiles_digest)
            keys.append(h.digest())
        return keys

    def clear_prefix_cache(self) -> None:
        """Drop every cache-owned page reference (pages still borrowed by
        live slots stay resident until their slot frees them)."""
        for page in list(self.prefix_pages.values()):
            del self._page_key[page]
            self.allocator.release([page])
        self.prefix_pages.clear()

    def _lora_for(self, idx) -> dict | None:
        """The serving bundle for rows with adapter indices `idx` (0 = the
        base), or None without adapters."""
        if self.lora_tables is None:
            return None
        return {"scale": self.lora_tables["scale"],
                "idx": torch.as_tensor(np.asarray(idx, np.int64),
                                       device=self.device),
                "layers": self.lora_tables["layers"]}

    # -- prefill programs ----------------------------------------------------

    def _samp1(self, sp: SamplingParams):
        return sampling_state(self.config, [sp.temperature], [sp.top_p],
                              np.asarray([sp.seed], np.int32), self.device)

    def _embeds(self, ids: np.ndarray, tiles) -> torch.Tensor:
        """The prompt's spliced embeddings `[1, T, D]`, through the vision
        cache when it is on."""
        cfg = self.config
        dev = self.device
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
        tiles_t = torch.as_tensor(np.asarray(tiles, np.float32),
                                  device=dev)[None]
        if not cfg.vision_cache:
            return self.model.spliced_embeds(ids_t, tiles_t)
        digest = hashlib.blake2b(np.ascontiguousarray(tiles).tobytes(),
                                 digest_size=16).digest()
        vis = self.vision_feats.get(digest)
        if vis is None:
            vis = self.model.encode_tiles(tiles_t[0]) if tiles_t.shape[1] \
                else tiles_t.new_zeros(0, 0, self.model.cfg.llm.hidden_size)
            vis = vis.reshape(1, -1, vis.shape[-1])
            self.vision_feats[digest] = vis
            while len(self.vision_feats) > cfg.vision_cache:
                self.vision_feats.popitem(last=False)
        else:
            self.stats["vision_hits"] += 1
            self.vision_feats.move_to_end(digest)
        return self.model.splice(ids_t, vis)

    def _prefill_chunks(self, slot, ids, tiles, start, m, true_len, samp,
                        lora):
        """Chunked prefill: m chunks of `prefill_chunk` rows from `start`
        through the paged pools; the first token comes from the row at the
        true prompt end (drawn with key fold(seed, that position))."""
        cfg = self.config
        c = cfg.prefill_chunk
        emb = self._embeds(ids, tiles)
        if emb.shape[1] < start + m * c:          # the last chunk's pad rows
            emb = F.pad(emb, (0, 0, 0, start + m * c - emb.shape[1]))
        pt_row = torch.as_tensor(self.page_table[slot][None],
                                 device=self.device)
        for i in range(m):
            lo = start + i * c
            positions = torch.arange(lo, lo + c, device=self.device)[None]
            logits = _paged_forward(self.model, emb[:, lo:lo + c],
                                    positions, self.pools, pt_row, lora)
        last = logits[:, true_len - 1 - (start + (m - 1) * c)]
        return self._first(last, true_len, samp)

    def _first(self, last: torch.Tensor, true_len: int, samp):
        pos = torch.full((1,), true_len - 1, dtype=torch.long,
                         device=self.device)
        first = next_tokens(last, pos, samp)
        lp = float(token_logprob(last, first)[0]) \
            if self.config.logprobs else None
        return int(first[0, 0]), lp

    def _prefix_resume(self, ids, shared, fresh, true_len, samp, lora):
        """Prefill resumed after a prefix-cache hit (text-only suffix): the
        shared pages gathered (dequantised) into a contiguous cache, ONLY
        the suffix tokens run through the chunked-decode branch at their
        absolute positions, and the suffix kv written to the fresh
        pages."""
        cfg = self.config
        dev = self.device
        ps = cfg.page_size
        n_shared = len(shared) * ps
        t_total = ids.shape[1]
        dtype = DTYPES[self.model.cfg.llm.dtype]
        table = torch.as_tensor(shared, device=dev)[None]
        caches = []
        for pool in self.pools:
            rows = {}
            for name in ("k", "v"):
                w = gather_window(pool[f"{name}_pages"], table,
                                  pool.get(f"{name}_scale"), dtype)
                rows[name] = F.pad(w, (0, 0, 0, t_total - n_shared))
            caches.append({**rows, "index": torch.full(
                (1,), n_shared, dtype=torch.long, device=dev)})
        suffix = torch.as_tensor(ids[:, n_shared:], dtype=torch.long,
                                 device=dev)
        positions = torch.arange(n_shared, t_total, device=dev)[None]
        llm = self.model.llm
        logits, _ = llm(llm.embed(suffix), positions, caches,
                        inference=True, lora=lora)
        first = self._first(logits[:, true_len - n_shared - 1], true_len,
                            samp)
        page_ids = torch.as_tensor(fresh, dtype=torch.long, device=dev)
        for pool, c in zip(self.pools, caches):
            for name in ("k", "v"):
                _store_pages(pool, name, _rows_to_pages(
                    c[name][0, :, n_shared:], len(fresh), ps), page_ids)
        return first

    @torch.no_grad()
    def _prefill_into(self, slot: int, prompt_ids: np.ndarray, tiles,
                      sp: SamplingParams | None = None,
                      adapter: str | None = None):
        """Returns (the first generated token id, its logprob or None), or
        None if the pool cannot cover the prompt right now."""
        cfg = self.config
        sp = sp or SamplingParams()
        if not cfg.sampling and sp.temperature != 0.0:
            raise ValueError("pass PagedConfig(sampling=True) to use "
                             "SamplingParams")
        ps = cfg.page_size
        ids = pad_to_bucket(np.asarray(prompt_ids)[None], cfg.length_bucket,
                            self.pad_id)
        t = ids.shape[1]
        if t > cfg.max_prompt_len:
            raise ValueError(f"prompt of {t} tokens (bucketed) exceeds "
                             f"max_prompt_len {cfg.max_prompt_len}")
        true_len = len(prompt_ids)
        c = cfg.prefill_chunk
        n_cover = -(-t // ps)

        # prefix-cache lookup: the longest run of cached full pages, at
        # least one real token left for the first token's logits; the
        # one-shot resume embeds tokens without tiles, so it needs a
        # text-only suffix (the chunks splice the whole prompt)
        keys: list[bytes] = []
        j = 0
        if cfg.prefix_cache:
            keys = self._page_keys(prompt_ids, tiles, adapter)
            j_max = (true_len - 1) // ps
            while j < j_max and keys[j] in self.prefix_pages:
                j += 1
            img = int(self.model.cfg.img_context_id)
            if j and not c and (np.asarray(prompt_ids[j * ps:])
                                == img).any():
                j = 0
        if c:
            # m fixed-size chunks from the shared-page boundary; the last
            # chunk's pad-row writes land inside the covered span
            start = j * ps
            m = -(-(true_len - start) // c)
            n_cover = -(-(start + m * c) // ps)

        fresh = self._alloc(n_cover - j)
        if fresh is None:
            return None
        shared = []
        for p in range(j):
            page = self.prefix_pages[keys[p]]
            self.prefix_pages.move_to_end(keys[p])
            self.allocator.retain(page)
            shared.append(page)
        pages = shared + fresh
        self.slot_pages[slot] = pages
        self.page_table[slot, :n_cover] = pages
        self.stats["pages_reused"] += j
        self.stats["prefill_resumed" if j else "prefill_full"] += 1

        t0 = time.perf_counter()
        samp = self._samp1(sp)
        aidx = 0 if adapter is None else self.adapter_index[adapter]
        lora1 = self._lora_for([aidx])
        if c:
            first, lp = self._prefill_chunks(slot, ids, tiles, start, m,
                                             true_len, samp, lora1)
        elif j:
            first, lp = self._prefix_resume(ids, shared, fresh, true_len,
                                            samp, lora1)
        else:
            first, lp, row_kvs = prefill_one(
                self.model, ids, np.asarray(tiles)[None], true_len, samp,
                cfg.logprobs, lora1)
            paged_insert(self.pools, row_kvs, pages)
        self.stats["prefill_seconds"] += time.perf_counter() - t0

        # register this prompt's full pages for later prefix hits (one
        # cache-owned reference each)
        if cfg.prefix_cache:
            for p in range(true_len // ps):
                if keys[p] not in self.prefix_pages:
                    self.prefix_pages[keys[p]] = pages[p]
                    self._page_key[pages[p]] = keys[p]
                    self.allocator.retain(pages[p])

        self.positions[slot] = true_len
        self.last_token[slot, 0] = first
        self.slot_adapter[slot] = aidx
        self.temperature[slot] = sp.temperature
        self.top_p[slot] = sp.top_p
        self.seed[slot] = sp.seed
        if cfg.speculate:
            self.hist[slot, :] = -1
            self.hist[slot, :true_len] = prompt_ids
            self.hist[slot, true_len] = first
        return first, lp

    # -- request lifecycle ---------------------------------------------------

    def _unpack(self, request):
        """(ids, tiles[, adapter name][, SamplingParams][, max_new]) in any
        trailing order -> (ids, tiles, adapter, sp, max_new); a per-request
        token budget is an int in 1..config.max_new_tokens, an adapter one
        of the names given at construction."""
        ids, tiles, adapter, sp, max_new = unpack_request(
            request, self.config.max_new_tokens, allow_adapter=True)
        if adapter is not None and adapter not in self.adapter_index:
            raise ValueError(f"unknown adapter {adapter!r}; registered: "
                             f"{sorted(self.adapter_index)}")
        return ids, tiles, adapter, sp, max_new

    def _decode(self):
        """One dispatch over every slot (`serving.dispatch`)."""
        table = torch.as_tensor(self.page_table, device=self.device)
        llm = self.model.llm
        lora = self._lora_for(self.slot_adapter)

        def verify(tokens, pos):
            slot = torch.arange(tokens.shape[1], device=self.device)
            return _paged_forward(self.model, llm.embed(tokens),
                                  pos.long()[:, None] + slot[None, :],
                                  self.pools, table, lora)

        return dispatch(self, _paged_step(self.model, self.pools, table,
                                          lora), verify)

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
        `done` event). A preempted request's replay re-derives its prefix
        (greedy and keyed sampling reproduce it), and only tokens past the
        already-streamed count are emitted. With `logprobs`, a finished
        request's are in `request_logprobs[rid]`."""
        cfg = self.config
        unpacked = {rid: self._unpack(req) for rid, req in enumerate(requests)}
        queue = sorted(unpacked)
        results: dict[int, list[int]] = {}
        lprobs: dict[int, list] = {}
        self.request_logprobs = {}
        emitted: dict[int, int] = {}      # clean tokens already yielded
        slot_req = [-1] * cfg.slots
        stalled = 0  # consecutive loop turns with no decode/finish progress
        budgets = {rid: u[4] or cfg.max_new_tokens
                   for rid, u in unpacked.items()}

        def finished(rid):
            toks = results[rid]
            return (len(toks) >= budgets[rid]
                    or (toks and toks[-1] in self.stop_ids))

        def cut_len(toks):
            return next((i for i, t in enumerate(toks)
                         if t in self.stop_ids), len(toks))

        def increment(rid):
            toks = results[rid][:cut_len(results[rid])]
            new = toks[emitted.get(rid, 0):]
            emitted[rid] = max(emitted.get(rid, 0), len(toks))
            return new

        def close(rid):
            if cfg.logprobs:
                self.request_logprobs[rid] = \
                    lprobs[rid][:cut_len(results[rid])]

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
                    ids_r, tiles_r, adapter_r, sp_r, _ = unpacked[rid]
                    got = self._prefill_into(slot, ids_r, tiles_r, sp_r,
                                             adapter_r)
                    if got is None:             # pool dry: defer refill
                        break
                    queue.pop(0)
                    slot_req[slot] = rid
                    results[rid] = [got[0]]
                    lprobs[rid] = [got[1]]
                    done = finished(rid)
                    if done:
                        close(rid)
                    yield rid, increment(rid), done
                    if done:
                        stalled = 0
                        slot_req[slot] = -1
                        self._free_slot(slot)
            # extend page coverage for this dispatch; preempt on a dry pool
            for slot in range(cfg.slots):
                rid = slot_req[slot]
                if rid < 0:
                    continue
                horizon = min(int(self.positions[slot]) + cfg.advance,
                              cfg.max_len)
                if not self._extend_to(slot, horizon):
                    queue.insert(0, rid)        # preempt: retry from prefill
                    del results[rid]
                    lprobs.pop(rid, None)
                    slot_req[slot] = -1
                    self._free_slot(slot)
            if not any(r >= 0 for r in slot_req):
                continue
            t0 = time.perf_counter()
            steps, lps = self._decode()
            self.stats["decode_seconds"] += time.perf_counter() - t0
            self.stats["decode_dispatches"] += 1
            stalled = 0
            # idle slots decode into the sink page but their positions
            # still advance each dispatch; re-zero them so a long pool-dry
            # stretch cannot walk index // page_size past the slot's row
            for slot in range(cfg.slots):
                if slot_req[slot] < 0:
                    self.positions[slot] = 0
                    self.last_token[slot, 0] = 0
                    self.hist[slot, :] = -1
            for slot in range(cfg.slots):
                rid = slot_req[slot]
                if rid < 0:
                    continue
                for i, step in enumerate(steps[slot]):
                    if finished(rid):
                        break
                    self.stats["spec_verifies"] += bool(cfg.speculate)
                    for tok in step:
                        if finished(rid):
                            break
                        results[rid].append(int(tok))
                        self.stats["decode_tokens"] += 1
                        if lps is not None:
                            lprobs[rid].append(float(lps[slot, i]))
                done = finished(rid)
                if done:
                    close(rid)
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
