"""Training-batch assembly: MultiSPA JSONL -> model-ready arrays (the
port's copy of multi_spatialmllm_tpu/models/data.py; numpy on the host).

Tokenizes the conversation with IMG_CONTEXT expansion at every `<image>`
placeholder, tiles the frames, masks the loss to assistant turns, and pads
or packs everything to static shapes. Batches are byte-equal to the JAX
package's (tests/test_torch_data.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from ..utils.profiling import span
from .mllm import MLLMConfig
from .preprocess import PreprocessConfig, tile_device, tile_image
from .tokenizer import (
    ASSISTANT,
    HUMAN,
    IMG_CONTEXT,
    IMG_END,
    IMG_START,
    SpatialTokenizer,
)

IGNORE_INDEX = -100


@dataclasses.dataclass
class DataConfig:
    max_seq_len: int = 2048
    max_tiles: int = 14           # per sample, across all frames
    preprocess: PreprocessConfig = PreprocessConfig(resize_hw=None)


def render_conversation(
    sample: dict,
    tokens_per_tile: int,
    tiles_per_image: Sequence[int],
) -> list[tuple[str, str]]:
    """(role, text) turns with every `<image>` placeholder replaced by
    `<img><IMG_CONTEXT>*n</img>` for that frame's tile count (InternVL
    convention)."""
    turns = []
    img_idx = 0
    for msg in sample["conversations"]:
        text = msg["value"]
        while "<image>" in text:
            n_ctx = tokens_per_tile * tiles_per_image[img_idx]
            block = IMG_START + IMG_CONTEXT * n_ctx + IMG_END
            text = text.replace("<image>", block, 1)
            img_idx += 1
        turns.append((msg["from"], text))
    return turns


def encode_unpadded(
    sample: dict,
    tokenizer: SpatialTokenizer,
    model_cfg: MLLMConfig,
    image_loader: Callable[[str], np.ndarray],
    config: DataConfig | None = None,
    device=None,
):
    """One JSONL record -> (input_ids [L], labels [L], tiles [n,H,W,3])
    at the sample's TRUE length, or None if it exceeds the budgets; the
    tiles are made for a model on `device` (`tile_image`)."""
    config = config or DataConfig()
    tile_stacks = []
    tiles_per_image = []
    # text-only records (general instruction data mixed in per the
    # reference's recipe, README.md:200) carry no "image" key: zero
    # tiles, no IMG_CONTEXT positions, plain next-token loss
    for rel_path in sample.get("image", []):
        img = image_loader(rel_path)
        tiles = tile_image(img, config.preprocess, device)
        tile_stacks.append(tiles)
        tiles_per_image.append(tiles.shape[0])
    total_tiles = int(sum(tiles_per_image))
    if total_tiles > config.max_tiles:
        return None

    turns = render_conversation(sample, model_cfg.tokens_per_tile,
                                tiles_per_image)
    ids: list[int] = [tokenizer.bos_id]
    labels: list[int] = [IGNORE_INDEX]
    for role, text in turns:
        prefix = HUMAN if role == "human" else ASSISTANT
        toks = tokenizer.encode(prefix + text)
        ids.extend(toks)
        if role == "human":
            labels.extend([IGNORE_INDEX] * len(toks))
        else:
            # supervise the answer + eos, not the role-prefix token
            labels.extend([IGNORE_INDEX] + toks[1:])
            ids.append(tokenizer.eos_id)
            labels.append(tokenizer.eos_id)
    if len(ids) > config.max_seq_len:
        return None

    input_ids = np.asarray(ids, dtype=np.int32)
    label_arr = np.asarray(labels, dtype=np.int32)
    # IMG_CONTEXT positions carry no text loss
    label_arr[input_ids == tokenizer.img_context_id] = IGNORE_INDEX
    ts = config.preprocess.tile_size
    tiles_out = (np.concatenate(tile_stacks, axis=0) if tile_stacks
                 else np.zeros((0, ts, ts, 3), dtype=np.float32))
    return input_ids, label_arr, tiles_out


def encode_sample(
    sample: dict,
    tokenizer: SpatialTokenizer,
    model_cfg: MLLMConfig,
    image_loader: Callable[[str], np.ndarray],
    config: DataConfig | None = None,
    device=None,
):
    """One JSONL record -> (input_ids, labels, tiles, n_tiles) padded to
    the static budget, or None if it does not fit."""
    config = config or DataConfig()
    enc = encode_unpadded(sample, tokenizer, model_cfg, image_loader,
                          config, device)
    if enc is None:
        return None
    ids, labels, tile_tensor = enc
    total_tiles = tile_tensor.shape[0]

    pad = config.max_seq_len - len(ids)
    input_ids = np.concatenate(
        [ids, np.full(pad, tokenizer.pad_id, dtype=np.int32)])
    label_arr = np.concatenate(
        [labels, np.full(pad, IGNORE_INDEX, dtype=np.int32)])
    pad_tiles = np.zeros(
        (config.max_tiles - total_tiles,) + tile_tensor.shape[1:],
        dtype=tile_tensor.dtype)
    tiles_out = np.concatenate([tile_tensor, pad_tiles], axis=0)
    return input_ids, label_arr, tiles_out, total_tiles


def pack_samples(encoded, config: DataConfig, pad_id: int):
    """Greedy in-order packing of `encode_unpadded` outputs into
    static-shape rows (SFT sequence packing: several conversations share
    one row behind a block-diagonal attention mask, so short samples stop
    paying the full max_seq_len of padding).

    Yields row dicts with `input_ids`/`labels` `[T]`, `segment_ids` `[T]`
    (1-based per sample; 0 marks padding), `positions` `[T]` (RoPE
    positions restart at 0 for each segment), and `tiles`
    `[max_tiles, H, W, 3]` (each segment's tiles concatenated in segment
    order — IMG_CONTEXT splicing indexes vision tokens by cumulative
    count, so tile order must match segment order).
    """
    T, max_tiles = config.max_seq_len, config.max_tiles
    row: list = []
    used_tok = used_tiles = 0

    def emit(row):
        ids = np.full(T, pad_id, dtype=np.int32)
        labels = np.full(T, IGNORE_INDEX, dtype=np.int32)
        seg = np.zeros(T, dtype=np.int32)
        pos = np.zeros(T, dtype=np.int32)
        tile_parts = []
        at = 0
        for s, (e_ids, e_labels, e_tiles) in enumerate(row, start=1):
            n = len(e_ids)
            ids[at:at + n] = e_ids
            labels[at:at + n] = e_labels
            seg[at:at + n] = s
            pos[at:at + n] = np.arange(n)
            at += n
            tile_parts.append(e_tiles)
        tiles = np.concatenate(tile_parts, axis=0)
        pad_tiles = np.zeros((max_tiles - tiles.shape[0],) + tiles.shape[1:],
                             dtype=tiles.dtype)
        return {
            "input_ids": ids, "labels": labels, "segment_ids": seg,
            "positions": pos,
            "tiles": np.concatenate([tiles, pad_tiles], axis=0),
        }

    for enc in encoded:
        if enc is None:
            continue
        e_ids, e_labels, e_tiles = enc
        if used_tok + len(e_ids) > T or used_tiles + e_tiles.shape[0] > \
                max_tiles:
            if row:
                yield emit(row)
            row, used_tok, used_tiles = [], 0, 0
        row.append((e_ids, e_labels, e_tiles))
        used_tok += len(e_ids)
        used_tiles += e_tiles.shape[0]
    if row:
        yield emit(row)


def packed_batch_iterator(
    samples: Sequence[dict],
    tokenizer: SpatialTokenizer,
    model_cfg: MLLMConfig,
    image_loader: Callable[[str], np.ndarray],
    batch_size: int,
    config: DataConfig | None = None,
    drop_remainder: bool = True,
    device=None,
) -> Iterator[dict]:
    """`batch_iterator` with sequence packing: batches additionally carry
    `segment_ids` and `positions` `[B, T]` — feed them to the model so
    attention is block-diagonal and RoPE restarts per segment
    (MultiFrameMLLM.__call__ / parallel.train's loss both accept them)."""
    config = config or DataConfig()
    encoded = (encode_unpadded(s, tokenizer, model_cfg, image_loader,
                               config, device) for s in samples)
    buf: list[dict] = []
    for row in pack_samples(encoded, config, tokenizer.pad_id):
        buf.append(row)
        if len(buf) == batch_size:
            yield {k: np.stack([r[k] for r in buf]) for k in buf[0]}
            buf = []
    if buf and not drop_remainder:
        yield {k: np.stack([r[k] for r in buf]) for k in buf[0]}


def batch_iterator(
    samples: Sequence[dict],
    tokenizer: SpatialTokenizer,
    model_cfg: MLLMConfig,
    image_loader: Callable[[str], np.ndarray],
    batch_size: int,
    config: DataConfig | None = None,
    drop_remainder: bool = True,
    device=None,
) -> Iterator[dict]:
    """Static-shape batches: input_ids [B,T] int32, labels [B,T] int32,
    tiles [B, max_tiles, H, W, 3] float32, tiled for a model on `device`
    (`tile_image`)."""
    config = config or DataConfig()
    buf_ids, buf_labels, buf_tiles = [], [], []
    for sample in samples:
        enc = encode_sample(sample, tokenizer, model_cfg, image_loader,
                            config, device)
        if enc is None:
            continue
        input_ids, labels, tiles, _ = enc
        buf_ids.append(input_ids)
        buf_labels.append(labels)
        buf_tiles.append(tiles)
        if len(buf_ids) == batch_size:
            yield {
                "input_ids": np.stack(buf_ids),
                "labels": np.stack(buf_labels),
                "tiles": np.stack(buf_tiles),
            }
            buf_ids, buf_labels, buf_tiles = [], [], []
    if buf_ids and not drop_remainder:
        yield {
            "input_ids": np.stack(buf_ids),
            "labels": np.stack(buf_labels),
            "tiles": np.stack(buf_tiles),
        }


def _tiling_cuda_device(device) -> int | None:
    """The calling thread's CUDA device where frames for a model on
    `device` are tiled on the card, else None: a thread that works for it
    starts on that device."""
    if tile_device(device).type != "cuda":
        return None
    return torch.cuda.current_device()


def _set_cuda_device(device: int | None) -> None:
    if device is not None:
        torch.cuda.set_device(device)


def prefetch_iterator(it, depth: int = 2, device=None):
    """Run ANY iterator in a producer thread behind a bounded queue, so
    host-side work (JPEG decode / tokenize / packing) overlaps device
    compute. Yields exactly the wrapped iterator's items in order;
    producer exceptions re-raise at the consumer; abandoning the
    generator stops the producer (no thread leak). Composes with
    mixture_batches / packed_batch_iterator, which prefetch_batches'
    padded-only pipeline does not. Where frames for a model on `device` are
    tiled on the card, the producer works on the consumer's current CUDA
    device, taken when it starts."""
    import queue as queue_mod
    import threading

    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
    _END = object()
    stop = threading.Event()
    cuda_device = _tiling_cuda_device(device)

    def produce():
        try:
            _set_cuda_device(cuda_device)
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue
                if stop.is_set():
                    return
            item = _END
        except BaseException as exc:
            item = exc
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue_mod.Full:
                continue

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            with span("msm.data.wait"):
                item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def prefetch_batches(
    samples: Sequence[dict],
    tokenizer: SpatialTokenizer,
    model_cfg: MLLMConfig,
    image_loader: Callable[[str], np.ndarray],
    batch_size: int,
    config: DataConfig | None = None,
    drop_remainder: bool = True,
    num_workers: int | None = None,
    prefetch: int = 2,
    device=None,
) -> Iterator[dict]:
    """`batch_iterator` with the host work overlapped against device
    compute (JPEG decode, tiling and tokenizing are host-bound and must not
    starve the card).

    Worker threads run `encode_sample` (the native codec releases the
    GIL); results are consumed strictly in submission order, so batch
    composition is IDENTICAL to the synchronous iterator for any worker
    count (test-asserted). A producer thread keeps up to `prefetch`
    assembled batches queued ahead of the consumer. The native library
    (ingest/native: the JPEG codec an image loader reads through) and,
    where frames for a model on `device` are tiled on the card, the tiling
    kernel's (ops/tile_frames) are built and loaded here, in the calling
    thread, before any worker starts: their lazy builds take no lock, and
    two workers would race them. The workers then tile on the caller's
    current CUDA device.
    """
    import queue as queue_mod
    import threading
    from concurrent.futures import ThreadPoolExecutor

    config = config or DataConfig()
    if num_workers is None:
        num_workers = min(8, __import__("os").cpu_count() or 1)
    if num_workers <= 1:
        yield from batch_iterator(samples, tokenizer, model_cfg,
                                  image_loader, batch_size, config,
                                  drop_remainder, device)
        return

    from ..ingest import native

    native.native_available()
    cuda_device = _tiling_cuda_device(device)
    if cuda_device is not None:
        from ..ops import tile_frames

        tile_frames.build()
    out_q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
    _END = object()
    stop = threading.Event()  # set when the consumer abandons the iterator

    class _Abandoned(Exception):
        pass

    def put(item):
        # bounded put that aborts once the consumer is gone, so the
        # producer thread and its executor never leak
        while True:
            if stop.is_set():
                raise _Abandoned()
            try:
                out_q.put(item, timeout=0.1)
                return
            except queue_mod.Full:
                continue

    def produce():
        try:
            with ThreadPoolExecutor(max_workers=num_workers,
                                    initializer=_set_cuda_device,
                                    initargs=(cuda_device,)) as pool:
                window = 4 * num_workers
                futures: list = []
                buf_ids, buf_labels, buf_tiles = [], [], []

                def drain_one():
                    enc = futures.pop(0).result()
                    if enc is None:
                        return
                    input_ids, labels, tiles, _ = enc
                    buf_ids.append(input_ids)
                    buf_labels.append(labels)
                    buf_tiles.append(tiles)
                    if len(buf_ids) == batch_size:
                        put({
                            "input_ids": np.stack(buf_ids),
                            "labels": np.stack(buf_labels),
                            "tiles": np.stack(buf_tiles),
                        })
                        buf_ids.clear()
                        buf_labels.clear()
                        buf_tiles.clear()

                for sample in samples:
                    if stop.is_set():
                        raise _Abandoned()
                    futures.append(pool.submit(
                        encode_sample, sample, tokenizer, model_cfg,
                        image_loader, config, device))
                    if len(futures) >= window:
                        drain_one()
                while futures:
                    drain_one()
                if buf_ids and not drop_remainder:
                    put({
                        "input_ids": np.stack(buf_ids),
                        "labels": np.stack(buf_labels),
                        "tiles": np.stack(buf_tiles),
                    })
            put(_END)
        except _Abandoned:
            pass
        except BaseException as exc:  # surface worker failures
            try:
                put(exc)
            except _Abandoned:
                pass

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = out_q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()
