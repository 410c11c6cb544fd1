"""The port's host-side data path (tokenizer, image tiling, batch assembly,
mixture streaming) against the JAX package: token ids, tiles and batches
must be byte-equal, and the mixture must stream the same records in the
same order. Records and images are made from fixed numpy seeds."""

import json

import numpy as np
import pytest

from multi_spatialmllm_tpu.models import data as JD
from multi_spatialmllm_tpu.models import mixture as JX
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.models import preprocess as JP
from multi_spatialmllm_tpu.models import tokenizer as JT
from multi_spatialmllm_tpu_torch.core import rng as TRNG
from multi_spatialmllm_tpu_torch.models import data as TD
from multi_spatialmllm_tpu_torch.models import mixture as TX
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import preprocess as TP
from multi_spatialmllm_tpu_torch.models import tokenizer as TT


def test_tokenizer_ids_equal_on_every_template_string():
    jt, tt = JT.SpatialTokenizer(), TT.SpatialTokenizer()
    assert tt.tokens == jt.tokens
    assert (tt.pad_id, tt.bos_id, tt.eos_id, tt.img_context_id) == \
        (jt.pad_id, jt.bos_id, jt.eos_id, jt.img_context_id)
    corpus = JT._template_corpus()
    assert TT._template_corpus() == corpus
    for text in corpus + ["<|human|>Image-1: <image>\nhéllo 12 mm?</s>"]:
        ids = tt.encode(text, add_bos=True, add_eos=True)
        assert ids == jt.encode(text, add_bos=True, add_eos=True), text
        assert tt.decode(ids) == jt.decode(ids)
    for name in ("PAD", "BOS", "EOS", "IMG_CONTEXT", "IMG_START", "IMG_END",
                 "HUMAN", "ASSISTANT", "SPECIAL_TOKENS"):
        assert getattr(TT, name) == getattr(JT, name), name


def test_rng_stream_matches_jax_package():
    from multi_spatialmllm_tpu.core.rng import stream

    for names in (("mixture", "order", 0), ("mixture", "spa", "fraction", 3)):
        np.testing.assert_array_equal(
            TRNG.stream(7, *names).permutation(50),
            stream(7, *names).permutation(50))


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("hw,max_tiles", [((448, 448), 6), ((300, 520), 6),
                                          ((64, 96), 2)])
def test_tile_image_matches_jax(hw, max_tiles):
    img = _image(1, *hw)
    jc = JP.PreprocessConfig(max_tiles=max_tiles, resize_hw=None)
    tc = TP.PreprocessConfig(max_tiles=max_tiles, resize_hw=None)
    want = JP.tile_image(img, jc)
    got = TP.tile_image(img, tc)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_at_the_target_size_is_cv2s_identity():
    """The port skips OpenCV when an image already has the target size:
    INTER_AREA at scale 1 returns the input unchanged."""
    import cv2

    img = _image(2, 448, 448)
    ref = cv2.resize(img, (448, 448), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(ref, img)
    assert TP._resize(img, (448, 448)) is img


def _records(seed, n):
    rng = np.random.default_rng(seed)
    questions = ["How far did the camera move?",
                 "Which point in Image-2 matches the dot?",
                 "Estimate the depth of the marked point, in mm."]
    recs = []
    for i in range(n):
        n_img = int(rng.integers(0, 3))
        conv = [{"from": "human",
                 "value": "".join("<image>\n" for _ in range(n_img))
                 + questions[i % 3]},
                {"from": "gpt", "value": f"`{int(rng.integers(1, 999))}` mm"}]
        if i % 4 == 3:   # a second turn
            conv += [{"from": "human", "value": "And the direction?"},
                     {"from": "gpt", "value": "Forward and to the left."}]
        rec = {"id": f"r{i}", "conversations": conv}
        if n_img:
            rec["image"] = [f"img{int(rng.integers(0, 4))}.png"
                            for _ in range(n_img)]
        recs.append(rec)
    return recs


def _loader(path):
    seed = int(path.split("img")[-1].split(".")[0])
    return _image(10 + seed, 56 * (1 + seed % 2), 56)


def _setup():
    jcfg, tcfg = JM.tiny_config(), TM.tiny_config()
    data_j = JD.DataConfig(max_seq_len=160, max_tiles=4,
                           preprocess=JP.PreprocessConfig(
                               tile_size=56, max_tiles=2, resize_hw=None))
    data_t = TD.DataConfig(max_seq_len=160, max_tiles=4,
                           preprocess=TP.PreprocessConfig(
                               tile_size=56, max_tiles=2, resize_hw=None))
    return (jcfg, data_j, JT.SpatialTokenizer()), \
        (tcfg, data_t, TT.SpatialTokenizer())


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


def test_encode_and_pack_match_jax():
    (jcfg, dj, jt), (tcfg, dt, tt) = _setup()
    recs = _records(3, 12)
    enc_j = [JD.encode_unpadded(r, jt, jcfg, _loader, dj) for r in recs]
    enc_t = [TD.encode_unpadded(r, tt, tcfg, _loader, dt) for r in recs]
    assert sum(e is None for e in enc_t) == sum(e is None for e in enc_j)
    for a, b in zip(enc_t, enc_j):
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for r in recs[:4]:
        a = TD.encode_sample(r, tt, tcfg, _loader, dt)
        b = JD.encode_sample(r, jt, jcfg, _loader, dj)
        assert a[3] == b[3]
        for x, y in zip(a[:3], b[:3]):
            assert x.tobytes() == y.tobytes()
    _assert_batches_equal(TD.pack_samples(enc_t, dt, tt.pad_id),
                          JD.pack_samples(enc_j, dj, jt.pad_id))


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_batch_iterators_match_jax(packed):
    (jcfg, dj, jt), (tcfg, dt, tt) = _setup()
    recs = _records(4, 16)
    make_j = JD.packed_batch_iterator if packed else JD.batch_iterator
    make_t = TD.packed_batch_iterator if packed else TD.batch_iterator
    want = make_j(recs, jt, jcfg, _loader, 2, dj, drop_remainder=False)
    got = TD.prefetch_iterator(
        make_t(recs, tt, tcfg, _loader, 2, dt, drop_remainder=False))
    _assert_batches_equal(got, want)


@pytest.fixture
def meta_path(tmp_path):
    names = {"spa": 7, "general": 5}
    meta = {}
    for i, (name, n) in enumerate(names.items()):
        with open(tmp_path / f"{name}.jsonl", "w") as f:
            for rec in _records(20 + i, n):
                f.write(json.dumps(rec) + "\n")
        meta[name] = {"root": f"imgs_{name}", "annotation": f"{name}.jsonl",
                      "repeat_time": 1.5 if name == "spa" else 0.6,
                      "length": n}
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(meta))
    return str(path)


@pytest.mark.parametrize("shard,num", [(0, 1), (0, 2), (1, 2)])
def test_mixture_samples_order_matches_jax(meta_path, shard, num):
    ej, et = JX.load_meta(meta_path), TX.load_meta(meta_path)
    assert [(e.name, e.annotation, e.root, e.repeat_time) for e in et] == \
        [(e.name, e.annotation, e.root, e.repeat_time) for e in ej]
    want = list(JX.mixture_samples(ej, seed=5, epochs=2, shard_index=shard,
                                   num_shards=num))
    got = list(TX.mixture_samples(et, seed=5, epochs=2, shard_index=shard,
                                  num_shards=num))
    assert got == want and len(got) > 10
    assert TX.mixture_stats(et) == JX.mixture_stats(ej)


def test_mixture_batches_and_validation_match_jax(meta_path):
    ej, et = JX.load_meta(meta_path), TX.load_meta(meta_path)
    (jcfg, dj, jt), (tcfg, dt, tt) = _setup()

    def loader(path):
        return _loader(path.rsplit("/", 1)[-1])

    want = JX.mixture_batches(ej, jt, jcfg, loader, 2, dj, seed=1,
                              epochs=1, packed=True)
    got = TX.mixture_batches(et, tt, tcfg, loader, 2, dt, seed=1, epochs=1,
                             packed=True)
    _assert_batches_equal(got, want)
    assert TX.validate_mixture(et, loader, sample=3) == \
        JX.validate_mixture(ej, loader, sample=3)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_prefetch_batches_equal_the_synchronous_iterator_and_jax(workers):
    """`prefetch_batches` (worker threads in submission order; one worker
    is `batch_iterator` itself) yields byte-identical batches, in order, to
    the port's synchronous iterator and to the JAX package's
    `prefetch_batches` at the same worker count."""
    (jcfg, dj, jt), (tcfg, dt, tt) = _setup()
    recs = _records(5, 11)
    sync = list(TD.batch_iterator(recs, tt, tcfg, _loader, 3, dt,
                                  drop_remainder=False))
    got = list(TD.prefetch_batches(recs, tt, tcfg, _loader, 3, dt,
                                   drop_remainder=False, num_workers=workers,
                                   prefetch=2))
    assert len(got) >= 3
    _assert_batches_equal(got, sync)
    _assert_batches_equal(got, JD.prefetch_batches(
        recs, jt, jcfg, _loader, 3, dj, drop_remainder=False,
        num_workers=workers, prefetch=2))


def test_prefetch_batches_reraise_a_loader_error():
    tcfg, dt, tt = _setup()[1]

    def bad_loader(path):
        raise FileNotFoundError(path)

    recs = [r for r in _records(5, 11) if "image" in r]
    with pytest.raises(FileNotFoundError):
        list(TD.prefetch_batches(recs, tt, tcfg, bad_loader, 1, dt,
                                 num_workers=4))


def test_abandoned_prefetch_batches_end_their_threads():
    """Closing the generator after one batch stops the producer and its
    workers instead of leaving them blocked on the bounded queue."""
    import threading
    import time

    tcfg, dt, tt = _setup()[1]
    before = threading.active_count()
    it = TD.prefetch_batches(_records(6, 40), tt, tcfg, _loader, 2, dt,
                             num_workers=4, prefetch=1)
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
