"""The port's cv2-free INTER_AREA (models/resize.py) and its preprocessing
against cv2 and the JAX package: `resize_area` is pixel-equal to
`cv2.resize(..., interpolation=cv2.INTER_AREA)` on each of cv2's three
code paths (whole-factor block means, fractional area weights, the
generic fixed-point path where an axis grows), and `tile_image`'s tiles
equal the JAX package's (which resizes with cv2) for the frame sizes the
model meets. The bound is zero: every case is exact.

The card's tiling kernel (ops/tile_frames.py, csrc/tile_frames.cu) is held
byte for byte to the numpy path, `preprocess._tile_image`, by the tests
marked `cuda`, which skip without a CUDA device; here, on the CPU, the
tables it reads (`resize.card_tables`) are checked for their layout, and
which path `tile_image` takes for a model on which device, and how it
counts. cv2 and the JAX
package are imported inside the tests that use them, so the file runs on
a machine without them (tests/conftest.py imports jax; skip it there):

    python -m pytest tests/test_torch_resize.py -m cuda --noconftest -q
"""

import json
import threading

import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu_torch.models import data as TD
from multi_spatialmllm_tpu_torch.models import preprocess as TPP
from multi_spatialmllm_tpu_torch.models import resize as TR
from multi_spatialmllm_tpu_torch.models.resize import resize_area
from multi_spatialmllm_tpu_torch.ops import tile_frames as TF

# (source h, w): a ScanNet frame, a 640 x 480 camera, a 1920 x 1440 one,
# and a source whose 3 x 2 grid and thumbnail are whole factors
SOURCES = [(968, 1296), (480, 640), (1440, 1920), (896, 1344)]
# the shapes tile_image asks for from those sources
TARGETS = [(896, 1344), (448, 448)]


def _frame(h, w, seed, cn=3):
    rng = np.random.default_rng(seed)
    shape = (h, w, cn) if cn > 1 else (h, w)
    if seed % 2:
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (96 + 80 * np.sin(xx / 37.0 + seed) * np.cos(yy / 23.0))
    img = base[..., None] + rng.normal(0, 6, size=(h, w, cn))
    return np.clip(img, 0, 255).astype(np.uint8).reshape(shape)


def _cv2(img, hw):
    import cv2

    return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("target", TARGETS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("source", SOURCES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_shapes_equal_cv2(source, target, seed):
    img = _frame(*source, seed)
    np.testing.assert_array_equal(resize_area(img, target), _cv2(img, target))


@pytest.mark.parametrize("path", ["fast", "area", "generic"])
def test_each_code_path_equals_cv2(path):
    """A sweep of random sizes and channel counts on one of cv2's paths:
    whole factors (2 x 2 rounds half up, others half to even), fractional
    shrinks, and sizes where an axis grows."""
    rng = np.random.default_rng({"fast": 1, "area": 2, "generic": 3}[path])
    for t in range(120):
        cn = (1, 3, 4)[t % 3]
        h, w, dh, dw = _path_case(path, rng)
        img = _frame(h, w, t, cn)
        want = _cv2(img, (dh, dw))
        got = resize_area(img, (dh, dw))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w, dh, dw)}")


def _path_case(path, rng):
    """(h, w, dh, dw) of a resize on one of cv2's paths: whole factors,
    fractional shrinks, or an axis that grows."""
    if path == "fast":
        dh, dw = rng.integers(1, 40, 2)
        fy, fx = rng.integers(1, 5, 2)
        if fy == fx == 1:
            fx = 2
        h, w = dh * fy, dw * fx
    elif path == "area":
        dh, dw = rng.integers(1, 60, 2)
        h = dh + rng.integers(0, 3 * dh)
        w = dw + rng.integers(1, 3 * dw + 1)
    else:
        h, w = rng.integers(1, 70, 2)
        dh = h + rng.integers(1, 60)
        dw = rng.integers(1, 130)
    return int(h), int(w), int(dh), int(dw)


def test_two_by_two_rounds_half_up_and_three_rounds_half_even():
    img = np.array([[0, 1, 1, 1], [1, 1, 0, 0]], np.uint8)   # sums 3 and 2
    np.testing.assert_array_equal(resize_area(img, (1, 2)), _cv2(img, (1, 2)))
    img = np.array([[1, 0, 0, 0, 1, 1]], np.uint8)          # 1/3, 2/3
    np.testing.assert_array_equal(resize_area(img, (1, 2)), _cv2(img, (1, 2)))


@pytest.mark.parametrize("resize_hw", [None, (968, 1296)],
                         ids=["serve", "reference"])
@pytest.mark.parametrize("source", SOURCES + [(300, 200), (448, 448)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_image_equals_the_jax_package(source, resize_hw):
    """tile_image on an RGB frame: the same float32 tiles as the JAX
    package's, at the serve/train config (no fixed resize) and at the
    reference's 968 x 1296 training size."""
    from multi_spatialmllm_tpu.models import preprocess as JP

    img = _frame(*source, sum(source))
    cfg_t = TPP.PreprocessConfig(resize_hw=resize_hw)
    cfg_j = JP.PreprocessConfig(resize_hw=resize_hw)
    got = TPP.tile_image(img, cfg_t)
    want = JP.tile_image(img, cfg_j)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        resize_area(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError):
        resize_area(np.zeros((4, 4), np.uint8), (0, 2))
    img = _frame(5, 7, 1)
    out = resize_area(img, (5, 7))
    np.testing.assert_array_equal(out, img)


# --------------------------------------------------------------------------
# The card's tiling kernel. On the CPU: the tables it reads, and which
# path tile_image takes for a model on which device, and how it counts.


def _assert_same_bytes(got, want):
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.flags.c_contiguous
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_area_path_at_the_cells_frame():
    """A 968 x 1296 frame: its 3 x 2 grid (896 x 1344) grows along x, so
    the generic path; its thumbnail shrinks by fractions; whole factors are
    block means, the same size a 1 x 1 block."""
    assert TR.area_path(968, 1296, 896, 1344) == (TR.GENERIC, None)
    assert TR.area_path(968, 1296, 448, 448)[0] == TR.AREA
    assert TR.area_path(896, 1344, 448, 448) == (TR.BLOCK, (2, 3))
    assert TR.area_path(1792, 2688, 896, 1344) == (TR.BLOCK, (2, 2))
    assert TR.area_path(448, 448, 448, 448) == (TR.BLOCK, (1, 1))


def _check_tables(h, w, dh, dw):
    """`card_tables` of h x w -> dh x dw: the header names the path
    `resize_area` takes, and the table holds, in the layout the kernel
    reads (the y table, then the x table), source indices inside the frame
    and each destination's weights summing to one."""
    header, table = TR.card_tables(h, w, dh, dw)
    path, arg = TR.area_path(h, w, dh, dw)
    assert header[:3] == [path, dh, dw]
    if path == TR.BLOCK:
        assert table is None and tuple(header[3:]) == arg
        assert (dh * arg[0], dw * arg[1]) == (h, w)
        return
    assert table.dtype == np.int32
    if path == TR.AREA:
        ky, kx = header[3:]
        assert table.size == 2 * (dh * ky + dw * kx)
        axes = [(h, table[:2 * dh * ky].reshape(2, dh, ky)),
                (w, table[2 * dh * ky:].reshape(2, dw, kx))]
        for ssize, (idx, bits) in axes:
            assert ((idx >= 0) & (idx < ssize)).all()
            np.testing.assert_allclose(bits.view(np.float32).sum(axis=1), 1,
                                       atol=2e-3)
        return
    assert header[3:] == [0, 0] and table.size == 4 * (dh + dw)
    for ssize, t in ((h, table[:4 * dh].reshape(dh, 4)),
                     (w, table[4 * dh:].reshape(dw, 4))):
        assert ((t[:, 0] >= 0) & (t[:, 0] < ssize)).all()
        np.testing.assert_array_equal(t[:, 1], np.minimum(t[:, 0] + 1,
                                                          ssize - 1))
        assert (t[:, 2:] >= 0).all() and (t[:, 2] + t[:, 3] == 2048).all()


@pytest.mark.parametrize("path", ["fast", "area", "generic"])
def test_card_tables_give_resize_area(path):
    """`card_tables` name the path `resize_area` takes and hold its
    tables in the layout the card's kernel reads."""
    rng = np.random.default_rng({"fast": 11, "area": 12, "generic": 13}[path])
    for _ in range(80):
        _check_tables(*_path_case(path, rng))


@pytest.mark.parametrize("target", TARGETS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("source", SOURCES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_card_tables_at_the_tile_shapes(source, target):
    _check_tables(*source, *target)
    _check_tables(*source, *source)                      # the same size


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def card_stub(monkeypatch):
    """A process with a CUDA device whose tiling kernel is a stub: each
    call's size, grid, tile, thumbnail and device are recorded, and it
    gives zero tiles of the kernel's shape."""
    calls = []

    def tile_frame(image, hw, rows, cols, tile, thumbnail, mean, std,
                   device):
        calls.append((tuple(hw), rows, cols, tile, thumbnail, device))
        return np.zeros((rows * cols + thumbnail, tile, tile, 3), np.float32)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(TF, "tile_frame", tile_frame)
    return calls


def test_tile_image_takes_the_host_path_without_cuda(no_card):
    img = _frame(968, 1296, 2)
    cfg = TPP.PreprocessConfig(resize_hw=None)
    host, card = TPP.HOST_TILED.frames, TF.TILE_FRAME.launches
    for k in range(3):
        _assert_same_bytes(TPP.tile_image(img, cfg), TPP._tile_image(img, cfg))
        assert TPP.HOST_TILED.frames == host + k + 1
    assert TF.TILE_FRAME.launches == card


@pytest.mark.parametrize("resize_hw", [None, (968, 1296)],
                         ids=["serve", "reference"])
@pytest.mark.parametrize("source", SOURCES + [(300, 200), (448, 448)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_image_takes_the_card_where_there_is_one(card_stub, source,
                                                      resize_hw):
    """With a CUDA device `tile_image` hands the frame to the kernel, on
    the current device, with the resize, the grid and the thumbnail of the
    numpy path, and counts nothing on the host."""
    img = _frame(*source, 7)
    cfg = TPP.PreprocessConfig(resize_hw=resize_hw)
    host = TPP.HOST_TILED.frames
    got = TPP.tile_image(img, cfg)
    want = TPP._tile_image(img, cfg)
    assert got.shape == want.shape and TPP.HOST_TILED.frames == host
    (hw, rows, cols, tile, thumbnail, device), = card_stub
    assert hw == (resize_hw or source) and tile == 448
    assert thumbnail == (rows * cols > 1)
    assert device == torch.device("cuda")


@pytest.mark.parametrize("device", [None, "cuda", "cuda:1", "cpu",
                                    torch.device("cpu"),
                                    torch.device("cuda", 0)], ids=str)
def test_tile_image_tiles_for_the_models_device(card_stub, device):
    """In a process with a card, frames for a model on the CPU are tiled
    in numpy and counted there; for a model on a CUDA device, on that
    device; with no device named, on the current CUDA device."""
    img = _frame(64, 96, 3)
    cfg = TPP.PreprocessConfig(tile_size=32, resize_hw=None)
    host = TPP.HOST_TILED.frames
    got = TPP.tile_image(img, cfg, device)
    want_device = torch.device(device or "cuda")
    if want_device.type == "cpu":
        assert card_stub == [] and TPP.HOST_TILED.frames == host + 1
        _assert_same_bytes(got, TPP._tile_image(img, cfg))
    else:
        assert [c[-1] for c in card_stub] == [want_device]
        assert TPP.HOST_TILED.frames == host


@pytest.fixture
def fake_device(monkeypatch):
    """A process whose current CUDA device is 7: the devices threads set
    are recorded with the thread; building the tiling library is recorded
    too."""
    events = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 7)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: events.append(
        ("set_device", d, threading.get_ident())))
    monkeypatch.setattr(TF, "build", lambda: events.append(
        ("build", None, threading.get_ident())))
    monkeypatch.setattr(TD, "tile_image",
                        lambda img, cfg, device=None: TPP._tile_image(img, cfg))
    return events


def test_prefetch_iterator_producer_takes_the_callers_device(fake_device):
    def items():
        for i in range(3):
            yield i, threading.get_ident()

    got = list(TD.prefetch_iterator(items(), depth=1))
    assert [i for i, _ in got] == [0, 1, 2]
    producer = got[0][1]
    assert producer != threading.get_ident()
    assert fake_device == [("set_device", 7, producer)]


def _tiny_records(n):
    rng = np.random.default_rng(3)
    recs = []
    for i in range(n):
        k = int(rng.integers(1, 3))
        recs.append({"id": f"r{i}", "image": [f"img{j % 4}" for j in
                                              range(i, i + k)],
                     "conversations": [
                         {"from": "human",
                          "value": "<image>\n" * k + "How far apart?"},
                         {"from": "gpt", "value": f"`{i + 1}` m"}]})
    return recs


def _tiny_setup():
    from multi_spatialmllm_tpu_torch.models import mllm as TM
    from multi_spatialmllm_tpu_torch.models import tokenizer as TT

    return TM.tiny_config(), TT.SpatialTokenizer(), TD.DataConfig(
        max_seq_len=160, max_tiles=4, preprocess=TPP.PreprocessConfig(
            tile_size=56, max_tiles=2, resize_hw=None))


def _tiny_loader(path):
    k = int(path[-1])
    return _frame(56 * (1 + k % 2), 56 + 8 * k, k)


def test_prefetch_batches_workers_take_the_callers_device(fake_device):
    """The tiling library is built in the calling thread before any
    worker starts, and each worker sets the caller's device; the batches
    are the synchronous iterator's."""
    mcfg, tok, dcfg = _tiny_setup()
    recs = _tiny_records(9)
    want = list(TD.batch_iterator(recs, tok, mcfg, _tiny_loader, 2, dcfg))
    got = list(TD.prefetch_batches(recs, tok, mcfg, _tiny_loader, 2, dcfg,
                                   num_workers=3))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in w:
            assert g[k].tobytes() == w[k].tobytes(), k
    kinds = [(kind, d) for kind, d, _ in fake_device]
    assert kinds[0] == ("build", None)
    assert fake_device[0][2] == threading.get_ident()
    workers = {t for kind, _, t in fake_device if kind == "set_device"}
    assert kinds[1:] == [("set_device", 7)] * len(workers)
    assert 1 <= len(workers) <= 3 and threading.get_ident() not in workers


@pytest.fixture
def card_untouched(monkeypatch):
    """A process with a CUDA device that must not be touched: asking for
    or setting the current device, or building the tiling library, fails;
    `tile_image` records the device it is given and tiles in numpy."""
    def touched(*_):
        raise AssertionError("the card was touched for a model on the CPU")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", touched)
    monkeypatch.setattr(torch.cuda, "set_device", touched)
    monkeypatch.setattr(TF, "build", touched)
    devices = []

    def tile_image(img, cfg, device=None):
        devices.append(device)
        return TPP._tile_image(img, cfg)

    monkeypatch.setattr(TD, "tile_image", tile_image)
    return devices


@pytest.mark.parametrize("feed", ["batch_iterator", "packed_batch_iterator",
                                  "prefetch_batches", "prefetch_iterator",
                                  "mixture_batches"])
def test_feed_for_a_cpu_model_stays_off_the_card(card_untouched, feed,
                                                 tmp_path):
    """Each train feed hands a CPU model's device to `tile_image` for every
    frame and, in a process with a card, neither builds the tiling library
    nor sets a thread's device."""
    from multi_spatialmllm_tpu_torch.models import mixture as TMX

    mcfg, tok, dcfg = _tiny_setup()
    recs = _tiny_records(9)
    args = (tok, mcfg, _tiny_loader, 2, dcfg)
    if feed == "prefetch_batches":
        batches = TD.prefetch_batches(recs, *args, num_workers=3,
                                      device="cpu")
    elif feed == "prefetch_iterator":
        batches = TD.prefetch_iterator(
            TD.batch_iterator(recs, *args, device="cpu"), device="cpu")
    elif feed == "mixture_batches":
        ann = tmp_path / "mix.jsonl"
        ann.write_text("".join(json.dumps(r) + "\n" for r in recs))
        batches = TMX.mixture_batches(
            [TMX.MixtureEntry("mix", str(ann))], *args, epochs=1,
            packed=True, device="cpu")
    else:
        batches = getattr(TD, feed)(recs, *args, device="cpu")
    assert len(list(batches)) >= 2
    frames = sum(len(r["image"]) for r in recs)
    assert card_untouched == ["cpu"] * frames


def test_eval_for_a_cpu_model_tiles_on_the_host(card_stub):
    """The eval runner tiles a sample's frames for the model's device: in
    numpy for a model on the CPU, in a process with a card."""
    from multi_spatialmllm_tpu_torch.models import runner as TRN

    _, _, dcfg = _tiny_setup()
    host = TPP.HOST_TILED.frames
    tiles, per_image = TRN._tiles({"image": ["img1", "img2"]}, _tiny_loader,
                                  TRN.EvalRunConfig(data=dcfg),
                                  torch.device("cpu"))
    assert card_stub == [] and TPP.HOST_TILED.frames == host + 2
    assert tiles.shape[0] == sum(per_image)


# --------------------------------------------------------------------------
# On the card (marked `cuda`; they skip without a CUDA device): the kernel's
# tiles byte-equal to the numpy path's.


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    TF.build()
    return torch.device("cuda")


def _card_against_numpy(img, cfg):
    """tile_image on the card against the numpy path: the same bytes, one
    launch of the tiling kernel and nothing tiled on the host."""
    launches, host = TF.TILE_FRAME.launches, TPP.HOST_TILED.frames
    got = TPP.tile_image(img, cfg)
    assert TF.TILE_FRAME.launches == launches + 1
    assert TPP.HOST_TILED.frames == host
    _assert_same_bytes(got, TPP._tile_image(img, cfg))


@pytest.mark.cuda
def test_card_tiles_the_cells_frame(dev):
    """The benchmark cells' frame: 968 x 1296, 6 tiles, no fixed resize
    (the 3 x 2 grid on the generic path, the thumbnail on the area path),
    on a smooth frame and a noisy one."""
    cfg = TPP.PreprocessConfig(max_tiles=6, resize_hw=None)
    for seed in (0, 1):
        _card_against_numpy(_frame(968, 1296, seed), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("source", SOURCES[1:] + [(300, 200), (448, 448),
                                                  (1080, 1920)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_card_resize_hw_from_other_sizes(dev, source):
    """A fixed resize to 968 x 1296 first (`resize_frame`), then the
    tiles."""
    cfg = TPP.PreprocessConfig(resize_hw=(968, 1296))
    _card_against_numpy(_frame(*source, sum(source)), cfg)


# (source, tile size, max tiles): the grid's and the thumbnail's paths
PATH_CASES = {
    "grid_same_size_thumb_block_2x3": ((64, 96), 32, 6),
    "grid_block_2x2_thumb_block_4x6": ((128, 192), 32, 6),
    "grid_block_3x1_thumb_block_6x3": ((192, 96), 32, 2),
    "grid_area_thumb_area": ((100, 150), 32, 6),
    "grid_generic_thumb_generic": ((50, 70), 32, 6),
    "grid_generic_thumb_area": ((968, 1296), 448, 6),
    "one_tile_no_thumb": ((300, 330), 448, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", PATH_CASES)
def test_card_each_inter_area_path(dev, case):
    source, tile, max_tiles = PATH_CASES[case]
    for seed in (0, 1):
        img = _frame(*source, seed)
        cfg = TPP.PreprocessConfig(tile_size=tile, max_tiles=max_tiles,
                                   resize_hw=None)
        _card_against_numpy(img, cfg)
    for path in ("fast", "area", "generic"):     # resize_frame on each path
        rng = np.random.default_rng(len(case))
        for t in range(6):
            h, w, dh, dw = _path_case(path, rng)
            cfg = TPP.PreprocessConfig(tile_size=16, max_tiles=4,
                                       resize_hw=(dh, dw))
            _card_against_numpy(_frame(h, w, t), cfg)


@pytest.mark.cuda
def test_card_random_sizes(dev):
    rng = np.random.default_rng(22)
    for t in range(48):
        h, w = (int(v) for v in rng.integers(1, 1400, 2))
        tile = 448 if t % 4 == 0 else int(rng.integers(8, 97))
        resize_hw = (None if t % 3 else
                     tuple(int(v) for v in rng.integers(1, 1400, 2)))
        cfg = TPP.PreprocessConfig(
            tile_size=tile, max_tiles=int(rng.integers(1, 13)),
            use_thumbnail=bool(t % 5), resize_hw=resize_hw)
        _card_against_numpy(_frame(h, w, t), cfg)


@pytest.mark.cuda
def test_card_two_threads_at_once(dev):
    """Two threads tiling at once, each on its own stream, get the numpy
    path's bytes."""
    cfg = TPP.PreprocessConfig(resize_hw=None)
    frames = [_frame(*((968, 1296) if i % 2 else (480, 640)), i)
              for i in range(8)]
    want = [TPP._tile_image(f, cfg) for f in frames]
    got, errors = [None] * len(frames), []
    start = threading.Barrier(2)

    def work(first):
        try:
            start.wait(timeout=60)
            for i in range(first, len(frames), 2):
                got[i] = TPP.tile_image(frames[i], cfg)
        except BaseException as exc:  # noqa: BLE001 (re-raised below)
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for g, w in zip(got, want):
        _assert_same_bytes(g, w)


@pytest.mark.cuda
def test_card_feed_threads_take_the_callers_device(dev):
    """Threads started after the caller set a device (the last one) tile
    on that device: `prefetch_iterator`'s producer and `prefetch_batches`'
    workers."""
    last, first = torch.cuda.device_count() - 1, torch.cuda.current_device()
    cfg = TPP.PreprocessConfig(resize_hw=None)
    frames = [_frame(968, 1296, 3), _frame(300, 200, 4)]
    mcfg, tok, dcfg = _tiny_setup()
    recs = _tiny_records(9)
    want = list(TD.batch_iterator(recs, tok, mcfg, _tiny_loader, 2, dcfg,
                                  device="cpu"))            # in numpy
    torch.cuda.set_device(last)
    try:
        def produce():
            for f in frames:
                yield torch.cuda.current_device(), TPP.tile_image(f, cfg)

        got = list(TD.prefetch_iterator(produce(), depth=1))
        for (device, tiles), f in zip(got, frames):
            assert device == last
            _assert_same_bytes(tiles, TPP._tile_image(f, cfg))
        seen = []

        def loader(path):
            seen.append(torch.cuda.current_device())
            return _tiny_loader(path)

        launches = TF.TILE_FRAME.launches
        batches = list(TD.prefetch_batches(recs, tok, mcfg, loader, 2, dcfg,
                                           num_workers=3))
        assert TF.TILE_FRAME.launches > launches
        assert seen and set(seen) == {last}
        assert len(batches) == len(want)
        for g, w in zip(batches, want):
            for k in w:
                assert g[k].tobytes() == w[k].tobytes(), k
    finally:
        torch.cuda.set_device(first)
