"""The port's TAPVid object-movement engines
(multi_spatialmllm_tpu_torch/engines/object_movement.py) against the JAX
engines on the CPU: M5 (the smoothed pair-distance sum) bit-equal to the
JAX program at T <= 22 and within M5_ULP of it at T 24, 33 and 64 with
equal rigid-body groups over 12 seeds; the JSONL of both question types,
coord and dot, train and eval (the `_orig` dump included) byte-equal
through `generate` and through `generate_to_jsonl` with the native and the
Python emitter, with the re-encoded frames and annotated JPEGs (which the
JAX engine writes with cv2) byte-equal; the circle pixel-equal to
`cv2.circle`; `make_tapvid_npz` records equal to JAX's; and no cv2
fallback where the native codec cannot be built."""

import itertools
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from multi_spatialmllm_tpu.core.synthetic import make_tapvid_npz as jmake
from multi_spatialmllm_tpu.engines import object_movement as JOM
from multi_spatialmllm_tpu_torch.core.synthetic import make_tapvid_npz as tmake
from multi_spatialmllm_tpu_torch.engines import object_movement as TOM
from multi_spatialmllm_tpu_torch.engines.draw import circle
from multi_spatialmllm_tpu_torch.ingest import native

# The JAX program's sum over frames leaves frame order from T 24 on (LLVM
# vectorises XLA's CPU loop over frames); the gap measured over the 12
# seeds below at T 24, 33 and 64 (bench.py's record shape, N 60) is at
# most 4 ulp.
M5_ULP = 4
BENCH_SHAPE = dict(n_groups=4, points_per_group=10, n_static=20)


def _jax_m5(points):
    t, n, _ = points.shape
    return np.asarray(JOM._cumulative_loss_fn(t, n)(
        jnp.asarray(points.astype(np.float32))))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("n_frames,shape", [
    (12, {}), (8, {}), (22, {}), (12, BENCH_SHAPE)],
    ids=["demo", "T8", "T22", "T12-N60"])
def test_m5_bit_equal_to_jax(n_frames, shape):
    for seed in range(3):
        rec = jmake(seed=50 + seed, n_frames=n_frames, **shape)
        got = TOM.cumulative_loss(rec["tracks_XYZ"], "cpu")
        want = _jax_m5(rec["tracks_XYZ"])
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_m5_chunks_do_not_change_bits(monkeypatch):
    """Frames in chunks of one [N, N] plane, of two, or all at once."""
    pts = jmake(seed=3, n_frames=22)["tracks_XYZ"]
    whole = TOM.cumulative_loss(pts, "cpu")
    n = pts.shape[1]
    for pairs in (n * n, 2 * n * n):
        monkeypatch.setattr(TOM, "M5_CHUNK_PAIRS", pairs)
        np.testing.assert_array_equal(TOM.cumulative_loss(pts, "cpu"), whole)


@pytest.mark.parametrize("n_frames", [24, 33, 64])
def test_m5_within_its_bound_and_groups_equal(n_frames):
    for seed in range(12):
        pts = jmake(seed=seed, n_frames=n_frames, **BENCH_SHAPE)["tracks_XYZ"]
        gap = _ulps(TOM.cumulative_loss(pts, "cpu"), _jax_m5(pts))
        assert gap.max() <= M5_ULP, (seed, int(gap.max()))
        assert (TOM.rigid_body_segmentation(pts, device="cpu")
                == JOM.rigid_body_segmentation(pts)), seed


def test_records_equal_jax():
    for seed in (50, 51):
        j, t = jmake(seed=seed), tmake(seed=seed)
        assert sorted(j) == sorted(t)
        for k in j:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
            assert all(a == b for a, b in zip(j[k].ravel(), t[k].ravel())), k


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def records():
    return {f"demo_seq{i}": jmake(seed=50 + i) for i in range(2)}


@pytest.fixture(scope="module")
def jax_runs(records, tmp_path_factory):
    """The JAX engine's tree for each (question type, dot, eval, entry)."""
    base = tmp_path_factory.mktemp("jax_om")
    native.build()   # (the port's library, which the port's runs use)
    out = {}
    for qtype, dot, ev, fn in itertools.product(
            JOM.QUESTION_TYPES, (False, True), (False, True),
            ("generate", "generate_to_jsonl")):
        root = base / f"{qtype}_{dot}_{ev}_{fn}"
        getattr(JOM, fn)(
            records, str(root / "out.jsonl"),
            JOM.ObjectMovementConfig(question_type=qtype, dot_variant=dot),
            img_output_dir=str(root / "images"),
            max_samples=10 if ev else -1, eval_mode=ev)
        out[(qtype, dot, ev, fn)] = _files(root)
    return out


@pytest.mark.parametrize("path", ["generate", "native", "python"])
@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("dot", [False, True], ids=["coord", "dot"])
@pytest.mark.parametrize("qtype", JOM.QUESTION_TYPES)
def test_jsonl_and_jpegs_byte_equal(records, jax_runs, tmp_path, qtype, dot,
                                    split, path):
    ev = split == "eval"
    fn = "generate" if path == "generate" else "generate_to_jsonl"
    kw = {} if path == "generate" else {"force_python": path == "python"}
    res = getattr(TOM, fn)(
        records, str(tmp_path / "out.jsonl"),
        TOM.ObjectMovementConfig(question_type=qtype, dot_variant=dot),
        img_output_dir=str(tmp_path / "images"),
        max_samples=10 if ev else -1, eval_mode=ev, device="cpu", **kw)
    got, want = _files(tmp_path), jax_runs[(qtype, dot, ev, fn)]
    assert sorted(got) == sorted(want)
    for rel, data in want.items():
        assert got[rel] == data, rel
    assert ("out_orig.jsonl" in got) == ev
    jpgs = [r for r in got if r.endswith(".jpg")]
    assert jpgs and any("_annotated" in r for r in jpgs) == dot
    assert (res.n_val if ev else res.n_train) == len(
        got["out.jsonl"].splitlines())


def test_circle_equals_cv2():
    h, w = 64, 96
    for r in range(1, 41):
        xs = {-r - 1, -r, -1, 0, r, w // 2, w - r - 1, w - 1, w, w + r,
              w + r + 1}
        ys = {-r - 1, -r, -1, 0, r, h // 2, h - r - 1, h - 1, h, h + r,
              h + r + 1}
        for x, y in itertools.product(sorted(xs), sorted(ys)):
            want = np.zeros((h, w, 3), np.uint8)
            cv2.circle(want, (x, y), r, (17, 200, 63), -1)
            got = circle(np.zeros((h, w, 3), np.uint8), (x, y), r,
                         (17, 200, 63))
            np.testing.assert_array_equal(got, want, err_msg=f"{r} {x} {y}")


def test_no_cv2_fallback_without_the_native_codec(records, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "build_error", "g++: not found")
    with pytest.raises(RuntimeError, match="native JPEG codec"):
        TOM.generate_to_jsonl(records, str(tmp_path / "o.jsonl"),
                              device="cpu")
