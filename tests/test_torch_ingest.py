"""The port's ScanNet ingest against the JAX package's, on the same
numpy-seeded inputs: the PLY reader and exports, the `.sens` reader and
posed-image export (the JAX one writes its PNGs with cv2), the scene packs
of `scene_from_sens`, the reference layout both ways, the directory image
provider, `host_shard`, the native inflate's refusals, and the
`ingest-scannet`, `ingest-sens` and `coverage` commands against the JAX
CLI's, byte for byte, on the CPU."""

import os
import pickle
import sys
import zlib

import cv2
import numpy as np
import pytest

from multi_spatialmllm_tpu import __main__ as jcli
from multi_spatialmllm_tpu.core import scene as JS
from multi_spatialmllm_tpu.core import synthetic as JSyn
from multi_spatialmllm_tpu.engines import annotate as JA
from multi_spatialmllm_tpu.ingest import native as JN
from multi_spatialmllm_tpu.ingest import ply as JPly
from multi_spatialmllm_tpu.ingest import posed_images as JPI
from multi_spatialmllm_tpu.ingest import scannet_export as JSE
from multi_spatialmllm_tpu.ingest import sens as JSens
from multi_spatialmllm_tpu_torch import __main__ as tcli
from multi_spatialmllm_tpu_torch.core import scene as TS
from multi_spatialmllm_tpu_torch.core import synthetic as TSyn
from multi_spatialmllm_tpu_torch.engines import annotate as TA
from multi_spatialmllm_tpu_torch.ingest import native as TN
from multi_spatialmllm_tpu_torch.ingest import ply as TPly
from multi_spatialmllm_tpu_torch.ingest import posed_images as TPI
from multi_spatialmllm_tpu_torch.ingest import scannet_export as TSE
from multi_spatialmllm_tpu_torch.ingest import sens as TSens
from multi_spatialmllm_tpu_torch.ingest.synthetic_scan import write_scan
from multi_spatialmllm_tpu_torch.parallel.distributed import host_shard

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ingest import _make_scan_fixture, _make_sens_fixture  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX package's inflate needs its library built, else it falls
    back to Python's zlib (equal bytes, but not the path under test)."""
    JN.build()


def _tree(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for k in ta:
        assert ta[k] == tb[k], k


def _pickle_bytes(obj):
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_and_exports_equal_jax(tmp_path, binary):
    rng = np.random.default_rng(11)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, size=(300, 3)).astype(np.uint8)
    for mod, name in ((JPly, "j.ply"), (TPly, "t.ply")):
        mod.write_ply_vertices(str(tmp_path / name), xyz, rgb, binary=binary)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    a = JPly.read_mesh_vertices_rgb(str(tmp_path / "j.ply"))
    b = TPly.read_mesh_vertices_rgb(str(tmp_path / "j.ply"))
    assert a.dtype == b.dtype and np.array_equal(a, b)

    scan, scan_dir, *_ = _make_scan_fixture(tmp_path, rng)
    paths = [os.path.join(scan_dir, f"{scan}{s}") for s in (
        "_vh_clean_2.ply", ".aggregation.json",
        "_vh_clean_2.0.010000.segs.json", ".txt")]
    labels = str(tmp_path / "labels.tsv")
    ja = JSE.export_scene_arrays(*paths, JSE.read_label_mapping(labels))
    ta = TSE.export_scene_arrays(*paths, TSE.read_label_mapping(labels))
    assert _pickle_bytes(ja) == _pickle_bytes(ta)
    JSE.batch_export([scan_dir], str(tmp_path / "jo"), labels,
                     str(tmp_path / "jo.pkl"))
    TSE.batch_export([scan_dir], str(tmp_path / "to"), labels,
                     str(tmp_path / "to.pkl"))
    _assert_same_tree(tmp_path / "jo", tmp_path / "to")
    assert (tmp_path / "jo.pkl").read_bytes() == \
        (tmp_path / "to.pkl").read_bytes()


def test_sens_reader_and_export_equal_jax(tmp_path):
    """read_sens frames, the colour decode (cv2's IMREAD_COLOR pixels) and
    export_posed_images' whole tree (JAX: depth PNGs by cv2.imwrite) at
    frame_skip 1 and 2, with the native inflate on both sides."""
    path = str(tmp_path / "s.sens")
    _make_sens_fixture(path, np.random.default_rng(2), n_frames=9,
                       color_hw=(48, 64), depth_hw=(24, 32))
    jh, jf = JSens.read_sens(path)
    th, tf = TSens.read_sens(path)
    assert _pickle_bytes(vars(jh)) == _pickle_bytes(vars(th))
    for a, b in zip(jf, tf):
        assert a.color_jpeg == b.color_jpeg and a.depth_zlib == b.depth_zlib
        assert np.array_equal(a.camera_to_world, b.camera_to_world)
        np.testing.assert_array_equal(b.color_bgr(), a.color_bgr())
    for skip in (1, 2):
        jd, td = (str(tmp_path / f"{w}{skip}" / "scene0001_00")
                  for w in "jt")
        nj = JSens.export_posed_images(path, jd, skip)
        nt = TSens.export_posed_images(path, td, skip)
        assert nj == nt
        _assert_same_tree(jd, td)
        ji, ti = JPI.build_images_info(jd, 1), TPI.build_images_info(td, 1)
        assert _pickle_bytes(ji) == _pickle_bytes(ti)


def test_synthetic_sens_equals_jax(tmp_path):
    """make_synthetic_sens (the bench's ingest input) encodes its q90
    frames with the native codec: the stream is byte-equal to the JAX
    package's, which encodes with cv2."""
    for mod, name in ((JSyn, "j.sens"), (TSyn, "t.sens")):
        mod.make_synthetic_sens(str(tmp_path / name), n_frames=4,
                                image_hw=(60, 80), depth_hw=(30, 40), seed=5)
    assert (tmp_path / "j.sens").read_bytes() == \
        (tmp_path / "t.sens").read_bytes()


@pytest.mark.parametrize("skip", [1, 3])
def test_scene_from_sens_pack_equals_jax(tmp_path, skip):
    rng = np.random.default_rng(4)
    scan, scan_dir, *_ = _make_scan_fixture(tmp_path, rng, n_verts=400)
    path = os.path.join(scan_dir, f"{scan}.sens")
    _make_sens_fixture(path, rng, n_frames=8, color_hw=(36, 52),
                       depth_hw=(18, 26))
    paths = [os.path.join(scan_dir, f"{scan}{s}") for s in (
        "_vh_clean_2.ply", ".aggregation.json",
        "_vh_clean_2.0.010000.segs.json", ".txt")]
    js = JPI.scene_from_sens(path, scan, JSE.export_scene_arrays(*paths),
                             frame_skip=skip)
    ts = TPI.scene_from_sens(path, scan, TSE.export_scene_arrays(*paths),
                             frame_skip=skip)
    js.save_npz(str(tmp_path / "j.npz"))
    ts.save_npz(str(tmp_path / "t.npz"))
    assert (tmp_path / "j.npz").read_bytes() == (tmp_path / "t.npz").read_bytes()


def test_reference_layout_both_ways_equals_jax(tmp_path):
    """save_reference_layout (JPEGs at cv2.imwrite's q95, depth PNGs)
    writes the JAX package's files; load_reference_scene reads each
    package's layout into equal scenes."""
    scene = JSyn.make_scene(n_images=5, n_background=800, image_hw=(40, 56),
                            depth_hw=(20, 28), seed=3)
    scene.save_npz(str(tmp_path / "s.npz"))
    tsc = TS.Scene.load_npz(str(tmp_path / "s.npz"))
    jinfo = scene.save_reference_layout(str(tmp_path / "j"))
    tinfo = tsc.save_reference_layout(str(tmp_path / "t"))
    assert _pickle_bytes(jinfo) == _pickle_bytes(tinfo)
    _assert_same_tree(tmp_path / "j", tmp_path / "t")
    for root in ("j", "t"):
        base = str(tmp_path / root)
        args = (jinfo, scene.scene_id, os.path.join(base, "posed_images"),
                os.path.join(base, "scannet_instance_data"))
        a, b = JS.load_reference_scene(*args), TS.load_reference_scene(*args)
        a.save_npz(str(tmp_path / f"{root}_j.npz"))
        b.save_npz(str(tmp_path / f"{root}_t.npz"))
        assert (tmp_path / f"{root}_j.npz").read_bytes() == \
            (tmp_path / f"{root}_t.npz").read_bytes()


def test_dir_image_provider_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    (tmp_path / "sc").mkdir()
    for i, shape in enumerate([(30, 40, 3), (30, 40)]):
        cv2.imwrite(str(tmp_path / "sc" / f"{i:05d}.jpg"),
                    rng.integers(0, 255, shape, dtype=np.uint8))
    jp, tp = JA.DirImageProvider(str(tmp_path)), TA.DirImageProvider(
        str(tmp_path))
    for iid in ("00000", "00001"):
        a, b = jp("sc", iid), tp("sc", iid)
        assert a.shape == b.shape == (30, 40, 3)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tp("sc", "00009")


def test_host_shard_partitions_as_jax():
    items = list(range(10))
    shards = [host_shard(items, process_index=i, process_count=3)
              for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert all(abs(len(a) - len(b)) <= 1 for a in shards for b in shards)
    assert shards[1] == [1, 4, 7]
    assert host_shard(items) == items        # no process group: (0, 1)


def test_native_inflate_raises_instead_of_falling_back(monkeypatch):
    good = zlib.compress(np.arange(64, dtype=np.uint16).tobytes())
    assert TN.zlib_inflate_batch([good], 128) == [zlib.decompress(good)]
    with pytest.raises(ValueError, match="stream 1 of 2"):
        TN.zlib_inflate_batch([good, b"not zlib"], 128)
    with pytest.raises(ValueError, match="rejected"):
        TN.zlib_inflate(b"not zlib", 128)
    monkeypatch.setattr(TN, "_load", lambda: None)
    monkeypatch.setattr(TN, "build_error", "no compiler")
    for call in (lambda: TN.zlib_inflate(good),
                 lambda: TN.zlib_inflate_batch([good], 128)):
        with pytest.raises(RuntimeError, match="no compiler"):
            call()


def _jax_cli(monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["multi_spatialmllm_tpu", *args])
    jcli.main()


def _scans(root, n=2):
    scenes = [JSyn.make_scene(scene_id=f"scene{i:04d}_00", seed=20 + i,
                              n_images=6, n_background=1500,
                              image_hw=(48, 64), depth_hw=(24, 32))
              for i in range(n)]
    for s in scenes:
        write_scan(root, s, frame_skip=3)
    return scenes


def test_ingest_and_coverage_commands_equal_the_jax_cli(tmp_path,
                                                        monkeypatch, capsys):
    """`ingest-scannet`, `ingest-sens --frame-skip 3` and `coverage` over 2
    shards then `--merge` (and a resumed shard): every file the port's
    commands write on the CPU equals the JAX CLI's; the merged pickles
    equal an unsharded run."""
    scans = str(tmp_path / "scans")
    _scans(scans)
    out = {}
    for who, run in (("jax", lambda *a: _jax_cli(monkeypatch, *a)),
                     ("port", lambda *a: tcli.main([*a, "--device", "cpu"]))):
        root = tmp_path / who
        run("ingest-scannet", "--scans", scans, "--output", str(root / "exp"))
        run("ingest-sens", "--scans", scans, "--output", str(root / "packs"),
            "--frame-skip", "3")
        for i in range(2):
            run("coverage", "--scenes", str(root / "packs"), "--output",
                str(root / "cov"), "--shard-index", str(i), "--num-shards",
                "2")
        capsys.readouterr()
        run("coverage", "--scenes", str(root / "packs"), "--output",
            str(root / "cov"), "--shard-index", "1", "--num-shards", "2")
        assert '"already done"' in capsys.readouterr().out
        run("coverage", "--output", str(root / "cov"), "--merge")
        run("coverage", "--scenes", str(root / "packs"), "--output",
            str(root / "whole"))
        out[who] = root
    _assert_same_tree(out["jax"], out["port"])
    assert len(_tree(out["port"] / "packs")) == 2
    for dim in ("height", "length", "width"):
        merged = (out["port"] / "cov" /
                  f"merged_train_object_coverage_{dim}.pkl").read_bytes()
        whole = (out["port"] / "whole" /
                 f"train_object_coverage_{dim}_shard000of001.pkl")
        assert pickle.loads(merged) == pickle.loads(whole.read_bytes())


def test_ingested_scene_equals_its_source(tmp_path):
    """A scene written as a scan (write_scan) and ingested back holds the
    source's depth bit for bit, its poses, intrinsics and unaligned points
    at float32, its instance ids and categories, and its boxes and aligned
    points within float32 rounding."""
    [scene] = [JSyn.make_scene(scene_id="scene0100_00", seed=9, n_images=5,
                               n_background=1000, image_hw=(40, 52),
                               depth_hw=(20, 26), n_invalid_poses=0)]
    scans = str(tmp_path / "scans")
    write_scan(scans, scene, frame_skip=4)
    tcli.main(["ingest-sens", "--scans", scans, "--output",
               str(tmp_path / "p"), "--frame-skip", "4", "--device", "cpu"])
    got = TS.Scene.load_npz(str(tmp_path / "p" / "scene0100_00.npz"))
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa
    assert np.array_equal(got.depth_maps, scene.depth_maps)
    assert np.array_equal(got.extrinsics, f32(scene.extrinsics))
    assert np.array_equal(got.intrinsic, f32(scene.intrinsic))
    assert np.array_equal(got.points_unaligned[:, :3],
                          f32(scene.points_unaligned))
    assert np.array_equal(got.instance_ids, scene.instance_ids)
    assert got.categories == scene.categories
    assert got.image_hw == scene.image_hw
    assert got.image_ids == [f"{4 * i:05d}" for i in range(5)]
    np.testing.assert_allclose(got.points_aligned[:, :3],
                               scene.points_aligned, atol=1e-5)
    np.testing.assert_allclose(got.aligned_bboxes, scene.aligned_bboxes,
                               atol=1e-5)
    np.testing.assert_allclose(got.unaligned_bboxes, scene.unaligned_bboxes,
                               atol=1e-5)


def _golden_script():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "gen_ingest_golden.py")
    spec = importlib.util.spec_from_file_location("gen_ingest_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stored_ingest_digests_are_a_fresh_jax_run():
    """The digests the card checks phase 18 against are what the JAX
    package and cv2 give here now."""
    import json

    G = _golden_script()
    with open(G.OUT) as f:
        stored = json.load(f)
    assert G.golden(cv2) == stored


def test_port_ingest_matches_the_stored_digests(tmp_path):
    """What the card does in phase 18, on the CPU: the port's export of the
    bench configuration, its small run's packs, scenes_info and merged
    coverage, and its frame reads and tiles equal the JAX digests."""
    import json

    from multi_spatialmllm_tpu_torch.ingest.sens import export_posed_images

    G = _golden_script()
    with open(G.OUT) as f:
        stored = json.load(f)
    sens = G.port_export_sens(str(tmp_path))
    exp = str(tmp_path / "posed" / G.EXPORT_DIR)
    n = export_posed_images(sens, exp, frame_skip=1)
    assert G.port_export_digests(exp, n) == stored["export"]
    scans = str(tmp_path / "scans")
    G.small_scans(scans)
    for cmd in G.small_commands(scans, str(tmp_path / "small")):
        tcli.main([*cmd, "--device", "cpu"])
    assert G.small_digests(str(tmp_path / "small")) == stored["small"]
    assert G.port_tiles(str(tmp_path)) == stored["tiles"]
