"""Stage: point-visibility index (L3), the port of
multi_spatialmllm_tpu/stages/visibility.py.

Each scene becomes the dense `[I, N]` visibility matrix, computed on the
device by torch ops (core/geometry.visibility_matrix) and bit-packed there,
so the host fetch moves one bit a pair; the inverse `point_to_images` map
is its transpose. float64 gives labels bit-equal to the JAX stage (CUDA's
f64 arithmetic is IEEE, and the ops never contract into FMAs); float32 is
a speed option, as in the JAX package. The hybrid
(`compute_scene_visibility_hybrid`) runs a true-float32 pass with a
conservative borderline mask on the device and recomputes the flagged
pairs on the host in numpy float64, the reference's own arithmetic: its
labels equal the float64 stage's.

`compute_visibility_multichip` runs the stage scene-parallel over a
mesh's data axis (parallel/mesh.py): every process takes its share of
each shape group's chunk of scenes, runs `compute_visibility_batch`'s
device program on its own device, and the processes exchange the packed
bits (`all_gather_object`), so that every one returns every scene's
matrix. `iter_packed_scene_batches` is the same split with the
visibility packed for the relations stage, and `scene_parallel_map` the
same split for the per-scene object-visibility and coverage stages.
"""

from __future__ import annotations

import json
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from ..core import geometry as G
from ..core.io import WarningSink, write_parquet
from ..core.scene import Scene
from ..core.synthetic import np_project_points

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _packbits(mask: torch.Tensor) -> torch.Tensor:
    """[..., N] bool -> [..., N//8] uint8 in np.packbits bit order, packed
    on the device so the host fetch moves one bit a pair."""
    shape = mask.shape[:-1] + (mask.shape[-1] // 8, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                           device=mask.device)
    return torch.sum(mask.reshape(shape).to(torch.uint8) * weights, dim=-1,
                     dtype=torch.uint8)


def _unpackbits(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(packed, axis=-1)[..., :n].astype(bool)


def _check_dtype(dtype) -> None:
    if np.dtype(dtype) not in (np.float64, np.float32):
        raise ValueError(
            f"visibility runs in float64 or float32, not {np.dtype(dtype)}")


# Image-chunking thresholds: a dispatch holds every `[I, N]` intermediate of
# `visibility_matrix` at once (coordinates, depths, int32 depth indices and
# the int64 gather index torch needs, masks). Peak device bytes per padded
# point-image pair, measured on an H100 80GB (torch.cuda.max_memory_allocated
# over the real-scale scene of chip_smoke.py phase 15, 296 x 202,496 pairs,
# one dispatch): 70.2 in float64, 39.1 in float32 (PERF.md, "Data engine").
# A budget of 32 GB of intermediates, 40% of the card (the rest for the
# caller and the allocator's fragments), gives 32e9 / 70.2 = 456M pairs in
# f64 and 32e9 / 39.1 = 818M in f32, rounded down: a scene of 2,000 images
# x 200K points still runs in one f64 dispatch.
_PAIR_BUDGET_F64 = 450_000_000
_PAIR_BUDGET_F32 = 800_000_000


def image_chunk_for(i_pad: int, n_pad: int, dtype,
                    image_chunk: int | None = None) -> int | None:
    """Images per dispatch for a padded `[i_pad, n_pad]` scene: the given
    `image_chunk`, else a multiple of 8 under the pair budget when the
    scene exceeds it, else None (one dispatch)."""
    budget = (_PAIR_BUDGET_F64 if np.dtype(dtype) == np.float64
              else _PAIR_BUDGET_F32)
    if image_chunk is None and i_pad * n_pad > budget:
        image_chunk = max(8, (budget // n_pad) // 8 * 8)
    if image_chunk and image_chunk < i_pad:
        return image_chunk
    return None


def _visibility_packed(points, K, extrinsics, depth_maps, image_valid,
                       point_valid, image_hw) -> torch.Tensor:
    return _packbits(G.visibility_matrix(
        points, K, extrinsics, depth_maps, image_hw, image_valid,
        point_valid))


def compute_scene_visibility(
    scene: Scene, dtype=np.float64, image_chunk: int | None = None,
    device="cuda",
) -> np.ndarray:
    """Dense `[num_images, num_points]` bool visibility for one scene,
    computed on `device`.

    Large scenes are processed `image_chunk` images per dispatch (chosen
    from the pair budget when not given); the point cloud is uploaded once
    and reused across chunks, and every chunk is queued before any is
    fetched.
    """
    _check_dtype(dtype)
    dev = torch.device(device)
    pts, pvalid = scene.padded_points(dtype)
    ext, depth, ivalid = scene.padded_images(dtype)
    i_pad, n_pad = ext.shape[0], pts.shape[0]
    chunk = image_chunk_for(i_pad, n_pad, dtype, image_chunk) or i_pad
    n_chunks = -(-i_pad // chunk)
    tot = n_chunks * chunk
    if tot > i_pad:  # pad the image axis up to a chunk multiple
        ext = np.concatenate(
            [ext, np.tile(np.eye(4, dtype=ext.dtype), (tot - i_pad, 1, 1))])
        depth = np.concatenate(
            [depth, np.zeros((tot - i_pad,) + depth.shape[1:],
                             dtype=depth.dtype)])
        ivalid = np.concatenate([ivalid, np.zeros(tot - i_pad, dtype=bool)])
    pts_d = torch.from_numpy(pts).to(dev)
    K_d = torch.from_numpy(scene.intrinsic.astype(dtype)).to(dev)
    pv_d = torch.from_numpy(pvalid).to(dev)
    packed = [
        _visibility_packed(
            pts_d, K_d, torch.from_numpy(ext[lo: lo + chunk]).to(dev),
            torch.from_numpy(depth[lo: lo + chunk].astype(np.int32)).to(dev),
            torch.from_numpy(ivalid[lo: lo + chunk]).to(dev), pv_d,
            scene.image_hw)
        for lo in range(0, tot, chunk)
    ]
    rows = [p.cpu().numpy() for p in packed]
    vis = _unpackbits(np.concatenate(rows), n_pad)
    return vis[: scene.num_images, : scene.num_points]


# The hybrid pass's peak device bytes per padded pair (the float32 pass,
# the borderline mask, both packings and the scene's upload), measured as
# the float32 and float64 ones were: 40.1 over the real-scale scene in one
# dispatch on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 21, PERF.md).
# The budget is the same 32 GB of intermediates, 32e9 / 40.1 = 798M pairs,
# and a scene dispatches in chunks of half of it, so the host fix-up of
# one chunk overlaps the next chunk's upload and compute.
_HYBRID_BYTES_PER_PAIR = 40.1
_PAIR_BUDGET_HYBRID = 798_000_000


def _fetch_async(t: torch.Tensor) -> torch.Tensor:
    """Start the copy of `t` to the host: into pinned memory, not waiting,
    for a CUDA tensor (read it once `_ready` says the stream got there);
    a CPU tensor is its own copy."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _ready(device: torch.device):
    """An event recorded on the current stream of a CUDA `device` (None on
    the CPU): what the host waits for before it reads `_fetch_async`'s
    copies made so far."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _upload(arrays, device: torch.device, stream=None) -> list:
    """Host arrays to `device`. On a CUDA device with a side `stream`, each
    array goes through pinned memory and is copied on that stream without
    blocking the host; the current stream then waits for the copies (an
    event), and each tensor is marked as used there, so the allocator
    keeps its block until that stream is done with it."""
    if device.type != "cuda" or stream is None:
        return [torch.from_numpy(a).to(device) for a in arrays]
    main = torch.cuda.current_stream(device)
    out = []
    with torch.cuda.stream(stream):
        for a in arrays:
            src = torch.from_numpy(np.ascontiguousarray(a))
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src)
            t = torch.empty(src.shape, dtype=src.dtype, device=device)
            t.copy_(host, non_blocking=True)
            out.append(t)
    main.wait_stream(stream)
    for t in out:
        t.record_stream(main)
    return out


class HybridHandles(NamedTuple):
    """One scene's dispatched hybrid chunks: each chunk's packed `vis` and
    `near` bits on their way to the host (`chunk` images and `n_pad`
    points each), and the event after the last (None on the CPU)."""
    chunks: list
    chunk: int
    n_pad: int
    ready: object


def _hybrid_dispatch(scene: Scene, image_chunk: int | None = None,
                     device="cuda", stream=None) -> HybridHandles:
    """Upload the scene and queue every hybrid chunk, and each chunk's
    fetch, on `device` without waiting for any: the caller can start the
    next scene, or the host fix-up of an earlier chunk, while these run.
    Chunks hold half the hybrid pair budget's pairs unless `image_chunk`
    is given. `stream`: a side CUDA stream for the uploads (see
    `_upload`)."""
    dev = torch.device(device)
    pts, pvalid = scene.padded_points(np.float32)
    ext, depth, ivalid = scene.padded_images(np.float32)
    i_pad, n_pad = ext.shape[0], pts.shape[0]
    budget = _PAIR_BUDGET_HYBRID // 2
    if image_chunk is None and i_pad * n_pad > budget:
        image_chunk = max(8, (budget // n_pad) // 8 * 8)
    chunk = image_chunk if image_chunk and image_chunk < i_pad else i_pad
    tot = -(-i_pad // chunk) * chunk
    if tot > i_pad:  # pad the image axis up to a chunk multiple
        ext = np.concatenate(
            [ext, np.tile(np.eye(4, dtype=ext.dtype), (tot - i_pad, 1, 1))])
        depth = np.concatenate(
            [depth, np.zeros((tot - i_pad,) + depth.shape[1:],
                             dtype=depth.dtype)])
        ivalid = np.concatenate([ivalid, np.zeros(tot - i_pad, dtype=bool)])
    pts_d, K_d, pv_d, ext_d, depth_d, iv_d = _upload(
        [pts, scene.intrinsic.astype(np.float32), pvalid, ext,
         depth.astype(np.int32), ivalid], dev, stream)
    chunks = []
    for lo in range(0, tot, chunk):
        vis, near = G.visibility_and_borderline(
            pts_d, K_d, ext_d[lo: lo + chunk], depth_d[lo: lo + chunk],
            scene.image_hw, iv_d[lo: lo + chunk], pv_d)
        chunks.append((_fetch_async(_packbits(vis)),
                       _fetch_async(_packbits(near))))
        del vis, near
    return HybridHandles(chunks, chunk, n_pad, _ready(dev))


def _hybrid_finalize(scene: Scene, handles: HybridHandles) -> np.ndarray:
    """Wait for the fetched chunks and recompute the flagged pairs exactly:
    numpy float64 on the host, the reference's arithmetic (the JAX
    stage's fix-up line for line)."""
    if handles.ready is not None:
        handles.ready.synchronize()
    n_pad = handles.n_pad
    h, w = scene.image_hw
    hd, wd = scene.depth_hw
    vis_rows = []
    for ci, (v, nr) in enumerate(handles.chunks):
        base = ci * handles.chunk
        n_rows = min(handles.chunk, scene.num_images - base)
        if n_rows <= 0:
            break
        vis_c = _unpackbits(v.numpy(), n_pad)[:n_rows, : scene.num_points]
        near_c = _unpackbits(nr.numpy(), n_pad)[:n_rows, : scene.num_points]
        # exact f64 host fix-up of the flagged bits, grouped per image
        for r in np.where(near_c.any(axis=1))[0]:
            i = base + int(r)
            cols = np.where(near_c[r])[0]
            E = scene.extrinsic_align(i)
            xy, d = np_project_points(
                scene.points_aligned[cols, :3], scene.intrinsic, E)
            x, y = xy[:, 0], xy[:, 1]
            inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            # x * (wd/w) order matters at exact .5 boundaries (see
            # engines/depth_perception._project_many)
            sx, sy = wd / w, hd / h
            dxi = np.clip(np.round(x * sx), 0, wd - 1).astype(np.int64)
            dyi = np.clip(np.round(y * sy), 0, hd - 1).astype(np.int64)
            dv = scene.depth_maps[i][dyi, dxi] * 0.001
            vis_c[r, cols] = inb & (d > 0) & (d < dv)
        vis_rows.append(vis_c)
    return np.concatenate(vis_rows)


def compute_scene_visibility_hybrid(scene: Scene,
                                    image_chunk: int | None = None,
                                    device="cuda") -> np.ndarray:
    """Dense `[num_images, num_points]` bool visibility with the float64
    stage's labels from a float32 pass: `visibility_and_borderline` on
    `device` (core/geometry.py), then the flagged pairs (within float32
    rounding distance of a comparison boundary, ~2%) recomputed on the
    host in numpy float64, chunk by chunk as the chunks arrive. Equal to
    `compute_scene_visibility(scene, np.float64)` and to the numpy oracle
    bit for bit."""
    return _hybrid_finalize(scene, _hybrid_dispatch(scene, image_chunk,
                                                    device))


def padded_shape(scene: Scene) -> tuple[int, int]:
    """(i_pad, n_pad): a scene's image count rounded up to 8 rows and its
    point count to 128 lanes, the padding every batched stage shares."""
    return (((max(scene.num_images, 1) + 7) // 8) * 8,
            ((max(scene.num_points, 1) + 127) // 128) * 128)


def _shape_groups(scenes, key) -> dict[tuple, list[Scene]]:
    groups: dict[tuple, list[Scene]] = {}
    for scene in scenes:
        groups.setdefault(key(scene), []).append(scene)
    return groups


def _image_key(scene: Scene) -> tuple:
    return padded_shape(scene) + (scene.depth_hw, scene.image_hw)


def _batch_packed(chunk: "list[Scene]", i_pad: int, n_pad: int, depth_hw,
                  image_hw, dtype, dev: torch.device) -> np.ndarray:
    """The packed `[s, i_pad, n_pad // 8]` visibility of scenes of one
    padded shape, in one dispatch on `dev`."""
    s = len(chunk)
    pts = np.empty((s, n_pad, 3), dtype=dtype)
    pvalid = np.empty((s, n_pad), dtype=bool)
    Ks = np.empty((s, 4, 4), dtype=dtype)
    exts = np.empty((s, i_pad, 4, 4), dtype=dtype)
    depths = np.empty((s, i_pad) + depth_hw, dtype=np.int32)
    ivalid = np.empty((s, i_pad), dtype=bool)
    for j, scene in enumerate(chunk):
        pts[j], pvalid[j] = scene.padded_points(dtype)
        exts[j], depths[j], ivalid[j] = scene.padded_images(dtype)
        Ks[j] = scene.intrinsic.astype(dtype)
    return _visibility_packed(
        *(torch.from_numpy(a).to(dev)
          for a in (pts, Ks, exts, depths, ivalid, pvalid)),
        image_hw).cpu().numpy()


def compute_visibility_batch(
    scenes: "list[Scene]", dtype=np.float64, batch_size: int = 8,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Visibility matrices for many scenes, `batch_size` scenes of one
    padded shape per dispatch (one host round trip per chunk instead of
    one per scene). Returns {scene_id: [I, N] bool}."""
    _check_dtype(dtype)
    dev = torch.device(device)
    out: dict[str, np.ndarray] = {}
    for (i_pad, n_pad, depth_hw, image_hw), members in _shape_groups(
            scenes, _image_key).items():
        for lo in range(0, len(members), batch_size):
            chunk = members[lo: lo + batch_size]
            vis = _unpackbits(_batch_packed(chunk, i_pad, n_pad, depth_hw,
                                            image_hw, dtype, dev), n_pad)
            for j, scene in enumerate(chunk):
                out[scene.scene_id] = vis[
                    j, : scene.num_images, : scene.num_points]
    return out


def exchange(payload: dict, group) -> dict:
    """Every process's `payload` (a dict keyed by scene id) merged, on
    every process of `group`: one `all_gather_object` of host objects.
    Each process of the group must call it the same number of times."""
    import torch.distributed as dist

    parts: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, payload, group=group)
    merged: dict = {}
    for part in parts:
        merged.update(part)
    return merged


def _my_chunks(groups: dict, mesh, per_device_batch: int):
    """For each shape group's chunks of `data size x per_device_batch`
    scenes (the JAX stages' dispatch batches): (key, this process's share
    `chunk[r*pdb:(r+1)*pdb]`, possibly empty). Every process walks the same
    chunks, so each calls `exchange` once a chunk."""
    from ..parallel.mesh import data_axis

    _, rank, size = data_axis(mesh)
    batch = size * per_device_batch
    for key, members in groups.items():
        for lo in range(0, len(members), batch):
            chunk = members[lo: lo + batch]
            yield key, chunk[rank * per_device_batch:
                             (rank + 1) * per_device_batch]


def scene_parallel_map(scenes, mesh, per_device_batch: int, fn) -> dict:
    """`{scene_id: fn(scene)}` for every scene on every process of the
    mesh's data axis: each process calls `fn` on its share of each
    padded-shape chunk (`_my_chunks`) and the processes exchange the
    results (one `all_gather_object` a chunk), in chunk order. For the
    stages whose per-scene device program needs no batching (object
    visibility, coverage)."""
    group = mesh.get_group(mesh.mesh_dim_names[0])
    out: dict = {}
    for _, mine in _my_chunks(_shape_groups(scenes, padded_shape), mesh,
                              per_device_batch):
        out.update(exchange({s.scene_id: fn(s) for s in mine}, group))
    return out


def iter_packed_scene_batches(scenes, mesh, visibility: dict,
                              per_device_batch: int):
    """Scenes grouped by padded (I, N) shape, split over the mesh's data
    axis as the JAX scaffolding splits them, with their visibility
    bit-packed: yields `(i_pad, n_pad, mine, packed)` for every chunk of
    `data size x per_device_batch` scenes, where `mine` is this process's
    share (possibly empty) and `packed` its `[len(mine), i_pad, n_pad // 8]`
    uint8 block, zero past each scene's own rows and columns. The widths
    come from the group, never from a share, so a scene's device program
    sees the shape it has on one device. The scene-parallel relations
    stage batches each share into one dispatch on it."""
    for (i_pad, n_pad), mine in _my_chunks(
            _shape_groups(scenes, padded_shape), mesh, per_device_batch):
        packed = np.zeros((len(mine), i_pad, n_pad // 8), np.uint8)
        for j, scene in enumerate(mine):
            vis = visibility[scene.scene_id]
            vis_pad = np.zeros((i_pad, n_pad), dtype=bool)
            vis_pad[: vis.shape[0], : vis.shape[1]] = vis
            packed[j] = np.packbits(vis_pad, axis=1)
        yield i_pad, n_pad, mine, packed


def compute_visibility_multichip(
    scenes: "list[Scene]",
    mesh,
    dtype=np.float64,
    per_device_batch: int = 4,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Scene-parallel visibility over the mesh's data axis; returns
    `{scene_id: [I, N] bool}` for every scene on every process, equal to
    `compute_scene_visibility` scene by scene.

    Scenes are grouped by padded shape `(i_pad, n_pad, depth_hw,
    image_hw)` and cut into chunks of `data size x per_device_batch`;
    each process runs its share of a chunk through
    `compute_visibility_batch`'s device program on `device`, then the
    processes exchange each scene's packed rows (one `all_gather_object`
    a chunk) and unpack them."""
    _check_dtype(dtype)
    dev = torch.device(device)
    group = mesh.get_group(mesh.mesh_dim_names[0])
    out: dict[str, np.ndarray] = {}
    for (i_pad, n_pad, depth_hw, image_hw), mine in _my_chunks(
            _shape_groups(scenes, _image_key), mesh, per_device_batch):
        local = {}
        if mine:
            packed = _batch_packed(mine, i_pad, n_pad, depth_hw, image_hw,
                                   dtype, dev)
            for j, scene in enumerate(mine):
                local[scene.scene_id] = (
                    packed[j, : scene.num_images,
                           : (scene.num_points + 7) // 8],
                    scene.num_points)
        for sid, (bits, n) in exchange(local, group).items():
            out[sid] = _unpackbits(bits, n)
    return out


class VisibilityIndex:
    """In-memory visibility index over many scenes.

    Stores the dense bool matrix per scene — it is both maps at once —
    and speaks the reference's parquet key/value dialect at the edges.
    """

    def __init__(self):
        self._matrices: dict[str, np.ndarray] = {}
        self._image_ids: dict[str, list[str]] = {}
        self._id_rows: dict[str, dict[str, int]] = {}

    # -- construction ---------------------------------------------------

    def add_scene(self, scene_id: str, image_ids: list[str], vis: np.ndarray):
        self._matrices[scene_id] = vis.astype(bool)
        self._image_ids[scene_id] = list(image_ids)
        self._id_rows[scene_id] = {iid: i for i, iid in enumerate(image_ids)}

    @staticmethod
    def build(
        scenes: Iterable[Scene],
        compute: Callable[[Scene], np.ndarray] = compute_scene_visibility,
        warning_sink: WarningSink | None = None,
    ) -> "VisibilityIndex":
        """Index over `scenes`, each matrix from `compute(scene)` (e.g.
        `functools.partial(compute_scene_visibility, device="cpu")`)."""
        index = VisibilityIndex()
        for scene in scenes:
            vis = compute(scene)
            if warning_sink is not None:
                valid = scene.valid_image_mask()
                for i, iid in enumerate(scene.image_ids):
                    if valid[i] and not vis[i].any():
                        warning_sink(
                            f"[Warning] {scene.scene_id}: {iid} has no in-bound points."
                        )
            index.add_scene(scene.scene_id, scene.image_ids, vis)
        return index

    # -- queries (VisibilityInfoHandler parity) -------------------------

    def scene_ids(self) -> list[str]:
        return sorted(self._matrices.keys())

    def matrix(self, scene_id: str) -> np.ndarray:
        return self._matrices[scene_id]

    def image_ids(self, scene_id: str) -> list[str]:
        return self._image_ids[scene_id]

    def image_to_points(self, scene_id: str, image_id: str) -> np.ndarray:
        """Point indices visible in an image (info_handler.py:502-519)."""
        row = self._id_rows[scene_id][f"{int(image_id):05d}"]
        return np.where(self._matrices[scene_id][row])[0]

    def point_to_images(self, scene_id: str, point_index: int) -> list[str]:
        """Image ids that see a point (info_handler.py:521-538)."""
        col = self._matrices[scene_id][:, point_index]
        return [iid for iid, v in zip(self._image_ids[scene_id], col) if v]

    def common_points(self, scene_id: str, image_id1: str, image_id2: str) -> np.ndarray:
        """Intersection of two images' visible-point sets (replaces
        np.intersect1d over JSON lists, coor_2_coor engine :300-306)."""
        rows = self._id_rows[scene_id]
        m = self._matrices[scene_id]
        r1 = rows[f"{int(image_id1):05d}"]
        r2 = rows[f"{int(image_id2):05d}"]
        return np.where(m[r1] & m[r2])[0]

    # -- persistence ----------------------------------------------------

    def to_parquet(self, path: str) -> int:
        """Reference-dialect parquet (colon keys, JSON-list values)."""
        import pandas as pd

        rows = []
        for scene_id in self.scene_ids():
            m = self._matrices[scene_id]
            ids = self._image_ids[scene_id]
            for i, iid in enumerate(ids):
                rows.append(
                    (f"{scene_id}:image_to_points:{iid}",
                     json.dumps(np.where(m[i])[0].tolist()))
                )
            for p in range(m.shape[1]):
                rows.append(
                    (f"{scene_id}:point_to_images:{p}",
                     json.dumps([ids[i] for i in np.where(m[:, p])[0]]))
                )
        df = pd.DataFrame(rows, columns=["key", "values"])
        write_parquet(df, path)
        return len(df)

    def save_npz(self, path: str) -> None:
        """Compact native format: packed bitmaps per scene."""
        payload = {}
        for scene_id in self.scene_ids():
            m = self._matrices[scene_id]
            payload[f"{scene_id}__bits"] = np.packbits(m, axis=1)
            payload[f"{scene_id}__shape"] = np.asarray(m.shape)
            payload[f"{scene_id}__ids"] = np.asarray(self._image_ids[scene_id])
        np.savez_compressed(path, **payload)

    @staticmethod
    def load_npz(path: str) -> "VisibilityIndex":
        z = np.load(path, allow_pickle=False)
        index = VisibilityIndex()
        scene_ids = {k[: -len("__bits")] for k in z.files if k.endswith("__bits")}
        for sid in sorted(scene_ids):
            shape = tuple(z[f"{sid}__shape"])
            bits = np.unpackbits(z[f"{sid}__bits"], axis=1)[:, : shape[1]]
            index.add_scene(sid, [str(s) for s in z[f"{sid}__ids"]], bits.astype(bool))
        return index

    @staticmethod
    def from_parquet(path: str) -> "VisibilityIndex":
        """Load a reference-dialect parquet (colon keys, JSON values)."""
        import pandas as pd

        df = pd.read_parquet(path)
        per_scene: dict[str, dict[str, list[int]]] = {}
        for key, value in zip(df["key"], df["values"]):
            scene_id, kind, entity = key.split(":")
            if kind != "image_to_points":
                continue  # transpose is redundant
            per_scene.setdefault(scene_id, {})[entity] = json.loads(value)
        index = VisibilityIndex()
        for scene_id, img_map in per_scene.items():
            ids = sorted(img_map.keys())
            n_points = max(
                (max(v) + 1 for v in img_map.values() if v), default=0
            )
            m = np.zeros((len(ids), n_points), dtype=bool)
            for i, iid in enumerate(ids):
                m[i, img_map[iid]] = True
            index.add_scene(scene_id, ids, m)
        return index
