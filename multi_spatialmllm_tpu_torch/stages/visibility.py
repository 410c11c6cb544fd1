"""Stage: point-visibility index (L3), the port of
multi_spatialmllm_tpu/stages/visibility.py.

Each scene becomes the dense `[I, N]` visibility matrix, computed on the
device by torch ops (core/geometry.visibility_matrix) and bit-packed there,
so the host fetch moves one bit a pair; the inverse `point_to_images` map
is its transpose. float64 gives labels bit-equal to the JAX stage (CUDA's
f64 arithmetic is IEEE, and the ops never contract into FMAs); float32 is
a speed option, as in the JAX package.

Not ported yet (ROADMAP.md, queue 1): the hybrid f32 pass with its host
f64 fix-up (`compute_scene_visibility_hybrid`), which exists for the TPU's
emulated f64, and the scene-parallel multi-device stage.
"""

from __future__ import annotations

import json
from typing import Callable, Iterable

import numpy as np
import torch

from ..core import geometry as G
from ..core.io import WarningSink, write_parquet
from ..core.scene import Scene

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


def compute_visibility_batch(
    scenes: "list[Scene]", dtype=np.float64, batch_size: int = 8,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Visibility matrices for many scenes, `batch_size` scenes of one
    padded shape per dispatch (one host round trip per chunk instead of
    one per scene). Returns {scene_id: [I, N] bool}."""
    _check_dtype(dtype)
    dev = torch.device(device)
    groups: dict[tuple, list[Scene]] = {}
    out: dict[str, np.ndarray] = {}
    for scene in scenes:
        n_pad = ((max(scene.num_points, 1) + 127) // 128) * 128
        i_pad = ((max(scene.num_images, 1) + 7) // 8) * 8
        key = (i_pad, n_pad, scene.depth_hw, scene.image_hw)
        groups.setdefault(key, []).append(scene)

    for (i_pad, n_pad, depth_hw, image_hw), members in groups.items():
        for lo in range(0, len(members), batch_size):
            chunk = members[lo: lo + batch_size]
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
            packed = _visibility_packed(
                *(torch.from_numpy(a).to(dev)
                  for a in (pts, Ks, exts, depths, ivalid, pvalid)),
                image_hw)
            vis = _unpackbits(packed.cpu().numpy(), n_pad)
            for j, scene in enumerate(chunk):
                out[scene.scene_id] = vis[
                    j, : scene.num_images, : scene.num_points]
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
