"""Packed-array scene data model.

TPU-native replacement for the reference's pkl-of-dicts scene info
(`SceneInfoHandler`, info_handler.py:74-443, schema documented at
info_handler.py:7-30): per-scene data lives in contiguous NumPy arrays that
pad/stack directly into device buffers, instead of nested dicts keyed by
string image ids.

Canonical on-disk form is one `.npz` per scene ("scene pack") plus a store
index; a compatibility loader ingests the reference's layout (info pkl +
`posed_images/` jpg/png/txt + `scannet_instance_data/` npy) so outputs can be
validated against reference-generated data.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Sequence

import numpy as np

from .io import load_pickle, mkdir_or_exist

PAD_POINTS = 128   # lane dimension
PAD_IMAGES = 8     # sublane dimension


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class Scene:
    """One ScanNet-style scene as packed arrays.

    Attributes:
      scene_id: e.g. "scene0011_00".
      intrinsic: `[4, 4]` color-camera intrinsic (info_handler.py:97).
      axis_align: `[4, 4]` world-to-axis-aligned matrix (info_handler.py:175).
      image_ids: `[I]` string ids ("00000" style keys, sorted).
      extrinsics: `[I, 4, 4]` camera-to-world poses; invalid poses contain
        inf/nan exactly as the reference stores them (info_handler.py:409).
      image_hw: color-image resolution (H, W).
      depth_maps: `[I, Hd, Wd]` uint16 depth in mm (0 = invalid).
      points_aligned / points_unaligned: `[N, >=3]` scene point clouds
        (columns beyond xyz are RGB, kept for parity with the npy files).
      instance_ids: `[N]` uint32; 0 = unannotated, object k -> k+1
        (info_handler.py:250-261 semantics).
      aligned_bboxes / unaligned_bboxes: `[O, 7]` = [cx,cy,cz,dx,dy,dz,label].
      categories: `[O]` raw category strings.
    """

    scene_id: str
    intrinsic: np.ndarray
    axis_align: np.ndarray
    image_ids: list[str]
    extrinsics: np.ndarray
    image_hw: tuple[int, int]
    depth_maps: np.ndarray
    points_aligned: np.ndarray
    points_unaligned: np.ndarray
    instance_ids: np.ndarray
    aligned_bboxes: np.ndarray
    unaligned_bboxes: np.ndarray
    categories: list[str]

    # ------------------------------------------------------------------
    # Basic accessors (SceneInfoHandler parity)
    # ------------------------------------------------------------------

    @property
    def num_images(self) -> int:
        return len(self.image_ids)

    @property
    def num_points(self) -> int:
        return int(self.points_aligned.shape[0])

    @property
    def num_objects(self) -> int:
        return int(self.aligned_bboxes.shape[0])

    @property
    def depth_hw(self) -> tuple[int, int]:
        return (int(self.depth_maps.shape[1]), int(self.depth_maps.shape[2]))

    def valid_image_mask(self) -> np.ndarray:
        """Finite-pose mask. Parity: info_handler.py:409-418."""
        return np.isfinite(self.extrinsics).all(axis=(1, 2))

    def valid_image_ids(self) -> list[str]:
        m = self.valid_image_mask()
        return [iid for iid, v in zip(self.image_ids, m) if v]

    def image_index(self, image_id: str | int) -> int:
        key = f"{int(image_id):05d}"
        # lazy id -> row dict: list.index is an O(I) string scan and this
        # sits on the QA engines' per-sample path
        idx = self.__dict__.get("_image_id_index")
        if idx is None:
            idx = {iid: i for i, iid in enumerate(self.image_ids)}
            self.__dict__["_image_id_index"] = idx
        return idx[key]

    def extrinsic_align(self, index: int) -> np.ndarray:
        """`axis_align @ E` (camera to axis-aligned world).
        Parity: info_handler.py:113-124."""
        return self.axis_align @ self.extrinsics[index]

    def extrinsics_align(self) -> np.ndarray:
        """All images at once: `[I, 4, 4]`."""
        return np.einsum("ij,njk->nik", self.axis_align, self.extrinsics)

    # -- objects (aligned bbox conventions, info_handler.py:194-242) ----

    def object_height(self, object_id: int) -> float:
        return float(self.aligned_bboxes[object_id, 5])  # dz

    def object_length(self, object_id: int) -> float:
        b = self.aligned_bboxes[object_id]
        return float(max(b[3], b[4]))  # max(dx, dy)

    def object_width(self, object_id: int) -> float:
        b = self.aligned_bboxes[object_id]
        return float(min(b[3], b[4]))  # min(dx, dy)

    def object_width_axis(self, object_id: int) -> int:
        """0 if dx < dy else 1. Parity: info_handler.py:224-230."""
        b = self.aligned_bboxes[object_id]
        return 0 if b[3] < b[4] else 1

    def object_length_axis(self, object_id: int) -> int:
        """0 if dx > dy else 1. Parity: info_handler.py:216-222."""
        b = self.aligned_bboxes[object_id]
        return 0 if b[3] > b[4] else 1

    def object_volume(self, object_id: int) -> float:
        b = self.aligned_bboxes[object_id]
        return float(b[3] * b[4] * b[5])

    def object_point_mask(self, object_id: int) -> np.ndarray:
        """`[N]` bool mask of the object's points (1-indexed instance ids).
        Parity: info_handler.py:250-261."""
        return self.instance_ids == np.uint32(object_id + 1)

    def object_point_index(self, object_id: int) -> np.ndarray:
        return np.where(self.object_point_mask(object_id))[0]

    # ------------------------------------------------------------------
    # Device packing
    # ------------------------------------------------------------------

    def padded_points(self, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
        """Aligned xyz padded to a multiple of 128 + validity mask."""
        n = self.num_points
        n_pad = _round_up(max(n, 1), PAD_POINTS)
        pts = np.zeros((n_pad, 3), dtype=dtype)
        pts[:n] = self.points_aligned[:, :3].astype(dtype)
        valid = np.zeros(n_pad, dtype=bool)
        valid[:n] = True
        return pts, valid

    def padded_images(self, dtype=np.float32):
        """(extrinsics_align [Ip,4,4], depth [Ip,Hd,Wd] uint16, valid [Ip]).

        Invalid poses are replaced by identity so the batched inverse stays
        finite; their rows are masked out via `valid`. Depth stays uint16
        (the sensor storage format) — it is the dominant host->device
        payload (296 images at 480x640 = 91 MB vs 363 MB as int32) and the
        device programs widen it after the gather anyway.
        """
        i = self.num_images
        i_pad = _round_up(max(i, 1), PAD_IMAGES)
        valid = np.zeros(i_pad, dtype=bool)
        valid[:i] = self.valid_image_mask()
        ext = np.tile(np.eye(4, dtype=dtype), (i_pad, 1, 1))
        ea = self.extrinsics_align().astype(dtype)
        finite = valid[:i]
        ext[:i][finite] = ea[finite]
        hd, wd = self.depth_hw
        depth = np.zeros((i_pad, hd, wd), dtype=np.uint16)
        depth[:i] = self.depth_maps.astype(np.uint16)
        return ext, depth, valid

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    def save_npz(self, path: str) -> None:
        mkdir_or_exist(os.path.dirname(path))
        np.savez_compressed(
            path,
            scene_id=np.asarray(self.scene_id),
            intrinsic=self.intrinsic,
            axis_align=self.axis_align,
            image_ids=np.asarray(self.image_ids),
            extrinsics=self.extrinsics,
            image_hw=np.asarray(self.image_hw, dtype=np.int64),
            depth_maps=self.depth_maps,
            points_aligned=self.points_aligned,
            points_unaligned=self.points_unaligned,
            instance_ids=self.instance_ids,
            aligned_bboxes=self.aligned_bboxes,
            unaligned_bboxes=self.unaligned_bboxes,
            categories=np.asarray(self.categories),
        )

    def save_reference_layout(self, root: str) -> dict:
        """Write this scene in the reference's artifact layout and return
        its scene-info entry (schema: info_handler.py:7-30).

        Produces `scannet_instance_data/<scene>/*.npy`,
        `posed_images/<scene>/{NNNNN.jpg,NNNNN.png,NNNNN.txt,intrinsic.txt}`
        so reference-compatible consumers (or the reference code itself,
        for parity tests) can read it.
        """
        from ..ingest import jpeg, png   # cv2.imwrite's bytes, without cv2

        inst_dir = os.path.join(root, "scannet_instance_data", self.scene_id)
        img_dir = os.path.join(root, "posed_images", self.scene_id)
        mkdir_or_exist(inst_dir)
        mkdir_or_exist(img_dir)
        np.save(os.path.join(inst_dir, "aligned_points.npy"),
                self.points_aligned)
        np.save(os.path.join(inst_dir, "unaligned_points.npy"),
                self.points_unaligned)
        np.save(os.path.join(inst_dir, "instance_mask.npy"),
                self.instance_ids)
        rng = np.random.default_rng(0)
        h, w = self.image_hw
        images_info = {}
        np.savetxt(os.path.join(img_dir, "intrinsic.txt"), self.intrinsic,
                   fmt="%f")
        for i, iid in enumerate(self.image_ids):
            img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
            jpeg.imwrite(os.path.join(img_dir, f"{iid}.jpg"), img, 95)
            png.imwrite_png(os.path.join(img_dir, f"{iid}.png"),
                            self.depth_maps[i].astype(np.uint16))
            np.savetxt(os.path.join(img_dir, f"{iid}.txt"),
                       self.extrinsics[i], fmt="%f")
            images_info[iid] = {
                "image_path": f"posed_images/{self.scene_id}/{iid}.jpg",
                "depth_image_path": f"posed_images/{self.scene_id}/{iid}.png",
                "extrinsic_matrix": self.extrinsics[i],
            }
        info: dict = {
            "num_posed_images": len(images_info),
            "images_info": images_info,
            "intrinsic_matrix": self.intrinsic,
            "axis_align_matrix": self.axis_align,
            "num_objects": self.num_objects,
        }
        for oid in range(self.num_objects):
            info[oid] = {
                "aligned_bbox": np.asarray(self.aligned_bboxes[oid]),
                "unaligned_bbox": np.asarray(self.unaligned_bboxes[oid]),
                "raw_category": self.categories[oid],
            }
        return info

    @staticmethod
    def load_npz(path: str) -> "Scene":
        z = np.load(path, allow_pickle=False)
        return Scene(
            scene_id=str(z["scene_id"]),
            intrinsic=z["intrinsic"],
            axis_align=z["axis_align"],
            image_ids=[str(s) for s in z["image_ids"]],
            extrinsics=z["extrinsics"],
            image_hw=(int(z["image_hw"][0]), int(z["image_hw"][1])),
            depth_maps=z["depth_maps"],
            points_aligned=z["points_aligned"],
            points_unaligned=z["points_unaligned"],
            instance_ids=z["instance_ids"],
            aligned_bboxes=z["aligned_bboxes"],
            unaligned_bboxes=z["unaligned_bboxes"],
            categories=[str(s) for s in z["categories"]],
        )


class SceneStore:
    """Directory of scene packs (`<root>/<scene_id>.npz`), lazily loaded."""

    def __init__(self, root: str):
        self.root = root
        self._cache: dict[str, Scene] = {}

    def scene_ids(self) -> list[str]:
        ids = [
            f[: -len(".npz")]
            for f in os.listdir(self.root)
            if f.endswith(".npz")
        ]
        ids.sort()
        return ids

    def __len__(self) -> int:
        return len(self.scene_ids())

    def get(self, scene_id: str) -> Scene:
        if scene_id not in self._cache:
            self._cache[scene_id] = Scene.load_npz(
                os.path.join(self.root, f"{scene_id}.npz")
            )
        return self._cache[scene_id]

    def __iter__(self) -> Iterator[Scene]:
        for sid in self.scene_ids():
            yield self.get(sid)

    @staticmethod
    def write(scenes: Sequence[Scene], root: str) -> "SceneStore":
        mkdir_or_exist(root)
        for scene in scenes:
            scene.save_npz(os.path.join(root, f"{scene.scene_id}.npz"))
        return SceneStore(root)


# ---------------------------------------------------------------------------
# Reference-layout compatibility loader
# ---------------------------------------------------------------------------

def load_reference_scene(
    info: dict,
    scene_id: str,
    posed_images_root: str,
    instance_data_root: str,
) -> Scene:
    """Build a Scene from the reference's artifact layout.

    `info` is one entry of the `scenes_*_info_i_D5.pkl` dict (schema at
    info_handler.py:7-30); image/depth files follow extract_posed_images.py
    (`{image_id}.jpg`, 16-bit `{image_id}.png`, pose txt).
    """
    from ..ingest import image, png   # cv2.imread's pixels, without cv2

    images_info = info["images_info"]
    image_ids = sorted(images_info.keys())
    extrinsics = np.stack(
        [np.asarray(images_info[i]["extrinsic_matrix"], dtype=np.float64)
         for i in image_ids]
    )
    depth_maps = []
    image_hw = None
    for iid in image_ids:
        dpath = os.path.join(posed_images_root, scene_id, f"{iid}.png")
        depth_maps.append(png.imread_png(dpath, png.UNCHANGED))
        if image_hw is None:
            cpath = os.path.join(posed_images_root, scene_id, f"{iid}.jpg")
            with open(cpath, "rb") as f:
                image_hw = image.color_size(f.read())
    inst_dir = os.path.join(instance_data_root, scene_id)
    aligned = np.load(os.path.join(inst_dir, "aligned_points.npy"))
    unaligned = np.load(os.path.join(inst_dir, "unaligned_points.npy"))
    instance_ids = np.load(os.path.join(inst_dir, "instance_mask.npy"))
    num_objects = info["num_objects"]
    ab = np.stack([np.asarray(info[o]["aligned_bbox"]) for o in range(num_objects)]) \
        if num_objects else np.zeros((0, 7))
    ub = np.stack([np.asarray(info[o]["unaligned_bbox"]) for o in range(num_objects)]) \
        if num_objects else np.zeros((0, 7))
    cats = [str(info[o]["raw_category"]) for o in range(num_objects)]
    return Scene(
        scene_id=scene_id,
        intrinsic=np.asarray(info["intrinsic_matrix"], dtype=np.float64),
        axis_align=np.asarray(info["axis_align_matrix"], dtype=np.float64),
        image_ids=image_ids,
        extrinsics=extrinsics,
        image_hw=image_hw,
        depth_maps=np.stack(depth_maps).astype(np.uint16),
        points_aligned=aligned,
        points_unaligned=unaligned,
        instance_ids=instance_ids.astype(np.uint32),
        aligned_bboxes=ab,
        unaligned_bboxes=ub,
        categories=cats,
    )


def load_reference_split(
    info_pkl_path: str, posed_images_root: str, instance_data_root: str
) -> Iterator[Scene]:
    infos = load_pickle(info_pkl_path)
    for scene_id in sorted(infos.keys()):
        yield load_reference_scene(
            infos[scene_id], scene_id, posed_images_root, instance_data_root
        )
