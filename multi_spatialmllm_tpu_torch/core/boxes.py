"""Bounding boxes, IoU, AABB and point-cloud filtering as torch ops: the
port of multi_spatialmllm_tpu/core/boxes.py (itself the equivalent of the
reference's `spatial_engine/utils/scannet_utils/handler/ops.py`, cited per
function there). Every function runs on the device of its tensors, batched
over leading dimensions where the JAX function is; the Open3D statistical
outlier filter of the reference is a dense k-NN on the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# corner signs in the reference's order: x fastest, then y, then z
_CORNER_SIGNS = ((-1, -1, -1), (1, -1, -1), (-1, 1, -1), (1, 1, -1),
                 (-1, -1, 1), (1, -1, 1), (-1, 1, 1), (1, 1, 1))


def box_corners(boxes: Tensor) -> Tensor:
    """`[..., 6+]` center/size boxes `[cx, cy, cz, dx, dy, dz, ...]` ->
    their `[..., 8, 3]` corners, (-,-,-) first and (+,+,+) last."""
    c = boxes[..., :3]
    h = boxes[..., 3:6] / 2
    signs = torch.tensor(_CORNER_SIGNS, dtype=boxes.dtype,
                         device=boxes.device)
    return c[..., None, :] + signs * h[..., None, :]


def iou_2d(mask1: Tensor, mask2: Tensor) -> Tensor:
    """IoU of two binary masks (0 when both are empty)."""
    inter = torch.logical_and(mask1, mask2).sum()
    union = torch.logical_or(mask1, mask2).sum()
    return torch.where(union != 0,
                       inter / torch.where(union != 0, union, 1), 0.0)


def iou_3d(box1: Tensor, box2: Tensor) -> Tensor:
    """IoU of axis-aligned center/size boxes `[x, y, z, dx, dy, dz]`; the
    intersection is 0 when any overlap extent is not positive."""
    inter_min = torch.maximum(box1[..., :3] - box1[..., 3:6] / 2,
                              box2[..., :3] - box2[..., 3:6] / 2)
    inter_max = torch.minimum(box1[..., :3] + box1[..., 3:6] / 2,
                              box2[..., :3] + box2[..., 3:6] / 2)
    inter_dim = inter_max - inter_min
    inter_vol = torch.where((inter_dim > 0).all(dim=-1),
                            inter_dim.prod(dim=-1), 0.0)
    v1 = box1[..., 3:6].prod(dim=-1)
    v2 = box2[..., 3:6].prod(dim=-1)
    return inter_vol / (v1 + v2 - inter_vol)


def aabb(points: Tensor, valid: Tensor | None = None) -> Tensor:
    """Axis-aligned bounding box `[cx, cy, cz, dx, dy, dz]` of the points
    `[..., N, 3+]`; `valid` `[..., N]` masks padded rows."""
    pts = points[..., :3]
    if valid is not None:
        lo = torch.where(valid[..., None], pts, torch.inf).amin(dim=-2)
        hi = torch.where(valid[..., None], pts, -torch.inf).amax(dim=-2)
    else:
        lo = pts.amin(dim=-2)
        hi = pts.amax(dim=-2)
    return torch.cat([(hi + lo) / 2, hi - lo], dim=-1)


def coverage_extent(points: Tensor, valid: Tensor, axis: int) -> Tensor:
    """max - min of one coordinate over the valid points; -inf when none
    is valid (so any tolerance check fails)."""
    coords = points[..., axis]
    lo = torch.where(valid, coords, torch.inf).amin(dim=-1)
    hi = torch.where(valid, coords, -torch.inf).amax(dim=-1)
    return hi - lo


def truncated_outlier_mask(points: Tensor, tx: float, ty: float,
                           tz: float) -> Tensor:
    """Per-axis rank trim (True = keep): along each axis drop the
    `int(t * N)` smallest and largest values by (stable) sorted rank, and
    keep the intersection; nothing survives an axis where `2 * cut >= N`."""
    n = points.shape[-2]

    def axis_mask(coords: Tensor, t: float) -> Tensor:
        cut = int(t * n)
        if cut == 0:
            return torch.ones(coords.shape, dtype=torch.bool,
                              device=coords.device)
        if 2 * cut >= n:
            return torch.zeros(coords.shape, dtype=torch.bool,
                               device=coords.device)
        order = torch.argsort(coords, dim=-1, stable=True)
        ranks = torch.empty_like(order).scatter_(
            -1, order, torch.arange(n, device=coords.device).expand_as(order))
        return (ranks >= cut) & (ranks < n - cut)

    return (axis_mask(points[..., 0], tx) & axis_mask(points[..., 1], ty)
            & axis_mask(points[..., 2], tz))


def statistical_outlier_mask(points: Tensor, nb_neighbors: int = 20,
                             std_ratio: float = 1.0) -> Tensor:
    """Statistical outlier mask (True = keep), Open3D's semantics: each
    point's mean distance to its `nb_neighbors` nearest neighbours must be
    at most mean + std_ratio * std of those means over the cloud. Dense
    `[N, N]` squared distances from the Gram matrix."""
    pts = points[..., :3]
    sq = (pts * pts).sum(dim=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * (pts @ pts.transpose(
        -1, -2))
    d2 = d2.clamp_min(0.0)
    n = pts.shape[-2]
    k = min(nb_neighbors, n - 1)
    # the k+1 smallest distances include the point itself (0): drop it
    nearest = torch.topk(d2, k + 1, dim=-1, largest=False).values[..., 1:]
    mean_knn = nearest.sqrt().mean(dim=-1)
    mu = mean_knn.mean(dim=-1, keepdim=True)
    sigma = mean_knn.std(dim=-1, correction=0, keepdim=True)
    return mean_knn <= mu + std_ratio * sigma


def laplacian_sharpness(gray_image: Tensor) -> Tensor:
    """Variance of the 4-neighbour 3x3 Laplacian response with
    BORDER_REFLECT_101 (`cv2.Laplacian(CV_64F).var()`), in float64 for a
    float64 image and float32 otherwise."""
    img = gray_image.to(torch.float64 if gray_image.dtype == torch.float64
                        else torch.float32)
    padded = F.pad(img[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    lap = (padded[:-2, 1:-1] + padded[2:, 1:-1] + padded[1:-1, :-2]
           + padded[1:-1, 2:] - 4.0 * img)
    return lap.var(correction=0)
