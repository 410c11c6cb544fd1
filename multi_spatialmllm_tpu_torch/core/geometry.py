"""Batched camera/scene geometry in PyTorch: the port of
multi_spatialmllm_tpu/core/geometry.py (world <-> camera <-> pixel
transforms, the depth-buffer occlusion test, depth-map unprojection, pose
decompositions, pairwise frame relations).

Every function takes tensors of one device and dtype and runs there: the
data-engine stages call them on the card (f64 for exact labels, f32 as a
speed option) and the tests on the CPU.

Parity with the JAX functions on the CPU (tests/test_torch_geometry.py):
  * Visibility labels are bit-equal in f64 and f32, and the card's f64
    labels equal the CPU's (chip_smoke.py phase 15).
  * The 4-term products (`project_points`, `relative_pose`, `compose`) are
    sums of separate multiplies added in index order, which is how XLA's
    CPU dot rounds them: `compose` is bit-equal, and so is the projection
    given the same inverse. `torch.einsum`, `matmul` and `addcmul` round
    differently in about a fifth of the elements, and separate ops never
    contract into an FMA on CUDA, so the card rounds as the CPU.
  * `se3_inverse` is the closed-form adjugate, never `linalg.inv`. XLA's
    CPU code evaluates its 3-term products as FMA chains (torch has no
    FMA op that rounds alike on both devices), so the inverse and the
    coordinates built on it sit within ~1e-14 relative of the JAX values;
    no label of the test scenes moves.
  * The depth index is `round(x * (wd / w))` with the scale a Python float
    (the order matters at exact .5 boundaries); `torch.round` rounds half
    to even, as `jnp.round` does. Depth maps arrive as int32 (uint16 widens
    exactly; CUDA's uint16 support is too thin for the gather).
  * `yaw_pitch_deg`: `atan2`, `linalg.vector_norm` and `rad2deg` give the
    JAX yaw and distances bit for bit. XLA computes pitch's `z / |z|` with
    an approximate `rsqrt` and `arcsin(x)` as `2 * atan2(x, 1 + sqrt((1 -
    x)(1 + x)))`; the port spells that decomposition with a true division,
    and pitch sits within 4 ulp of the JAX value.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Homogeneous coordinates & SE(3) helpers
# ---------------------------------------------------------------------------

def to_homogeneous(points: Tensor) -> Tensor:
    """Append a 1-column: `[..., N, 3] -> [..., N, 4]`."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    return torch.cat([points, ones], dim=-1)


def _row_dot(M: Tensor, i: int, v: list) -> Tensor:
    """`sum_j M[..., i, j] * v[j]` added in index order, one op a term
    (never fused: the rounding of XLA's dot)."""
    out = M[..., i, 0, None] * v[0]
    for j in range(1, len(v)):
        out = out + M[..., i, j, None] * v[j]
    return out


def _matmul(A: Tensor, B: Tensor) -> Tensor:
    """`A @ B` for `[..., n, k] x [..., k, m]`, each entry summed in index
    order of separate products (the rounding of XLA's dot)."""
    k = A.shape[-1]
    out = A[..., :, 0, None] * B[..., None, 0, :]
    for j in range(1, k):
        out = out + A[..., :, j, None] * B[..., None, j, :]
    return out


def se3_inverse(E: Tensor) -> Tensor:
    """Inverse of a (batch of) affine 4x4 transform(s) (last row
    [0, 0, 0, 1]): the closed-form adjugate of the 3x3 block and the
    translation composed, as the JAX function computes it."""
    R = E[..., :3, :3]
    t = E[..., :3, 3:]
    a, b, c = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    d, e, f = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    g, h, i = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    Rinv = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
        ],
        dim=-2,
    ) * inv_det[..., None, None]
    top = torch.cat([Rinv, -_matmul(Rinv, t)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=E.dtype,
                          device=E.device).expand(E.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rigid_inverse(E: Tensor) -> Tensor:
    """Closed-form inverse for exactly-rigid transforms:
    `[R | t]^-1 = [R^T | -R^T t]`."""
    R = E[..., :3, :3]
    t = E[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -_matmul(Rt, t)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=E.dtype,
                          device=E.device).expand(E.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def compose(*mats: Tensor) -> Tensor:
    """Left-to-right composition `compose(A, B, C) = A @ B @ C`."""
    out = mats[0]
    for m in mats[1:]:
        out = _matmul(out, m)
    return out


# ---------------------------------------------------------------------------
# Projection (world -> pixel)
# ---------------------------------------------------------------------------

def project_points(points: Tensor, K: Tensor,
                   E_c2w: Tensor) -> tuple[Tensor, Tensor]:
    """Project world-space points into an image plane.

    Args:
      points: `[..., N, 3]` world coordinates.
      K: `[..., 4, 4]` intrinsic matrix.
      E_c2w: `[..., 4, 4]` camera-to-world extrinsic.

    Returns:
      xy: `[..., N, 2]` pixel coordinates (x = width axis, y = height axis).
      depth: `[..., N]` camera-frame depth (can be <= 0 behind the camera).
    """
    xy, depth = _project(points, K, E_c2w)
    return torch.stack(xy, dim=-1), depth


def _project(points: Tensor, K: Tensor, E_c2w: Tensor):
    """`project_points` with x and y as separate `[..., N]` tensors (no
    `[..., N, 4]` intermediates: the visibility program holds ~60M
    point-image pairs at a time).

    The homogeneous coordinate of a point is 1, so its term is the matrix
    entry itself; the camera frame's is 1 for every finite pose (an
    invalid pose's row is masked by the caller)."""
    E_inv = se3_inverse(E_c2w)
    p = [points[..., j] for j in range(3)]
    cam = [_row_dot(E_inv, r, p) + E_inv[..., r, 3, None] for r in range(3)]
    img = [_row_dot(K, r, cam) + K[..., r, 3, None] for r in range(3)]
    return (img[0] / img[2], img[1] / img[2]), cam[2]


def in_bounds_mask(xy: Tensor, image_hw) -> Tensor:
    """`[..., N]` mask of pixels inside `[0, W) x [0, H)`."""
    return _in_bounds(xy[..., 0], xy[..., 1], image_hw)


def _in_bounds(x: Tensor, y: Tensor, image_hw) -> Tensor:
    h, w = image_hw[0], image_hw[1]
    return (x >= 0) & (x < w) & (y >= 0) & (y < h)


def depth_occlusion_mask(xy: Tensor, depth: Tensor, depth_map: Tensor,
                         image_hw, depth_value_scale: float = 0.001
                         ) -> Tensor:
    """Z-buffer occlusion test against a (possibly lower-resolution) depth
    map: scale pixel coords to the depth map, round half to even, clip into
    the map, gather, and require `0 < depth < map * scale`.

    Args:
      xy: `[..., N, 2]` pixel coords in *color image* resolution.
      depth: `[..., N]` camera-frame point depth in meters.
      depth_map: `[..., Hd, Wd]` integer depth image (millimeters).
      image_hw: color image `(H, W)`.
    """
    return _occlusion(xy[..., 0], xy[..., 1], depth, depth_map, image_hw,
                      depth_value_scale)


def _occlusion(x: Tensor, y: Tensor, depth: Tensor, depth_map: Tensor,
               image_hw, depth_value_scale: float) -> Tensor:
    hd, wd = depth_map.shape[-2], depth_map.shape[-1]
    h, w = image_hw[0], image_hw[1]
    depth_values = _depth_values(x * (wd / w), y * (hd / h), depth,
                                 depth_map, depth_value_scale)
    return (depth > 0) & (depth < depth_values)


def _depth_values(ux: Tensor, uy: Tensor, depth: Tensor, depth_map: Tensor,
                  depth_value_scale: float) -> Tensor:
    """The z-buffer value (meters, in `depth`'s dtype) at coordinates
    already scaled to the depth map, rounded half to even and clipped."""
    hd, wd = depth_map.shape[-2], depth_map.shape[-1]
    # out-of-range and NaN coordinates convert to some int32; the clip
    # keeps the gather inside the map, and such points fail the bounds
    # test anyway
    dx = torch.round(ux).to(torch.int32).clamp_(0, wd - 1)
    dy = torch.round(uy).to(torch.int32).clamp_(0, hd - 1)
    flat = depth_map.reshape(depth_map.shape[:-2] + (hd * wd,))
    idx = (dy * wd + dx).reshape(flat.shape[:-1] + (-1,)).long()
    del dx, dy
    gathered = torch.gather(flat, -1, idx).reshape(depth.shape)
    del idx
    return gathered.to(depth.dtype) * depth_value_scale


def point_visibility_mask(xy: Tensor, depth: Tensor, depth_map: Tensor,
                          image_hw, depth_value_scale: float = 0.001
                          ) -> Tensor:
    """In-bounds AND unoccluded."""
    return in_bounds_mask(xy, image_hw) & depth_occlusion_mask(
        xy, depth, depth_map, image_hw, depth_value_scale)


def visibility_matrix(points: Tensor, K: Tensor, E_c2w: Tensor,
                      depth_maps: Tensor, image_hw,
                      image_valid: Tensor | None = None,
                      point_valid: Tensor | None = None,
                      depth_value_scale: float = 0.001) -> Tensor:
    """Dense `[I, N]` bool visibility matrix for one scene, or `[S, I, N]`
    for a batch of scenes of one padded shape (leading dims on every
    argument).

    Args:
      points: `[..., N, 3]` (padded; mask padding via `point_valid`).
      K: `[..., 4, 4]` intrinsic.
      E_c2w: `[..., I, 4, 4]` per-image extrinsics (padded; mask via
        `image_valid`).
      depth_maps: `[..., I, Hd, Wd]` integer depth images (int32).
      image_hw: color-image resolution `(H, W)`.
      image_valid: `[..., I]` bool, False for padded/invalid-pose images.
      point_valid: `[..., N]` bool, False for padded points.
    """
    (x, y), depth = _project(points[..., None, :, :], K[..., None, :, :],
                             E_c2w)
    vis = _in_bounds(x, y, image_hw)
    vis &= _occlusion(x, y, depth, depth_maps, image_hw, depth_value_scale)
    if image_valid is not None:
        vis &= image_valid[..., :, None]
    if point_valid is not None:
        vis &= point_valid[..., None, :]
    return vis


def visibility_and_borderline(points: Tensor, K: Tensor, E_c2w: Tensor,
                              depth_maps: Tensor, image_hw,
                              image_valid: Tensor | None = None,
                              point_valid: Tensor | None = None,
                              depth_value_scale: float = 0.001,
                              tol_px: float = 0.01, tol_idx: float = 0.005,
                              tol_depth: float = 1e-4
                              ) -> tuple[Tensor, Tensor]:
    """float32 visibility matrix and a conservative borderline mask, the
    `[..., I, N]` pair `(vis, near)` of the hybrid stage
    (stages/visibility.compute_scene_visibility_hybrid).

    `vis` is `visibility_matrix` in the inputs' dtype (float32); `near`
    flags every pair whose decision sits within float32 rounding distance
    of a comparison boundary: pixel coordinates within `tol_px` pixels of
    the image bounds, depth-map coordinates within `tol_idx` pixels of a
    round-half-to-even boundary, camera depth within `tol_depth` meters of
    zero or of the z-buffer value. The bands assume true float32: the
    projection is elementwise (`_row_dot`), so no TF32 or reduced-precision
    matmul enters it, and separate ops never contract into FMAs."""
    (x, y), depth = _project(points[..., None, :, :], K[..., None, :, :],
                             E_c2w)
    h, w = image_hw[0], image_hw[1]
    hd, wd = depth_maps.shape[-2], depth_maps.shape[-1]
    vis = _in_bounds(x, y, image_hw)
    near = x.abs() <= tol_px
    near |= (x - w).abs() <= tol_px
    near |= y.abs() <= tol_px
    near |= (y - h).abs() <= tol_px
    ux = x * (wd / w)
    del x
    uy = y * (hd / h)
    del y
    near |= (ux - ux.floor() - 0.5).abs() <= tol_idx
    near |= (uy - uy.floor() - 0.5).abs() <= tol_idx
    dv = _depth_values(ux, uy, depth, depth_maps, depth_value_scale)
    del ux, uy
    vis &= (depth > 0) & (depth < dv)
    near |= depth.abs() <= tol_depth
    near |= (depth - dv).abs() <= tol_depth
    if image_valid is not None:
        vis &= image_valid[..., :, None]
        near &= image_valid[..., :, None]
    if point_valid is not None:
        vis &= point_valid[..., None, :]
        near &= point_valid[..., None, :]
    return vis, near


# ---------------------------------------------------------------------------
# Unprojection (pixel + depth -> world)
# ---------------------------------------------------------------------------

def unproject_pixels(pixels_xy: Tensor, depth_map: Tensor, K: Tensor,
                     E_c2w: Tensor, axis_align: Tensor | None = None,
                     mask_hw=None, depth_value_scale: float = 0.001
                     ) -> tuple[Tensor, Tensor]:
    """Lift pixel coordinates to 3D world points via the depth map.

    Returns `points [M, 3]` (world, or axis-aligned) and `valid [M]`
    (depth > 0); zero-depth pixels give points the caller must mask.
    """
    hd, wd = depth_map.shape
    if mask_hw is None:
        mask_hw = (hd, wd)
    x = pixels_xy[:, 0]
    y = pixels_xy[:, 1]
    dx = torch.round(x * (wd / mask_hw[1])).to(torch.int32).clamp_(0, wd - 1)
    dy = torch.round(y * (hd / mask_hw[0])).to(torch.int32).clamp_(0, hd - 1)
    d = depth_map[dy.long(), dx.long()].to(K.dtype) * depth_value_scale
    valid = d > 0
    xf = x.to(K.dtype)
    yf = y.to(K.dtype)
    pix = [xf * d, yf * d, d, torch.ones_like(d)]
    Kinv = se3_inverse(K)
    cam = [_row_dot(Kinv, r, pix) for r in range(4)]
    world = [_row_dot(E_c2w, r, cam) for r in range(4)]
    if axis_align is not None:
        world = [_row_dot(axis_align, r, world) for r in range(4)]
    return torch.stack(world[:3], dim=-1), valid


# ---------------------------------------------------------------------------
# Pose decomposition
# ---------------------------------------------------------------------------

def yaw_pitch_deg(E: Tensor) -> tuple[Tensor, Tensor]:
    """Yaw/pitch (degrees) of the camera forward axis: the rotated z-axis
    (third column of R), yaw = atan2(y, x), pitch = asin(z / ||z||).
    Accepts `[..., 4, 4]` or `[..., 3, 3]`."""
    z = E[..., :3, 2]
    yaw = torch.rad2deg(torch.atan2(z[..., 1], z[..., 0]))
    s = z[..., 2] / torch.linalg.vector_norm(z, dim=-1)
    half = torch.atan2(s, 1 + torch.sqrt((1 - s) * (1 + s)))
    pitch = torch.rad2deg(half + half)
    return yaw, pitch


def relative_pose(E1_c2w: Tensor, E2_c2w: Tensor) -> Tensor:
    """Pose of camera 2 expressed in camera 1's frame: `E1^-1 @ E2`."""
    return _matmul(se3_inverse(E1_c2w), E2_c2w)


def displacement_in_frame1(E1_c2w: Tensor, E2_c2w: Tensor) -> Tensor:
    """Translation of camera 2 in camera 1's coordinates (`[..., 3]`)."""
    return relative_pose(E1_c2w, E2_c2w)[..., :3, 3]


def wrap_yaw_deg(yaw: Tensor) -> Tensor:
    """Wrap a yaw difference into (-180, 180] (one conditional +-360)."""
    yaw = torch.where(yaw > 180.0, yaw - 360.0, yaw)
    return torch.where(yaw < -180.0, yaw + 360.0, yaw)


def camera_center(E_c2w: Tensor) -> Tensor:
    """World-space camera center: translation column of the c2w matrix."""
    return E_c2w[..., :3, 3]


# ---------------------------------------------------------------------------
# Pairwise frame relations
# ---------------------------------------------------------------------------

# an f32 count of visible points is exact below 2^24
_F32_EXACT = 1 << 24


def overlap_percentage_matrix(vis: Tensor,
                              image_valid: Tensor | None = None) -> Tensor:
    """`[..., I, I]` pairwise view-overlap percentage from a visibility
    matrix: overlap(a, b) = |Va & Vb| / |Va | Vb| * 100, intersections as
    `V @ V^T` in f32 (TF32 off), unions by inclusion-exclusion in f64. A
    pair with an empty union is NaN; pairs with an invalid image are 0.

    Raises when the point axis reaches 2^24, where an f32 count stops
    being exact."""
    if vis.shape[-1] >= _F32_EXACT:
        raise ValueError(
            f"overlap counts in f32 are exact below 2^24 points; got "
            f"{vis.shape[-1]}")
    v = vis.to(torch.float32)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        inter = torch.matmul(v, v.transpose(-1, -2)).to(torch.float64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    counts = v.sum(dim=-1).to(torch.float64)
    union = counts[..., :, None] + counts[..., None, :] - inter
    has = union > 0
    pct = torch.where(has, inter / torch.where(has, union, 1.0) * 100.0,
                      torch.nan)
    if image_valid is not None:
        m = image_valid[..., :, None] & image_valid[..., None, :]
        pct = torch.where(m, pct, 0.0)
    return pct


def pairwise_frame_relations(vis: Tensor, E_c2w: Tensor,
                             image_valid: Tensor | None = None
                             ) -> dict[str, Tensor]:
    """All pairwise relations for one scene (or a batch of scenes):
    `[..., I, I]` `overlap` (%), `distance` (m, camera-center L2), `yaw` /
    `pitch` (deg, value[j] - value[i])."""
    overlap = overlap_percentage_matrix(vis, image_valid)
    yaw, pitch = yaw_pitch_deg(E_c2w)
    centers = camera_center(E_c2w)
    diff = centers[..., None, :, :] - centers[..., :, None, :]
    distance = torch.linalg.vector_norm(diff, dim=-1)
    return {
        "overlap": overlap,
        "distance": distance,
        "yaw": yaw[..., None, :] - yaw[..., :, None],
        "pitch": pitch[..., None, :] - pitch[..., :, None],
    }
