"""Mesh extraction from SDF voxel grids.

Counterpart of `dsp_slam_rgbd_tpu/models/mesh.py` (reference
`MeshExtractor`, `reconstruct/optimizer.py:216-233`, and
`create_voxel_grid`/`convert_sdf_voxels_to_mesh`, `reconstruct/utils.py:97-140`):
decode the SDF on a regular grid over [-1, 1]³ on the device, through the
same value entry the fit uses, then triangulate the zero isosurface on the
host by marching tetrahedra (6 tets per cube: table-free and watertight).
"""
from __future__ import annotations

import numpy as np
import torch

# The 6-tetrahedra decomposition of a unit cube around the main diagonal
# 0-7 (corner k = (x=(k>>0)&1, y=(k>>1)&1, z=(k>>2)&1)); face-consistent
# across adjacent cubes, so the surface is watertight.
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 5, 7],
        [0, 2, 3, 7],
        [0, 2, 6, 7],
        [0, 4, 5, 7],
        [0, 4, 6, 7],
    ],
    dtype=np.int32,
)

_CORNER_OFFSETS = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], dtype=np.int32
)


def create_voxel_grid(vol_dim: int = 64, extent: float = 1.0,
                      device="cpu") -> torch.Tensor:
    """(vol_dim³, 3) grid points over [-extent, extent]³ in (i, j, k) ->
    (x, y, z) row-major order, like the reference's meshgrid flatten
    (`utils.py:97-116`)."""
    lin = torch.linspace(-extent, extent, vol_dim, device=device)
    x, y, z = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def sdf_bbox(decoder, code: torch.Tensor, vol_dim: int = 24, extent: float = 1.1):
    """Bbox of the decoded shape's interior (sdf < 0) from a coarse grid
    decode: (bbox_min, bbox_max) in normalized object coordinates, ±1
    when nothing is inside.  code (L,) gives (3,) boxes; codes (U, L) give
    (U, 3) boxes from ONE decoder query over U×vol_dim³ rows (the JAX
    package vmaps the one-code form)."""
    grid = create_voxel_grid(vol_dim, extent, device=code.device)
    if code.dim() == 2:
        grid = grid.expand(code.shape[0], -1, -1)
    inside = decoder.query(code, grid) < 0.0
    bb_min = torch.amin(torch.where(inside[..., None], grid, torch.inf), dim=-2)
    bb_max = torch.amax(torch.where(inside[..., None], grid, -torch.inf), dim=-2)
    ok = torch.isfinite(bb_min) & torch.isfinite(bb_max)
    return torch.where(ok, bb_min, -1.0), torch.where(ok, bb_max, 1.0)


def marching_tetrahedra(sdf_grid: np.ndarray, extent: float = 1.0):
    """Triangulate the zero isosurface of a (D, D, D) SDF grid.

    Returns (vertices (V, 3) float32 in the grid's world coords,
    faces (F, 3) int32).  Inside is sdf < 0 (SDF convention).
    """
    sdf = np.asarray(sdf_grid, dtype=np.float32)
    D = sdf.shape[0]
    if sdf.shape != (D, D, D):
        raise ValueError(f"sdf grid must be cubic, got {sdf.shape}")
    spacing = 2.0 * extent / (D - 1)

    idx = np.stack(
        np.meshgrid(np.arange(D - 1), np.arange(D - 1), np.arange(D - 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)                                          # (C, 3) cube bases
    corners = idx[:, None, :] + _CORNER_OFFSETS[None, :, :]   # (C, 8, 3)
    vals = sdf[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C, 8)

    # quick reject: cubes with no sign change
    active = (vals.min(axis=1) < 0.0) & (vals.max(axis=1) >= 0.0)
    if not np.any(active):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    vals = vals[active]
    corners = corners[active]

    verts_out = []
    faces_out = []
    n_verts = 0
    pos = corners.astype(np.float32) * spacing - extent      # (Ca, 8, 3)

    for tet in _TETS:
        tv = vals[:, tet]   # (Ca, 4)
        tp = pos[:, tet]    # (Ca, 4, 3)
        inside = tv < 0.0
        case = (
            inside[:, 0].astype(np.int32)
            | (inside[:, 1] << 1)
            | (inside[:, 2] << 2)
            | (inside[:, 3] << 3)
        )

        def interp(sel, a, b):
            """Zero crossing on edge (a, b) for the selected tets."""
            va, vb = tv[sel, a], tv[sel, b]
            t = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return tp[sel, a] * (1 - t) + tp[sel, b] * t

        def orient(tris, sel):
            """Flip triangles whose normal points toward the inside:
            outward = centroid(outside corners) − centroid(inside corners)."""
            w_in = inside[sel].astype(np.float32)
            w_out = 1.0 - w_in
            c_in = (tp[sel] * w_in[..., None]).sum(1) / w_in.sum(1, keepdims=True)
            c_out = (tp[sel] * w_out[..., None]).sum(1) / w_out.sum(1, keepdims=True)
            d = c_out - c_in
            nrm = np.cross(tris[:, :, 1] - tris[:, :, 0],
                           tris[:, :, 2] - tris[:, :, 0])
            flip = (nrm * d[:, None, :]).sum(-1) < 0
            tris = tris.copy()
            tris[flip] = tris[flip][:, [0, 2, 1]]
            return tris

        # one corner inside (or one outside) -> 1 triangle per tet
        single = {1: 0, 2: 1, 4: 2, 8: 3}
        for case_id, ci in single.items():
            others = [k for k in range(4) if k != ci]
            for cid in (case_id, 15 ^ case_id):
                sel = np.nonzero(case == cid)[0]
                if sel.size == 0:
                    continue
                tris = np.stack([interp(sel, ci, e) for e in others], axis=1)[:, None]
                tris = orient(tris, sel)
                verts_out.append(tris.reshape(-1, 3))
                faces_out.append(np.arange(sel.size * 3, dtype=np.int32).reshape(-1, 3)
                                 + n_verts)
                n_verts += sel.size * 3

        # two inside -> quad (2 triangles) per tet
        double = {3: ((0, 1), (2, 3)), 5: ((0, 2), (1, 3)), 9: ((0, 3), (1, 2))}
        for case_id, ((a, b), (c, d)) in double.items():
            for cid in (case_id, 15 ^ case_id):
                sel = np.nonzero(case == cid)[0]
                if sel.size == 0:
                    continue
                # inside pair (a_, b_), outside pair (c_, d_)
                a_, b_, c_, d_ = (a, b, c, d) if cid == case_id else (c, d, a, b)
                pac = interp(sel, a_, c_)
                pad = interp(sel, a_, d_)
                pbd = interp(sel, b_, d_)
                pbc = interp(sel, b_, c_)
                tris = np.stack([np.stack([pac, pad, pbd], axis=1),
                                 np.stack([pac, pbd, pbc], axis=1)], axis=1)
                tris = orient(tris, sel)
                verts_out.append(tris.reshape(-1, 3))
                faces_out.append(np.arange(sel.size * 6, dtype=np.int32).reshape(-1, 3)
                                 + n_verts)
                n_verts += sel.size * 6

    vertices = np.concatenate(verts_out, axis=0).astype(np.float32)
    faces = np.concatenate(faces_out, axis=0).astype(np.int32)
    return _weld(vertices, faces)


def _weld(vertices: np.ndarray, faces: np.ndarray, decimals: int = 6):
    """Merge duplicate vertices (tet faces share edges across cells) and
    drop the faces that degenerate."""
    key = np.round(vertices, decimals)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    faces = inverse.reshape(-1)[faces].astype(np.int32)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return uniq.astype(np.float32), faces[ok]


class MeshExtractor:
    """Grid decode on the decoder's device + host triangulation.

    As the reference `MeshExtractor.extract_mesh_from_code`
    (`optimizer.py:224-233`): returns a dict with `vertices`, `faces`.
    """

    def __init__(self, decoder, code_len: int = 64, voxels_dim: int = 64,
                 compute_dtype=torch.float32):
        self.decoder = decoder
        self.code_len = code_len
        self.voxels_dim = voxels_dim
        self.compute_dtype = compute_dtype
        self.voxel_points = create_voxel_grid(voxels_dim, device=decoder.device)

    def decode(self, code) -> torch.Tensor:
        """SDF values on the grid, (voxels_dim,)*3, on the device."""
        code = torch.as_tensor(code[: self.code_len], dtype=torch.float32,
                               device=self.decoder.device)
        vals = self.decoder.query(code, self.voxel_points, self.compute_dtype)
        return vals.reshape((self.voxels_dim,) * 3)

    def extract_mesh_from_code(self, code):
        vertices, faces = marching_tetrahedra(self.decode(code).cpu().numpy())
        return {"vertices": vertices, "faces": faces}


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              color=(128, 128, 128)) -> None:
    """ASCII PLY writer (reference `utils.py:143-163` role)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        r, g, b = color
        for v in vertices:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {r} {g} {b}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
