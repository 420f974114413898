"""Scene -> device SoA buffers ("compile" the scene for the device renderer).

Replacement for both of the reference's backend scene preps
(raytracing-cpu/src/scene.rs BVH build; raytracing-optix/src/scene.rs GAS/IAS +
SBT + texture upload): the primitive DAG is flattened by composing transform
chains down to each BasicPrimitive (mirroring Scene::descendants_iter
semantics, scene/scene.rs:201-224), triangle geometry is pre-transformed to
world space into structure-of-arrays buffers, a BVH is built over the
world-space triangles and laid out as child-pair rows, and
materials/textures/images/lights become flat indexed tables. Everything is
uploaded once per scene via device_put; renders never re-upload (unlike the
per-launch cudaMemcpy in pipeline.cu:471-556).

Spheres stay in object space with per-sphere o2w/w2o matrices (non-uniform
scales make world-space spheres ellipsoids); scenes have few analytic spheres
so they are brute-force intersected outside the BVH.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..accel import build_bvh
from ..geometry import Sphere, Transform, TriangleMesh
from ..lights import (
    DiffuseAreaLight, DirectionLight, EnvironmentLight, PointLight,
)
from ..ops import bvh_walk_cuda
from ..materials import (
    CheckerTexture, CoatedDiffuse, ConstantTexture, Diffuse, FilterMode,
    ImageTexture, MixTexture, RoughConductor, RoughDielectric, ScaleTexture,
    SmoothConductor, SmoothDielectric,
)
from ..scene import BasicPrimitive, Scene
from ..scene.camera import Orthographic, PinholePerspective, ThinLensPerspective

F = np.float32

# material kinds
MAT_DIFFUSE = 0
MAT_SMOOTH_DIELECTRIC = 1
MAT_SMOOTH_CONDUCTOR = 2
MAT_ROUGH_DIELECTRIC = 3
MAT_ROUGH_CONDUCTOR = 4
MAT_COATED_DIFFUSE = 5

# texture kinds
TEX_IMAGE = 0
TEX_CONSTANT = 1
TEX_CHECKER = 2
TEX_SCALE = 3
TEX_MIX = 4

# light kinds
LIGHT_POINT = 0
LIGHT_DIRECTION = 1
LIGHT_AREA = 2

# camera kinds
CAM_ORTHOGRAPHIC = 0
CAM_PINHOLE = 1
CAM_THIN_LENS = 2


@dataclass(frozen=True)
class SceneMeta:
    """Static (hashable) scene facts; part of the jit specialization key."""

    n_tris: int
    n_spheres: int
    n_lights: int
    n_materials: int
    n_textures: int
    light_kinds: Tuple[int, ...]
    mat_kinds_present: Tuple[int, ...]
    tex_kinds_present: Tuple[int, ...]
    any_trilinear: bool
    any_nearest: bool
    has_env: bool
    env_tex: int
    # camera
    cam_kind: int
    width: int
    height: int
    near_clip: float
    far_clip: float
    aperture_radius: float
    focal_distance: float
    # stack traversal: encoded root child-meta + tree depth (stack bound)
    root_meta: int = -1
    bvh2_depth: int = 1
    # per-callsite texture-kind narrowing (ops/textures.py): kinds
    # reachable from each material slot / the env texture; () = fall
    # back to tex_kinds_present
    slot_kinds: Tuple[Tuple[int, ...], ...] = ()
    env_kinds: Tuple[int, ...] = ()
    # instancing (TLAS-over-shared-BLAS equivalent): per-BLAS statics
    # (n_tris, root_meta, bvh2_depth)
    blas_meta: Tuple[Tuple[int, ...], ...] = ()
    # per-instance statics (blas_id, vtri_base, n_tris, shade_off)
    instances: Tuple[Tuple[int, int, int, int], ...] = ()
    # first virtual-triangle prim id (= n_tris + padded sphere count)
    inst_vtri_base0: int = 0


class BlasTables(NamedTuple):
    """Device tables of one shared BLAS (object-space geometry, built once
    regardless of instance count — counterpart of the reference's IAS over
    shared GAS, csrc/host/scene.cu:162-250 / accel.rs:119-214)."""

    bvh2_rows: jax.Array     # (M, 16) child-pair rows
    tri_pack: jax.Array      # (T, 9)


@jax.tree_util.register_dataclass
@dataclass
class DeviceScene:
    # triangles, world-space, BVH order, padded
    tri_p0: jax.Array
    tri_p1: jax.Array
    tri_p2: jax.Array
    tri_n0: jax.Array
    tri_n1: jax.Array
    tri_n2: jax.Array
    tri_uv0: jax.Array
    tri_uv1: jax.Array
    tri_uv2: jax.Array
    tri_mat: jax.Array
    tri_light: jax.Array
    tri_has_n: jax.Array
    tri_has_uv: jax.Array
    # tri_pack (T, 9) f32 = [p0, p1, p2], one row per leaf triangle
    tri_pack: jax.Array
    # single-gather shading rows (one wide row gather per hit instead of
    # 13 narrow ones):
    # tri_shade (T, 32): p0 p1 p2 n0 n1 n2 uv0 uv1 uv2 | bits: mat light
    # has_n has_uv; em_shade (E, 24): p0 p1 p2 n0 n1 n2 area bits(has_n)
    tri_shade: jax.Array
    em_shade: jax.Array
    mat_pack: jax.Array   # (M, 8) i32: kind, tex0..4, remap
    tex_pack: jax.Array   # (X, 16) f32: v0, v1, bits[ref0/first_level,
                          # ref1, ref2, kind, filter, wrap, n_levels]
    # material-major join of the 5 texture slots' rows (M, 80): slot j's
    # tex_pack row (of max(tex_id, 0), matching eval_texture's clamp) at
    # cols 16j..16j+16 — ONE row gather per bounce replaces the material
    # row + five texture row gathers
    mat_tex_rows: jax.Array
    lvl_pack: jax.Array   # (LV, 4) i32: offset, w, h
    # child-pair rows for stack-based near-first traversal: one row per
    # INTERNAL node = [L.min, L.max, R.min, R.max, bits(metaL), bits(metaR),
    # pad, pad] (16 f32). meta encodes a child: leaf -> (first<<3)|count
    # (count in 1..MAX_LEAF), internal -> row_index<<3 (low bits 0).
    bvh2_rows: jax.Array
    # spheres (object-space)
    sph_center: jax.Array
    sph_radius: jax.Array
    sph_o2w: jax.Array
    sph_w2o: jax.Array
    sph_mat: jax.Array
    sph_light: jax.Array
    # materials
    mat_kind: jax.Array
    mat_tex: jax.Array      # (M, 5) texture ids, -1 = unset
    mat_remap: jax.Array    # (M,) bool remap_roughness
    # textures (one level of indirection; scale/mix reference leaves)
    tex_kind: jax.Array
    tex_v0: jax.Array       # (X, 4) constant value / checker color1
    tex_v1: jax.Array       # (X, 4) checker color2
    tex_ref: jax.Array      # (X, 3) scale/mix refs or (image_id, -1, -1)
    tex_filter: jax.Array
    tex_wrap: jax.Array
    # image mip atlas
    img_texels: jax.Array        # (P, 4)
    # quad atlas: row i = the full clamped 2x2 bilinear footprint anchored
    # at texel i ([p(x,y), p(x+1,y), p(x,y+1), p(x+1,y+1)], +1 edge-clamped
    # at build time) — ONE row gather per bilerp tap instead of four.
    # None unless TPU_RT_QUAD_ATLAS=1 forces it (and the scene has images
    # within the memory cap); textures.py then uses the 4-gather path.
    img_quads: Optional[jax.Array]  # (P, 16) or None
    img_level_offset: jax.Array  # (LV,)
    img_level_w: jax.Array
    img_level_h: jax.Array
    img_first_level: jax.Array   # (I,)
    img_n_levels: jax.Array
    # lights
    light_kind: jax.Array
    light_va: jax.Array     # (L, 3) position / direction
    light_vb: jax.Array     # (L, 3) intensity / radiance
    light_emit_first: jax.Array
    light_emit_count: jax.Array
    # area-light emitter triangles (world-space)
    em_p0: jax.Array
    em_p1: jax.Array
    em_p2: jax.Array
    em_n0: jax.Array
    em_n1: jax.Array
    em_n2: jax.Array
    em_area: jax.Array
    em_has_n: jax.Array
    # camera
    cam_raster_to_camera: jax.Array  # (4, 4)
    cam_camera_to_world: jax.Array   # (4, 4)
    cam_min_diff: jax.Array          # (4, 3) x_o, y_o, x_d, y_d
    # scene bounds
    bounds_center: jax.Array
    bounds_radius: jax.Array
    # instancing: shared-BLAS tables + per-instance transforms
    blas_tables: Tuple[BlasTables, ...]
    inst_xf: jax.Array        # (max(1,I), 32) f32: [o2w 16 | w2o 16] row-major
    inst_aabb_min: jax.Array  # (max(1,I), 3) instance world AABB
    inst_aabb_max: jax.Array
    # static (hashable; not a pytree leaf)
    meta: SceneMeta = field(metadata=dict(static=True))


def _child_pair_layout(bvh):
    """Child-pair rows for stack traversal. Returns (rows, root_meta, depth).

    In the preorder skip-link layout the left child of internal i is i+1 and
    the right child is skip[i+1]; each internal node's row stores BOTH child
    boxes so near-first descent needs one gather per step.
    """
    count = bvh.count
    n_nodes = count.shape[0]
    is_int = count == 0
    if bvh.prim_order.shape[0] == 0:
        return np.zeros((8, 16), F), -1, 1
    row_of = np.full(n_nodes, -1, np.int64)
    row_of[np.nonzero(is_int)[0]] = np.arange(int(is_int.sum()))

    def child_meta(c):
        if count[c] > 0:
            return (int(bvh.left_first[c]) << 3) | int(count[c])
        return int(row_of[c]) << 3

    m = int(is_int.sum())
    if m == 0:
        # single-leaf tree: root itself is a leaf
        root_meta = (int(bvh.left_first[0]) << 3) | int(count[0])
        return np.zeros((8, 16), F), root_meta, 1

    ints = np.nonzero(is_int)[0]
    left = ints + 1
    right = bvh.skip[left].astype(np.int64)

    def child_metas(c):
        leaf = count[c] > 0
        return np.where(
            leaf,
            (bvh.left_first[c].astype(np.int64) << 3) | count[c],
            row_of[c] << 3,
        ).astype(np.int32)

    rows = np.zeros((m, 16), F)
    rows[:, 0:3] = bvh.node_min[left]
    rows[:, 3:6] = bvh.node_max[left]
    rows[:, 6:9] = bvh.node_min[right]
    rows[:, 9:12] = bvh.node_max[right]
    rows[:, 12] = child_metas(left).view(F)
    rows[:, 13] = child_metas(right).view(F)
    root_meta = 0  # root is internal -> row 0 (preorder)

    # tree depth bounds the traversal stack (static, per scene); children
    # always have larger preorder indices so one forward sweep suffices
    depth = np.zeros(n_nodes, np.int64)
    # preorder: a parent precedes its children, so one forward sweep works
    for i in ints:
        l = i + 1
        r = int(bvh.skip[l])
        depth[l] = depth[r] = depth[i] + 1
    maxd = int(depth.max()) + 1
    rows = _pad_rows(rows, _round_up(m, 8))
    return rows, root_meta, maxd


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0], *a.shape[1:]), fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _flatten_primitives(scene: Scene):
    """Yield (BasicPrimitive, prim_index, composed world Transform)."""
    out = []

    def walk(agg_idx: int, outer: Transform):
        for i in range(len(scene.get_aggregate(agg_idx).children)):
            idx, t = scene.get_descendant(agg_idx, i)
            composed = t.compose(outer)
            prim = scene.get_primitive(idx)
            if isinstance(prim, BasicPrimitive):
                out.append((prim, idx, composed))
            else:
                walk(idx, composed)

    walk(scene.root_index(), Transform.identity())
    return out


def _normal_matrix(t: Transform) -> np.ndarray:
    return t.inverse[:3, :3].T.copy()


def _build_mip_pyramid(data: np.ndarray):
    """Box-filter mip pyramid over a pow2-square padded copy.

    The reference uses a Lanczos3 pyramid (texture.rs:114-165); box filtering
    is a placeholder with the same level structure (refine later).
    """
    h, w = data.shape[:2]
    size = 1 << int(np.ceil(np.log2(max(h, w, 1))))
    levels = []
    if (h, w) != (size, size):
        ys = (np.arange(size) * h // size).clip(0, h - 1)
        xs = (np.arange(size) * w // size).clip(0, w - 1)
        cur = data[ys][:, xs]
    else:
        cur = data
    levels.append(cur.astype(F))
    while cur.shape[0] > 1:
        cur = (
            cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
        ) * 0.25
        levels.append(cur.astype(F))
    return levels


class _TriAccel(NamedTuple):
    """Host-side accel tables for one triangle set (world soup or one BLAS)."""

    tri_p0: np.ndarray
    tri_p1: np.ndarray
    tri_p2: np.ndarray
    tri_n0: np.ndarray
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_uv0: np.ndarray
    tri_uv1: np.ndarray
    tri_uv2: np.ndarray
    tri_mat: np.ndarray
    tri_light: np.ndarray
    tri_has_n: np.ndarray
    tri_has_uv: np.ndarray
    tri_pack: np.ndarray
    bvh2_rows: np.ndarray
    n_tris: int
    root_meta: int
    bvh2_depth: int
    root_min: np.ndarray
    root_max: np.ndarray


def _accel_tables(
    tri_p0, tri_p1, tri_p2, tri_n0, tri_n1, tri_n2,
    tri_uv0, tri_uv1, tri_uv2, tri_mat, tri_light, tri_has_n, tri_has_uv,
) -> _TriAccel:
    """Build the BVH and its traversal tables over one triangle set."""
    n_tris = tri_p0.shape[0]
    prim_min = np.minimum(np.minimum(tri_p0, tri_p1), tri_p2)
    prim_max = np.maximum(np.maximum(tri_p0, tri_p1), tri_p2)
    bvh = build_bvh(prim_min, prim_max)
    order = bvh.prim_order
    if n_tris:
        tri_p0, tri_p1, tri_p2 = tri_p0[order], tri_p1[order], tri_p2[order]
        tri_n0, tri_n1, tri_n2 = tri_n0[order], tri_n1[order], tri_n2[order]
        tri_uv0, tri_uv1, tri_uv2 = tri_uv0[order], tri_uv1[order], tri_uv2[order]
        tri_mat, tri_light = tri_mat[order], tri_light[order]
        tri_has_n, tri_has_uv = tri_has_n[order], tri_has_uv[order]

    t_pad = _round_up(n_tris, 8)
    tri_p0 = _pad_rows(tri_p0, t_pad)
    tri_p1 = _pad_rows(tri_p1, t_pad)
    tri_p2 = _pad_rows(tri_p2, t_pad)
    tri_n0 = _pad_rows(tri_n0, t_pad)
    tri_n1 = _pad_rows(tri_n1, t_pad)
    tri_n2 = _pad_rows(tri_n2, t_pad)
    tri_uv0 = _pad_rows(tri_uv0, t_pad)
    tri_uv1 = _pad_rows(tri_uv1, t_pad)
    tri_uv2 = _pad_rows(tri_uv2, t_pad)
    tri_mat = _pad_rows(tri_mat, t_pad)
    tri_light = _pad_rows(tri_light, t_pad, fill=-1)
    tri_has_n = _pad_rows(tri_has_n, t_pad)
    tri_has_uv = _pad_rows(tri_has_uv, t_pad)

    tri_pack = np.concatenate([tri_p0, tri_p1, tri_p2], axis=1).astype(F)
    bvh2_rows, root_meta, bvh2_depth = _child_pair_layout(bvh)
    if bvh2_depth > bvh_walk_cuda.MAX_STACK:
        raise ValueError(
            f"BVH depth {bvh2_depth} exceeds the traversal stack "
            f"({bvh_walk_cuda.MAX_STACK} entries)"
        )

    if n_tris:
        root_min = prim_min.min(axis=0).astype(F)
        root_max = prim_max.max(axis=0).astype(F)
    else:
        root_min = np.full(3, np.inf, F)
        root_max = np.full(3, -np.inf, F)

    return _TriAccel(
        tri_p0, tri_p1, tri_p2, tri_n0, tri_n1, tri_n2,
        tri_uv0, tri_uv1, tri_uv2, tri_mat, tri_light, tri_has_n, tri_has_uv,
        tri_pack, bvh2_rows,
        int(n_tris), int(root_meta), int(bvh2_depth), root_min, root_max,
    )

def _tri_shade_rows(a: _TriAccel) -> np.ndarray:
    """(T, 32) single-gather shading rows from accel-ordered tri arrays."""
    sh = np.zeros((a.tri_p0.shape[0], 32), F)
    sh[:, 0:3] = a.tri_p0
    sh[:, 3:6] = a.tri_p1
    sh[:, 6:9] = a.tri_p2
    sh[:, 9:12] = a.tri_n0
    sh[:, 12:15] = a.tri_n1
    sh[:, 15:18] = a.tri_n2
    sh[:, 18:20] = a.tri_uv0
    sh[:, 20:22] = a.tri_uv1
    sh[:, 22:24] = a.tri_uv2
    sh[:, 24] = a.tri_mat.astype(np.int32).view(F)
    sh[:, 25] = a.tri_light.astype(np.int32).view(F)
    sh[:, 26] = a.tri_has_n.astype(np.int32).view(F)
    sh[:, 27] = a.tri_has_uv.astype(np.int32).view(F)
    return sh


def _mesh_tri_arrays(mesh, mat_id: int, light_id: int):
    """Object-space per-triangle SoA arrays of one mesh (no transform)."""
    tri = mesh.tris.astype(np.int64)
    nt = tri.shape[0]
    v = mesh.vertices.astype(F)
    p0, p1, p2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    if mesh.has_normals:
        n = mesh.normals.astype(F)
        n0, n1, n2 = n[tri[:, 0]], n[tri[:, 1]], n[tri[:, 2]]
        has_n = np.ones(nt, bool)
    else:
        n0 = n1 = n2 = np.zeros((nt, 3), F)
        has_n = np.zeros(nt, bool)
    if mesh.has_uvs:
        uv = mesh.uvs.astype(F)
        uv0, uv1, uv2 = uv[tri[:, 0]], uv[tri[:, 1]], uv[tri[:, 2]]
        has_uv = np.ones(nt, bool)
    else:
        uv0 = uv1 = uv2 = np.zeros((nt, 2), F)
        has_uv = np.zeros(nt, bool)
    return (
        p0, p1, p2, n0, n1, n2, uv0, uv1, uv2,
        np.full(nt, mat_id, np.int32), np.full(nt, light_id, np.int32),
        has_n, has_uv,
    )


# shared meshes below this size are cheaper to duplicate world-space than to
# pay an extra per-instance kernel dispatch
INSTANCE_MIN_TRIS = int(os.environ.get("TPU_RT_INSTANCE_MIN_TRIS", "16"))


def compile_scene(scene: Scene) -> DeviceScene:
    prims = _flatten_primitives(scene)

    # ---------------- triangles + spheres
    tp0, tp1, tp2 = [], [], []
    tn0, tn1, tn2 = [], [], []
    tuv0, tuv1, tuv2 = [], [], []
    tmat, tlight, thasn, thasuv = [], [], [], []
    sph = []

    # shared-prim detection: a BasicPrimitive reached through >1 transform
    # chain is an INSTANCE group — its mesh is built once as an object-space
    # BLAS and traversed per instance with transformed rays (reference:
    # accel.rs:119-214 nested BVHs / scene.cu:162-250 IAS over shared GAS).
    # Emissive prims and tiny meshes are baked world-space instead.
    occ_count: dict = {}
    for _, prim_idx, _ in prims:
        occ_count[prim_idx] = occ_count.get(prim_idx, 0) + 1
    inst_groups: dict = {}  # prim_idx -> [transforms]

    for prim, prim_idx, t in prims:
        mat_id = prim.material if prim.material is not None else 0
        light_id = prim.area_light if prim.area_light is not None else -1
        shape = prim.shape
        if isinstance(shape, Sphere):
            sph.append((shape, t, mat_id, light_id))
            continue
        assert isinstance(shape, TriangleMesh)
        if (
            occ_count[prim_idx] > 1
            and prim.area_light is None
            and shape.mesh.tris.shape[0] >= INSTANCE_MIN_TRIS
        ):
            inst_groups.setdefault(prim_idx, (prim, []))[1].append(t)
            continue
        mesh = shape.mesh
        nt = mesh.tris.shape[0]
        if nt == 0:
            continue
        m = t.forward
        verts_h = mesh.vertices @ m[:3, :3].T + m[:3, 3]
        tri = mesh.tris.astype(np.int64)
        tp0.append(verts_h[tri[:, 0]])
        tp1.append(verts_h[tri[:, 1]])
        tp2.append(verts_h[tri[:, 2]])
        if mesh.has_normals:
            nm = _normal_matrix(t)
            norms = mesh.normals @ nm.T
            tn0.append(norms[tri[:, 0]])
            tn1.append(norms[tri[:, 1]])
            tn2.append(norms[tri[:, 2]])
            thasn.append(np.ones(nt, bool))
        else:
            z = np.zeros((nt, 3), F)
            tn0.append(z)
            tn1.append(z)
            tn2.append(z)
            thasn.append(np.zeros(nt, bool))
        if mesh.has_uvs:
            tuv0.append(mesh.uvs[tri[:, 0]])
            tuv1.append(mesh.uvs[tri[:, 1]])
            tuv2.append(mesh.uvs[tri[:, 2]])
            thasuv.append(np.ones(nt, bool))
        else:
            z = np.zeros((nt, 2), F)
            tuv0.append(z)
            tuv1.append(z)
            tuv2.append(z)
            thasuv.append(np.zeros(nt, bool))
        tmat.append(np.full(nt, mat_id, np.int32))
        tlight.append(np.full(nt, light_id, np.int32))

    def cat(parts, shape, dtype=F):
        if parts:
            return np.concatenate(parts, axis=0).astype(dtype)
        return np.zeros((0, *shape), dtype)

    acc = _accel_tables(
        cat(tp0, (3,)), cat(tp1, (3,)), cat(tp2, (3,)),
        cat(tn0, (3,)), cat(tn1, (3,)), cat(tn2, (3,)),
        cat(tuv0, (2,)), cat(tuv1, (2,)), cat(tuv2, (2,)),
        cat(tmat, (), np.int32), cat(tlight, (), np.int32),
        cat(thasn, (), bool), cat(thasuv, (), bool),
    )
    n_tris = acc.n_tris
    (tri_p0, tri_p1, tri_p2, tri_n0, tri_n1, tri_n2,
     tri_uv0, tri_uv1, tri_uv2, tri_mat, tri_light,
     tri_has_n, tri_has_uv) = acc[:13]
    tri_pack, bvh2_rows = acc.tri_pack, acc.bvh2_rows
    root_meta, bvh2_depth = acc.root_meta, acc.bvh2_depth

    # ---------------- shared BLAS + instance tables
    blas_accels: list[_TriAccel] = []
    blas_meta = []
    instances = []          # (blas_id, vtri_base placeholder, n_tris, shade_off)
    inst_mats = []          # (o2w 4x4, w2o 4x4)
    inst_aabbs = []         # (min3, max3) world
    blas_shade_rows = []
    shade_off = _round_up(n_tris, 8)  # main tri_shade rows come first (padded)
    for prim_idx, (prim, transforms) in inst_groups.items():
        mat_id = prim.material if prim.material is not None else 0
        b = _accel_tables(*_mesh_tri_arrays(prim.shape.mesh, mat_id, -1))
        blas_id = len(blas_accels)
        blas_accels.append(b)
        blas_meta.append((b.n_tris, b.root_meta, b.bvh2_depth))
        blas_shade_rows.append(_tri_shade_rows(b))
        corners = np.array(
            [[b.root_min[0] if sx < 0 else b.root_max[0],
              b.root_min[1] if sy < 0 else b.root_max[1],
              b.root_min[2] if sz < 0 else b.root_max[2]]
             for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], F
        )
        for t in transforms:
            m = t.forward
            wc = corners @ m[:3, :3].T + m[:3, 3]
            inst_aabbs.append((wc.min(axis=0), wc.max(axis=0)))
            inst_mats.append((m.astype(F), t.inverse.astype(F)))
            instances.append((blas_id, 0, b.n_tris, shade_off))
        shade_off += blas_shade_rows[-1].shape[0]

    # ---------------- spheres
    n_spheres = len(sph)
    s_pad = _round_up(n_spheres, 8) if n_spheres else 0
    sph_center = np.zeros((s_pad, 3), F)
    sph_radius = np.zeros(s_pad, F)
    sph_o2w = np.tile(np.eye(4, dtype=F), (s_pad, 1, 1))
    sph_w2o = np.tile(np.eye(4, dtype=F), (s_pad, 1, 1))
    sph_mat = np.zeros(s_pad, np.int32)
    sph_light = np.full(s_pad, -1, np.int32)
    for i, (shape, t, mat_id, light_id) in enumerate(sph):
        sph_center[i] = shape.center
        sph_radius[i] = shape.radius
        sph_o2w[i] = t.forward
        sph_w2o[i] = t.inverse
        sph_mat[i] = mat_id
        sph_light[i] = light_id

    # virtual-triangle prim id ranges: [0, n_tris) main world tris,
    # [n_tris, n_tris + s_pad) spheres, then one contiguous block per
    # instance (decoded back to shared BLAS rows in hit_details)
    inst_vtri_base0 = n_tris + s_pad
    base = inst_vtri_base0
    for i, (blas_id, _, nt_b, so) in enumerate(instances):
        instances[i] = (blas_id, base, nt_b, so)
        base += nt_b

    # ---------------- scene bounds (world AABB of all geometry)
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    if n_tris:
        lo = np.minimum(lo, acc.root_min)
        hi = np.maximum(hi, acc.root_max)
    for amin, amax in inst_aabbs:
        lo = np.minimum(lo, amin)
        hi = np.maximum(hi, amax)
    for i in range(n_spheres):
        c, r = sph_center[i], sph_radius[i]
        corners = c[None, :] + r * np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], F
        )
        m = sph_o2w[i]
        wc = corners @ m[:3, :3].T + m[:3, 3]
        lo = np.minimum(lo, wc.min(axis=0))
        hi = np.maximum(hi, wc.max(axis=0))
    if not np.all(np.isfinite(lo)):
        lo, hi = np.zeros(3), np.zeros(3)
    bounds_center = ((lo + hi) * 0.5).astype(F)
    bounds_radius = F(np.linalg.norm(hi - lo) * 0.5)

    # ---------------- materials
    n_mats = max(1, len(scene.materials))
    mat_kind = np.zeros(n_mats, np.int32)
    mat_tex = np.full((n_mats, 5), -1, np.int32)
    mat_remap = np.zeros(n_mats, bool)
    kinds_present = set()
    for i, m in enumerate(scene.materials):
        if isinstance(m, Diffuse):
            mat_kind[i] = MAT_DIFFUSE
            mat_tex[i, 0] = m.albedo
        elif isinstance(m, SmoothDielectric):
            mat_kind[i] = MAT_SMOOTH_DIELECTRIC
            mat_tex[i, 0] = m.eta
        elif isinstance(m, SmoothConductor):
            mat_kind[i] = MAT_SMOOTH_CONDUCTOR
            mat_tex[i, 0] = m.eta
            mat_tex[i, 1] = m.kappa
        elif isinstance(m, RoughDielectric):
            mat_kind[i] = MAT_ROUGH_DIELECTRIC
            mat_tex[i, 0] = m.eta
            mat_tex[i, 2] = m.roughness
            mat_remap[i] = m.remap_roughness
        elif isinstance(m, RoughConductor):
            mat_kind[i] = MAT_ROUGH_CONDUCTOR
            mat_tex[i, 0] = m.eta
            mat_tex[i, 1] = m.kappa
            mat_tex[i, 2] = m.roughness
            mat_remap[i] = m.remap_roughness
        elif isinstance(m, CoatedDiffuse):
            mat_kind[i] = MAT_COATED_DIFFUSE
            mat_tex[i, 0] = m.diffuse_albedo
            mat_tex[i, 1] = m.dielectric_eta
            mat_tex[i, 2] = (
                m.dielectric_roughness if m.dielectric_roughness is not None else -1
            )
            mat_tex[i, 3] = m.thickness
            mat_tex[i, 4] = m.coat_albedo
            mat_remap[i] = m.dielectric_remap_roughness
        else:
            raise TypeError(f"unknown material: {m}")
        kinds_present.add(int(mat_kind[i]))
    if not scene.materials:
        kinds_present.add(MAT_DIFFUSE)

    # ---------------- images (mip atlas)
    trilinear_images = set()
    any_nearest = False
    for t in scene.textures:
        if isinstance(t, ImageTexture) and t.sampler.filter == FilterMode.TRILINEAR:
            trilinear_images.add(t.image)
        if isinstance(t, ImageTexture) and t.sampler.filter == FilterMode.NEAREST:
            any_nearest = True

    texels = []
    level_offset, level_w, level_h = [], [], []
    img_first_level = np.zeros(max(1, len(scene.images)), np.int32)
    img_n_levels = np.zeros(max(1, len(scene.images)), np.int32)
    offset = 0
    for i, img in enumerate(scene.images):
        if i in trilinear_images:
            levels = _build_mip_pyramid(img.data)
        else:
            levels = [img.data.astype(F)]
        img_first_level[i] = len(level_offset)
        img_n_levels[i] = len(levels)
        for lv in levels:
            h, w = lv.shape[:2]
            level_offset.append(offset)
            level_w.append(w)
            level_h.append(h)
            texels.append(lv.reshape(-1, 4))
            offset += h * w
    img_texels = (
        np.concatenate(texels, axis=0).astype(F)
        if texels
        else np.zeros((1, 4), F)
    )
    img_level_offset = np.asarray(level_offset or [0], np.int32)
    img_level_w = np.asarray(level_w or [1], np.int32)
    img_level_h = np.asarray(level_h or [1], np.int32)

    # quad atlas (see DeviceScene.img_quads): folds the 2x2 bilinear
    # footprint into one 16-wide row, capped at 256 MB. Off unless
    # TPU_RT_QUAD_ATLAS=1: the wider gather restructures XLA:CPU's fused
    # shading loops enough that FMA contraction becomes chunk-shape-
    # dependent, which breaks the CPU backend's bit-exact chunk invariance.
    quad_on = os.environ.get("TPU_RT_QUAD_ATLAS", "0") != "0"
    img_quads = None
    if (
        texels
        and img_texels.shape[0] * 64 <= 256 * 1024 * 1024
        and quad_on
    ):
        quads = []
        for off, w, h in zip(level_offset, level_w, level_h):
            lvl = img_texels[off:off + w * h].reshape(h, w, 4)
            xp = np.concatenate([lvl[:, 1:], lvl[:, -1:]], axis=1)
            q_top = np.concatenate([lvl, xp], axis=2)          # (h, w, 8)
            q_bot = np.concatenate([q_top[1:], q_top[-1:]], axis=0)
            quads.append(
                np.concatenate([q_top, q_bot], axis=2).reshape(-1, 16)
            )
        img_quads = np.concatenate(quads, axis=0).astype(F)

    # ---------------- textures
    n_tex = max(1, len(scene.textures))
    tex_kind = np.full(n_tex, TEX_CONSTANT, np.int32)
    tex_v0 = np.zeros((n_tex, 4), F)
    tex_v1 = np.zeros((n_tex, 4), F)
    tex_ref = np.full((n_tex, 3), -1, np.int32)
    tex_filter = np.zeros(n_tex, np.int32)
    tex_wrap = np.zeros(n_tex, np.int32)
    for i, t in enumerate(scene.textures):
        if isinstance(t, ImageTexture):
            tex_kind[i] = TEX_IMAGE
            tex_ref[i, 0] = t.image
            tex_filter[i] = int(t.sampler.filter)
            tex_wrap[i] = int(t.sampler.wrap)
        elif isinstance(t, ConstantTexture):
            tex_kind[i] = TEX_CONSTANT
            tex_v0[i] = t.value
        elif isinstance(t, CheckerTexture):
            tex_kind[i] = TEX_CHECKER
            tex_v0[i] = t.color1
            tex_v1[i] = t.color2
        elif isinstance(t, ScaleTexture):
            tex_kind[i] = TEX_SCALE
            tex_ref[i, 0] = t.a
            tex_ref[i, 1] = t.b
        elif isinstance(t, MixTexture):
            tex_kind[i] = TEX_MIX
            tex_ref[i, 0] = t.a
            tex_ref[i, 1] = t.b
            tex_ref[i, 2] = t.c
        else:
            raise TypeError(f"unknown texture: {t}")

    # packed single-gather rows for materials / textures / mip levels
    mat_pack = np.zeros((n_mats, 8), np.int32)
    mat_pack[:, 0] = mat_kind
    mat_pack[:, 1:6] = mat_tex
    mat_pack[:, 6] = mat_remap.astype(np.int32)

    tex_pack = np.zeros((n_tex, 16), F)
    tex_pack[:, 0:4] = tex_v0
    tex_pack[:, 4:8] = tex_v1
    ti = np.zeros((n_tex, 8), np.int32)
    # for image textures, bake the image indirection in: slot 0 becomes the
    # image's first mip level and slot 6 its level count
    is_img = tex_kind == TEX_IMAGE
    img_id = np.maximum(tex_ref[:, 0], 0)
    ti[:, 0] = np.where(is_img, img_first_level[img_id], tex_ref[:, 0])
    ti[:, 1] = tex_ref[:, 1]
    ti[:, 2] = tex_ref[:, 2]
    ti[:, 3] = tex_kind
    ti[:, 4] = tex_filter
    ti[:, 5] = tex_wrap
    ti[:, 6] = np.where(is_img, img_n_levels[img_id], 0)
    tex_pack[:, 8:16] = ti.view(F)

    # material-major join of the texture slots' rows (see DeviceScene doc).
    # Unset slots (-1) get a synthetic constant-zero row instead of row 0:
    # their values are never semantically consumed (materials.rs only reads
    # slots its kind defines; the roughness slot is guarded by tex>=0), and
    # a constant row keeps them out of the per-slot kind sets below.
    unset_row = np.zeros(16, F)
    ur_i = np.zeros(8, np.int32)
    ur_i[3] = TEX_CONSTANT
    unset_row[8:16] = ur_i.view(F)
    mat_tex_rows = np.zeros((n_mats, 5 * 16), F)
    for j in range(5):
        rows = tex_pack[np.maximum(mat_tex[:, j], 0)].copy()
        rows[mat_tex[:, j] < 0] = unset_row
        mat_tex_rows[:, 16 * j:16 * (j + 1)] = rows

    # static per-callsite texture-kind narrowing: the set of texture kinds
    # reachable from each material slot (through scale/mix children) and
    # from the environment texture. eval_texture's per-kind branches are
    # trace-time `if kind in kinds` — a slot whose textures are all
    # constants skips the whole image path and its texel gathers.
    def _reach_kinds(tid0: int) -> set:
        out, stack, seen = set(), [int(tid0)], set()
        while stack:
            t = stack.pop()
            if t < 0 or t >= n_tex or t in seen:
                continue
            seen.add(t)
            k = int(tex_kind[t])
            out.add(k)
            if k in (TEX_SCALE, TEX_MIX):
                stack.extend(int(r) for r in tex_ref[t] if r >= 0)
        return out or {TEX_CONSTANT}

    slot_kind_sets = []
    for j in range(5):
        ks = set()
        for i in range(n_mats):
            t = int(mat_tex[i, j])
            if t < 0:
                ks.add(TEX_CONSTANT)      # the synthetic unset row
                if j == 0:
                    # the AOV albedo path gathers tex_pack[max(tid, 0)]
                    # directly, so unset slot-0 ids read row 0 there
                    ks |= _reach_kinds(0)
            else:
                ks |= _reach_kinds(t)
        slot_kind_sets.append(tuple(sorted(ks)))
    if os.environ.get("TPU_RT_SLOT_KINDS", "1") == "0":
        # escape hatch: None entries fall back to the scene-wide kind set
        # at every call site (pre-narrowing executable shape)
        slot_kind_sets = [None] * 5

    lvl_pack = np.zeros((img_level_offset.shape[0], 4), np.int32)
    lvl_pack[:, 0] = img_level_offset
    lvl_pack[:, 1] = img_level_w
    lvl_pack[:, 2] = img_level_h

    # ---------------- lights
    n_lights = len(scene.lights)
    l_pad = max(1, n_lights)
    light_kind = np.zeros(l_pad, np.int32)
    light_va = np.zeros((l_pad, 3), F)
    light_vb = np.zeros((l_pad, 3), F)
    light_emit_first = np.zeros(l_pad, np.int32)
    light_emit_count = np.zeros(l_pad, np.int32)
    em_p0, em_p1, em_p2 = [], [], []
    em_n0, em_n1, em_n2 = [], [], []
    em_area, em_has_n = [], []
    light_kinds = []
    em_offset = 0
    for i, light in enumerate(scene.lights):
        if isinstance(light, PointLight):
            light_kind[i] = LIGHT_POINT
            light_va[i] = light.position
            light_vb[i] = light.intensity
        elif isinstance(light, DirectionLight):
            light_kind[i] = LIGHT_DIRECTION
            light_va[i] = light.direction
            light_vb[i] = light.radiance
        elif isinstance(light, DiffuseAreaLight):
            light_kind[i] = LIGHT_AREA
            light_vb[i] = light.radiance
            prim = scene.get_basic(light.prim_id)
            assert isinstance(prim.shape, TriangleMesh), (
                "area lights on analytic spheres are unsupported "
                "(reference: lights.rs:55 todo!())"
            )
            mesh = prim.shape.mesh
            m = np.asarray(light.light_to_world, F)
            verts_w = mesh.vertices @ m[:3, :3].T + m[:3, 3]
            tri = mesh.tris.astype(np.int64)
            p0, p1, p2 = verts_w[tri[:, 0]], verts_w[tri[:, 1]], verts_w[tri[:, 2]]
            em_p0.append(p0)
            em_p1.append(p1)
            em_p2.append(p2)
            if mesh.has_normals:
                nm = np.linalg.inv(np.asarray(m, np.float64))[:3, :3].T.astype(F)
                norms = mesh.normals @ nm.T
                em_n0.append(norms[tri[:, 0]])
                em_n1.append(norms[tri[:, 1]])
                em_n2.append(norms[tri[:, 2]])
                em_has_n.append(np.ones(len(tri), bool))
            else:
                z = np.zeros((len(tri), 3), F)
                em_n0.append(z)
                em_n1.append(z)
                em_n2.append(z)
                em_has_n.append(np.zeros(len(tri), bool))
            em_area.append(
                0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
            )
            light_emit_first[i] = em_offset
            light_emit_count[i] = len(tri)
            em_offset += len(tri)
        else:
            raise TypeError(f"unknown light: {light}")
        light_kinds.append(int(light_kind[i]))

    em_p0 = cat(em_p0, (3,))
    em_p1 = cat(em_p1, (3,))
    em_p2 = cat(em_p2, (3,))
    em_n0 = cat(em_n0, (3,))
    em_n1 = cat(em_n1, (3,))
    em_n2 = cat(em_n2, (3,))
    em_area = cat(em_area, ())
    em_has_n = cat(em_has_n, (), bool)
    if em_p0.shape[0] == 0:
        em_p0 = em_p1 = em_p2 = np.zeros((1, 3), F)
        em_n0 = em_n1 = em_n2 = np.zeros((1, 3), F)
        em_area = np.ones(1, F)
        em_has_n = np.zeros(1, bool)

    # single-gather shading rows: main world-space rows, then each BLAS's
    # object-space rows (indexed via the per-instance shade offset)
    tri_shade = _tri_shade_rows(acc)
    if blas_shade_rows:
        tri_shade = np.concatenate([tri_shade, *blas_shade_rows], axis=0)

    em_shade = np.zeros((em_p0.shape[0], 24), F)
    em_shade[:, 0:3] = em_p0
    em_shade[:, 3:6] = em_p1
    em_shade[:, 6:9] = em_p2
    em_shade[:, 9:12] = em_n0
    em_shade[:, 12:15] = em_n1
    em_shade[:, 15:18] = em_n2
    em_shade[:, 18] = em_area
    em_shade[:, 19] = em_has_n.astype(np.int32).view(F)

    # ---------------- camera
    cam = scene.camera
    ct = cam.camera_type
    if isinstance(ct, Orthographic):
        cam_kind, aperture, focal = CAM_ORTHOGRAPHIC, 0.0, 0.0
    elif isinstance(ct, PinholePerspective):
        cam_kind, aperture, focal = CAM_PINHOLE, 0.0, 0.0
    else:
        assert isinstance(ct, ThinLensPerspective)
        cam_kind = CAM_THIN_LENS
        aperture, focal = ct.aperture_radius, ct.focal_distance
    cam_min_diff = _minimum_differentials(cam)

    env_tex = -1
    has_env = scene.environment_light is not None
    if has_env:
        env_tex = int(scene.environment_light.radiance)

    meta = SceneMeta(
        n_tris=n_tris,
        n_spheres=n_spheres,
        n_lights=n_lights,
        n_materials=len(scene.materials),
        n_textures=len(scene.textures),
        light_kinds=tuple(light_kinds),
        mat_kinds_present=tuple(sorted(kinds_present)),
        tex_kinds_present=tuple(sorted({int(k) for k in tex_kind})),
        any_trilinear=bool(trilinear_images),
        any_nearest=any_nearest,
        has_env=has_env,
        env_tex=env_tex,
        slot_kinds=tuple(slot_kind_sets),
        env_kinds=() if slot_kind_sets[0] is None      # knob escape hatch
        else tuple(sorted(_reach_kinds(env_tex)))
        if has_env else (int(TEX_CONSTANT),),
        cam_kind=cam_kind,
        width=cam.raster_width,
        height=cam.raster_height,
        near_clip=float(cam.near_clip),
        far_clip=float(cam.far_clip),
        aperture_radius=float(aperture),
        focal_distance=float(focal),
        root_meta=int(root_meta),
        bvh2_depth=int(bvh2_depth),
        blas_meta=tuple(blas_meta),
        instances=tuple(instances),
        inst_vtri_base0=int(inst_vtri_base0),
    )

    n_inst = len(instances)
    inst_xf = np.zeros((max(1, n_inst), 32), F)
    inst_aabb_min = np.zeros((max(1, n_inst), 3), F)
    inst_aabb_max = np.zeros((max(1, n_inst), 3), F)
    for i, (o2w, w2o) in enumerate(inst_mats):
        inst_xf[i, :16] = o2w.reshape(-1)
        inst_xf[i, 16:] = w2o.reshape(-1)
        inst_aabb_min[i], inst_aabb_max[i] = inst_aabbs[i]
    blas_tables = tuple(
        BlasTables(
            bvh2_rows=jnp.asarray(b.bvh2_rows),
            tri_pack=jnp.asarray(b.tri_pack),
        )
        for b in blas_accels
    )

    dev = lambda a: jnp.asarray(a)  # noqa: E731
    return DeviceScene(
        tri_p0=dev(tri_p0), tri_p1=dev(tri_p1), tri_p2=dev(tri_p2),
        tri_n0=dev(tri_n0), tri_n1=dev(tri_n1), tri_n2=dev(tri_n2),
        tri_uv0=dev(tri_uv0), tri_uv1=dev(tri_uv1), tri_uv2=dev(tri_uv2),
        tri_mat=dev(tri_mat), tri_light=dev(tri_light),
        tri_has_n=dev(tri_has_n), tri_has_uv=dev(tri_has_uv),
        tri_pack=dev(tri_pack),
        bvh2_rows=dev(bvh2_rows),
        sph_center=dev(sph_center), sph_radius=dev(sph_radius),
        sph_o2w=dev(sph_o2w), sph_w2o=dev(sph_w2o),
        sph_mat=dev(sph_mat), sph_light=dev(sph_light),
        mat_kind=dev(mat_kind), mat_tex=dev(mat_tex), mat_remap=dev(mat_remap),
        mat_pack=dev(mat_pack), tex_pack=dev(tex_pack), lvl_pack=dev(lvl_pack),
        mat_tex_rows=dev(mat_tex_rows),
        tex_kind=dev(tex_kind), tex_v0=dev(tex_v0), tex_v1=dev(tex_v1),
        tex_ref=dev(tex_ref), tex_filter=dev(tex_filter), tex_wrap=dev(tex_wrap),
        img_texels=dev(img_texels),
        img_quads=dev(img_quads) if img_quads is not None else None,
        img_level_offset=dev(img_level_offset),
        img_level_w=dev(img_level_w), img_level_h=dev(img_level_h),
        img_first_level=dev(img_first_level), img_n_levels=dev(img_n_levels),
        light_kind=dev(light_kind), light_va=dev(light_va), light_vb=dev(light_vb),
        light_emit_first=dev(light_emit_first),
        light_emit_count=dev(light_emit_count),
        em_p0=dev(em_p0), em_p1=dev(em_p1), em_p2=dev(em_p2),
        em_n0=dev(em_n0), em_n1=dev(em_n1), em_n2=dev(em_n2),
        em_area=dev(em_area), em_has_n=dev(em_has_n),
        tri_shade=dev(tri_shade), em_shade=dev(em_shade),
        cam_raster_to_camera=dev(cam.raster_to_camera.forward),
        cam_camera_to_world=dev(cam.camera_to_world.forward),
        cam_min_diff=dev(cam_min_diff),
        bounds_center=dev(bounds_center),
        bounds_radius=dev(bounds_radius),
        blas_tables=blas_tables,
        inst_xf=dev(inst_xf),
        inst_aabb_min=dev(inst_aabb_min),
        inst_aabb_max=dev(inst_aabb_max),
        meta=meta,
    )


def _minimum_differentials(cam) -> np.ndarray:
    """Minimum per-pixel ray differentials (lib.rs:111-143 semantics).

    Rows: x_origin, y_origin, x_direction, y_direction.
    """
    w2r_inv = cam.world_to_raster.inverse

    def inv_point(p):
        from ..geometry.matrix import apply_point

        return apply_point(w2r_inv, p)

    out = np.zeros((4, 3), F)
    if isinstance(cam.camera_type, Orthographic):
        origin = inv_point([0.0, 0.0, 0.0])
        dx = inv_point([1.0, 0.0, 0.0])
        dy = inv_point([0.0, 1.0, 0.0])
        out[0] = dx - origin
        out[1] = dy - origin
    else:
        cx, cy = cam.raster_width / 2.0, cam.raster_height / 2.0
        center = inv_point([cx, cy, 0.0])
        dx = inv_point([cx + 1.0, cy, 0.0])
        dy = inv_point([cx, cy + 1.0, 0.0])
        out[2] = dx - center
        out[3] = dy - center
    return out
