"""Scene container + compilation to flat device arrays.

The reference's Scene (Scene.h:10-30, Scene.cpp:25-74) uploads
pointer-linked structs to the GPU. Here that is a pure "compile" step: ``Scene.compile()`` flattens every mesh, BVH, instance,
material and texture into one SoA pytree of jnp arrays (``SceneArrays``)
that jits cleanly, shards trivially, and serializes to disk — fixing the
reference's gap of rebuilding BVHs from OBJ on every launch
(MeshPrimitive.cpp:14; SURVEY.md §5 checkpoint/resume).

Index plumbing at compile time:
  * triangles of all meshes are concatenated (each mesh's triangles are
    already in BVH-leaf order), and each mesh's BVH leaf_start values
    are offset into the global triangle array;
  * all BVH node arrays are concatenated with child indices offset, and
    ``mesh_root[m]`` points at mesh m's root node;
  * textures are packed into a flat [P, 3] uint8 atlas with per-material
    (start, width, height) so a texel is ``atlas[start + y*w + x]`` —
    the dense analog of the reference's pitched uchar3 buffers
    (Material.hpp:29-43).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .instance import MeshInstance
from .material import Material
from .mesh import MeshPrimitive


def _mip_downsample(level: np.ndarray) -> np.ndarray:
    """One mip level down: 2x2 box filter with edge-clamp padding for
    odd dims; next dims = (max(h//2, 1), max(w//2, 1)) — repeated floor
    halving, so level l dims are (max(h >> l, 1), max(w >> l, 1))."""
    h, w, _ = level.shape
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    # crop to the 2*nh x 2*nw region (floor semantics), then pad if a
    # dim was already 1
    src = level[: 2 * nh if h > 1 else 1, : 2 * nw if w > 1 else 1]
    if h == 1:
        src = np.repeat(src, 2, axis=0)
    if w == 1:
        src = np.repeat(src, 2, axis=1)
    f = src.astype(np.float32).reshape(nh, 2, nw, 2, 3).mean(axis=(1, 3))
    return np.round(f).astype(np.uint8)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Flat SoA scene — everything the render kernels need, as arrays."""

    # Triangles (global, BVH-leaf-contiguous per mesh)
    tri_v0: jax.Array  # [T, 3] f32
    tri_v1: jax.Array
    tri_v2: jax.Array
    tri_normal: jax.Array  # [T, 3] f32
    tri_uv0: jax.Array  # [T, 2] f32
    tri_uv1: jax.Array
    tri_uv2: jax.Array
    tri_mesh: jax.Array  # [T] i32 owning-mesh id (for brute-force masking)
    tri_mat: jax.Array  # [T] i32 per-triangle material, -1 = use the
    # instance's material (only >=0 for flattened static scenes)
    # BVH nodes (global across meshes)
    node_min: jax.Array  # [N, 3] f32
    node_max: jax.Array  # [N, 3] f32
    node_child_a: jax.Array  # [N] i32 (global node index, -1 = leaf)
    node_child_b: jax.Array  # [N] i32
    node_leaf_start: jax.Array  # [N] i32 (global triangle index)
    node_leaf_count: jax.Array  # [N] i32
    mesh_root: jax.Array  # [M] i32 root node per mesh
    # Instances (inverses precomputed, MeshInstance.hpp:39-46)
    inst_mesh: jax.Array  # [I] i32
    inst_material: jax.Array  # [I] i32
    inst_pose: jax.Array  # [I, 6] f32 lre
    inst_inv_pose: jax.Array  # [I, 6] f32
    inst_scale: jax.Array  # [I, 3] f32
    inst_inv_scale: jax.Array  # [I, 3] f32
    # Materials
    mat_albedo: jax.Array  # [K, 3] f32
    mat_roughness: jax.Array  # [K] f32
    mat_metallic: jax.Array  # [K] f32
    mat_illumination: jax.Array  # [K] f32
    mat_reflectivity: jax.Array  # [K] f32
    mat_tex_start: jax.Array  # [K] i32, -1 = untextured
    mat_tex_w: jax.Array  # [K] i32
    mat_tex_h: jax.Array  # [K] i32
    # Texture atlas
    tex_atlas: jax.Array  # [P] i32, one packed r|g<<8|b<<16 texel each
    # Mip chains (framework extension; the reference samples level 0
    # nearest-neighbor only, raycast.cu:224-240): level l of material k
    # starts at mat_tex_mip_start[k, l] with dims
    # (max(h >> l, 1), max(w >> l, 1)); levels past a material's chain
    # repeat its last (1x1) start so any lod clamp stays valid. -1 rows
    # for untextured materials. Used by texture_filter="trilinear".
    mat_tex_mip_start: jax.Array  # [K, L] i32
    # Environment-map sky (framework extension; the reference's miss
    # color is the flat constant raycast.cu:211-213): an equirect
    # texture in the same atlas, sampled by miss-ray direction.
    # start = -1 -> no sky map, use the flat constant.
    sky_tex_start: jax.Array  # [] i32
    sky_tex_w: jax.Array  # [] i32
    sky_tex_h: jax.Array  # [] i32
    # STATIC mirror of `sky_tex_start >= 0`. The env-map sample costs 4
    # atlas gathers + arctan2/arcsin PER RAY; with only the traced
    # scalar to test, XLA cannot dead-code it for skyless scenes (the
    # jnp.where keeps both sides live), so every shade paid it. A
    # trace-time bool lets shade skip the whole path (measured: the
    # r3 whitted/primary shading regression).
    has_sky: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    # STATIC mirror of `(mat_tex_start >= 0).any()` — same rationale:
    # untextured scenes skip the per-ray atlas sampling at trace time
    # instead of paying gathers the jnp.where throws away.
    has_textures: bool = dataclasses.field(
        default=True, metadata=dict(static=True)
    )
    # STATIC mirror of `(mat_illumination > 0).any()` — lets the path
    # tracer's FINAL bounce skip the nearest-hit cast entirely: with no
    # emissive materials the last cast's only observable output is
    # hit-vs-miss (miss -> sky, hit -> nothing), which the cheap
    # ANY-HIT occlusion kernel answers with first-hit early-out
    # (renderer.occlusion_cast_fn). Default True = conservative.
    has_emissive: bool = dataclasses.field(
        default=True, metadata=dict(static=True)
    )
    # Per-corner vertex normals for smooth shading normals, packed
    # [T, 10]: vn0 | vn1 | vn2 | smooth-flag (the reference's disabled
    # vn-interpolation scaffolding, OBJLoader.hpp:119-135, realized).
    # None when no mesh carries vn records — presence is the STATIC
    # gate (hit_attributes skips the whole interpolation chain at
    # trace time, like has_sky/has_textures).
    tri_vnorm: jax.Array | None = None

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_instances(self) -> int:
        return self.inst_mesh.shape[0]

    def update_instance(self, index: int, instance: MeshInstance) -> "SceneArrays":
        """Functional single-instance pose update — the cheap animation
        path (Scene::update_mesh_instance, Scene.cpp:67-74)."""
        inv = instance.build_inv()
        return dataclasses.replace(
            self,
            inst_pose=self.inst_pose.at[index].set(jnp.asarray(inv["pose"])),
            inst_inv_pose=self.inst_inv_pose.at[index].set(jnp.asarray(inv["inv_pose"])),
            inst_scale=self.inst_scale.at[index].set(jnp.asarray(inv["scale"])),
            inst_inv_scale=self.inst_inv_scale.at[index].set(jnp.asarray(inv["inv_scale"])),
            inst_mesh=self.inst_mesh.at[index].set(instance.mesh_index),
            inst_material=self.inst_material.at[index].set(instance.material_index),
        )

    # -- serialization (the BVH/scene cache the reference lacks) --------
    def save(self, fp: str) -> None:
        arrays = {
            f.name: np.asarray(getattr(self, f.name))
            for f in dataclasses.fields(self)
            # static flags; rebuilt from the arrays after load
            if f.name not in ("has_sky", "has_textures", "has_emissive")
            and getattr(self, f.name) is not None  # optional tri_vnorm
        }
        np.savez_compressed(fp, **arrays)

    @classmethod
    def load(cls, fp: str) -> "SceneArrays":
        with np.load(fp) as data:
            kw = {k: jnp.asarray(data[k]) for k in data.files}
        if "mat_tex_mip_start" not in kw:  # pre-mip save files
            kw["mat_tex_mip_start"] = kw["mat_tex_start"][:, None]
        if "sky_tex_start" not in kw:  # pre-sky save files
            kw["sky_tex_start"] = jnp.int32(-1)
            kw["sky_tex_w"] = jnp.int32(0)
            kw["sky_tex_h"] = jnp.int32(0)
        kw["has_sky"] = bool(np.asarray(kw["sky_tex_start"]) >= 0)
        kw["has_textures"] = bool(
            (np.asarray(kw["mat_tex_start"]) >= 0).any()
        )
        kw["has_emissive"] = bool(
            (np.asarray(kw["mat_illumination"]) > 0).any()
        )
        return cls(**kw)


class Scene:
    """Host-side scene builder (Scene.h:10-30)."""

    def __init__(self):
        self.materials: list[Material] = []
        self.meshes: list[MeshPrimitive] = []
        self.mesh_instances: list[MeshInstance] = []
        self.sky_texture: np.ndarray | None = None

    def set_sky(self, texture: np.ndarray) -> None:
        """Attach an equirectangular environment map sampled by miss-ray
        direction (framework extension; the reference's sky is the flat
        constant raycast.cu:211-213). [H, W, 3] uint8, same channel
        order as material textures."""
        texture = np.asarray(texture, np.uint8)
        if texture.ndim != 3 or texture.shape[2] != 3:
            raise ValueError(
                f"sky must be [H, W, 3] uint8, got {texture.shape}"
            )
        self.sky_texture = texture

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_mesh(self, mesh: MeshPrimitive) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_mesh_instance(self, instance: MeshInstance) -> int:
        self.mesh_instances.append(instance)
        return len(self.mesh_instances) - 1

    def update_mesh_instance(self, index: int, instance: MeshInstance) -> None:
        self.mesh_instances[index] = instance

    def flattened(self) -> tuple["Scene", np.ndarray]:
        """Bake every instance's triangles to WORLD space and merge them
        into one mesh + one identity instance, returning the new Scene
        and the per-triangle material ids (aligned with the merged
        mesh's BVH-reordered triangles).

        Static-scene optimization: traversal walks every instance in
        turn, so N instances cost N walks per ray even when each mesh is
        small. Flattening
        trades the reference's cheap per-instance pose updates
        (Scene.cpp:67-74) for one merged BVH — use for scenes whose
        instances don't move. Transforms match hit_attributes exactly
        (world = apply_lre(inv_pose, v * scale); normals via the
        reference's scale-multiply convention, renormalized)."""
        from ..core import transforms as T

        wv0, wv1, wv2, wn, wu0, wu1, wu2, wmat = ([] for _ in range(8))
        wvn = [[] for _ in range(3)]
        wvnm = []
        any_vn = any(
            self.meshes[i.mesh_index].vn0 is not None
            for i in self.mesh_instances
        )
        for inst in self.mesh_instances:
            mesh = self.meshes[inst.mesh_index]
            d = inst.build_inv()
            inv_pose = jnp.asarray(d["inv_pose"], jnp.float32)
            scale = jnp.asarray(d["scale"], jnp.float32)
            to_world = lambda v: np.asarray(
                T.apply_lre(inv_pose, jnp.asarray(v) * scale), np.float32
            )
            wv0.append(to_world(mesh.v0))
            wv1.append(to_world(mesh.v1))
            wv2.append(to_world(mesh.v2))
            from ..core.vecmath import normalize

            to_world_n = lambda n_: np.asarray(normalize(
                T.apply_euler(inv_pose[3:6], jnp.asarray(n_)) * scale
            ), np.float32)
            wn.append(to_world_n(mesh.normal))
            if any_vn:
                # bake per-corner vertex normals to world space with the
                # same convention as face normals (renormalized corners)
                for j, vn_ in enumerate((mesh.vn0, mesh.vn1, mesh.vn2)):
                    wvn[j].append(
                        to_world_n(vn_) if vn_ is not None
                        else np.zeros((mesh.num_triangles, 3), np.float32)
                    )
                wvnm.append(
                    mesh.vn_mask if mesh.vn_mask is not None
                    else np.zeros(mesh.num_triangles, bool)
                )
            wu0.append(mesh.uv0)
            wu1.append(mesh.uv1)
            wu2.append(mesh.uv2)
            wmat.append(
                np.full(mesh.num_triangles, inst.material_index, np.int32)
            )

        cat = np.concatenate
        merged = MeshPrimitive.from_triangles(
            cat(wv0), cat(wv1), cat(wv2), cat(wn),
            cat(wu0), cat(wu1), cat(wu2),
            vn0=cat(wvn[0]) if any_vn else None,
            vn1=cat(wvn[1]) if any_vn else None,
            vn2=cat(wvn[2]) if any_vn else None,
            vn_mask=cat(wvnm) if any_vn else None,
        )
        tri_mat = cat(wmat)[merged.bvh.order]

        flat = Scene()
        flat.materials = self.materials
        flat.add_mesh(merged)
        flat.add_mesh_instance(MeshInstance(0, 0))
        return flat, tri_mat

    def compile(self, box_pad_ulp: float = 2.0 ** -21,
                flatten_static: bool = False,
                _tri_mat: np.ndarray | None = None) -> SceneArrays:
        """Flatten to SceneArrays (the upload_to_device analog,
        Scene.cpp:25-65).

        ``box_pad_ulp``: relative out-rounding of BVH node boxes
        (pad = max(|min|,|max|) * box_pad_ulp per axis). The f32
        barycentric triangle test (same math as the reference)
        accepts grazing hits up to ~1 coordinate-ulp outside the exact
        triangle, so tight boxes would cull rays the triangle test
        accepts — visible as a stripe of false misses for rays nearly
        parallel to large axis-aligned faces. ~6 ulps (2^-21) keeps the
        BVH backends bit-consistent with the brute-force oracle.
        Set 0.0 to disable (tight boxes). Exactly-on-plane rays with
        zero direction components are handled separately by the
        in-kernel 1e-12 numerator nudge (render/intersect.py)."""
        if not self.meshes or not self.mesh_instances or not self.materials:
            raise ValueError("scene needs at least one mesh, instance and material")
        if flatten_static:
            flat, tri_mat_src = self.flattened()
            return flat.compile(box_pad_ulp=box_pad_ulp, _tri_mat=tri_mat_src)

        # --- triangles + BVH nodes, concatenated with offsets ---
        tri_parts = {k: [] for k in ("v0", "v1", "v2", "normal", "uv0", "uv1", "uv2")}
        node_parts = {k: [] for k in ("min", "max", "ca", "cb", "ls", "lc")}
        tri_mesh = []
        tri_mat_parts = []
        vnorm_parts = []
        mesh_root = []
        tri_off = 0
        node_off = 0
        for mesh_id, mesh in enumerate(self.meshes):
            b = mesh.bvh
            internal = b.child_a >= 0
            n_tri = mesh.num_triangles

            tri_mesh.append(np.full(n_tri, mesh_id, np.int32))
            if mesh.vn0 is not None:
                vnorm_parts.append(np.concatenate(
                    [mesh.vn0, mesh.vn1, mesh.vn2,
                     mesh.vn_mask[:, None].astype(np.float32)], axis=1
                ))
            else:
                vnorm_parts.append(np.zeros((n_tri, 10), np.float32))
            # per-triangle materials (flattened scenes only); -1 =
            # resolve via the instance
            tri_mat_parts.append(
                _tri_mat.astype(np.int32)
                if (_tri_mat is not None and mesh_id == 0)
                else np.full(n_tri, -1, np.int32)
            )
            for k, arr in (
                ("v0", mesh.v0), ("v1", mesh.v1), ("v2", mesh.v2),
                ("normal", mesh.normal),
                ("uv0", mesh.uv0), ("uv1", mesh.uv1), ("uv2", mesh.uv2),
            ):
                tri_parts[k].append(arr)
            ls = np.where(internal, 0, b.leaf_start.astype(np.int64))

            node_parts["min"].append(b.node_min)
            node_parts["max"].append(b.node_max)
            node_parts["ca"].append(np.where(internal, b.child_a + node_off, -1).astype(np.int32))
            node_parts["cb"].append(np.where(internal, b.child_b + node_off, -1).astype(np.int32))
            node_parts["ls"].append((ls + tri_off).astype(np.int32))
            node_parts["lc"].append(b.leaf_count)
            mesh_root.append(node_off)
            tri_off += n_tri
            node_off += b.num_nodes

        # --- instances ---
        inv = [inst.build_inv() for inst in self.mesh_instances]

        # --- materials + texture atlas (with mip chains) ---
        atlas_parts = []
        tex_start, tex_w, tex_h = [], [], []
        mip_chains = []  # per-material list of level starts
        p = 0
        for m in self.materials:
            if m.texture is not None:
                h, w, _ = m.texture.shape
                chain = []
                level = m.texture
                while True:
                    chain.append(p)
                    atlas_parts.append(level.reshape(-1, 3))
                    p += level.shape[0] * level.shape[1]
                    if level.shape[0] <= 1 and level.shape[1] <= 1:
                        break
                    level = _mip_downsample(level)
                tex_start.append(chain[0])
                tex_w.append(w)
                tex_h.append(h)
                mip_chains.append(chain)
            else:
                tex_start.append(-1)
                tex_w.append(0)
                tex_h.append(0)
                mip_chains.append([-1])
        # environment sky map: one (unmipped) level at the atlas tail
        if self.sky_texture is not None:
            sh, sw, _ = self.sky_texture.shape
            sky_start, sky_w, sky_h = p, sw, sh
            atlas_parts.append(self.sky_texture.reshape(-1, 3))
            p += sh * sw
        else:
            sky_start, sky_w, sky_h = -1, 0, 0
        max_mips = max(len(c) for c in mip_chains) if mip_chains else 1
        mip_start = np.full((len(self.materials), max_mips), -1, np.int32)
        for k, chain in enumerate(mip_chains):
            if chain[0] >= 0:
                # repeat the last (1x1) level so any lod clamp is valid
                padded = chain + [chain[-1]] * (max_mips - len(chain))
                mip_start[k] = padded
        atlas_u8 = (
            np.concatenate(atlas_parts, axis=0)
            if atlas_parts
            else np.zeros((1, 3), np.uint8)
        )
        # pack r|g<<8|b<<16 into one i32 per texel: one word per texel
        # fetch instead of a [P, 3] u8 row gather
        a32 = atlas_u8.astype(np.int32)
        atlas = a32[:, 0] | (a32[:, 1] << 8) | (a32[:, 2] << 16)

        f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
        i32 = lambda x: jnp.asarray(np.asarray(x, np.int32))
        cat = np.concatenate

        if box_pad_ulp:
            mn = cat(node_parts["min"])
            mx = cat(node_parts["max"])
            pad = np.maximum(np.abs(mn), np.abs(mx)) * np.float32(box_pad_ulp)
            node_parts["min"] = [mn - pad]
            node_parts["max"] = [mx + pad]

        arrays = SceneArrays(
            tri_v0=f32(cat(tri_parts["v0"])),
            tri_v1=f32(cat(tri_parts["v1"])),
            tri_v2=f32(cat(tri_parts["v2"])),
            tri_normal=f32(cat(tri_parts["normal"])),
            tri_uv0=f32(cat(tri_parts["uv0"])),
            tri_uv1=f32(cat(tri_parts["uv1"])),
            tri_uv2=f32(cat(tri_parts["uv2"])),
            tri_mesh=i32(cat(tri_mesh)),
            tri_mat=i32(cat(tri_mat_parts)),
            node_min=f32(cat(node_parts["min"])),
            node_max=f32(cat(node_parts["max"])),
            node_child_a=i32(cat(node_parts["ca"])),
            node_child_b=i32(cat(node_parts["cb"])),
            node_leaf_start=i32(cat(node_parts["ls"])),
            node_leaf_count=i32(cat(node_parts["lc"])),
            mesh_root=i32(mesh_root),
            inst_mesh=i32([inst.mesh_index for inst in self.mesh_instances]),
            inst_material=i32([inst.material_index for inst in self.mesh_instances]),
            inst_pose=f32([d["pose"] for d in inv]),
            inst_inv_pose=f32([d["inv_pose"] for d in inv]),
            inst_scale=f32([d["scale"] for d in inv]),
            inst_inv_scale=f32([d["inv_scale"] for d in inv]),
            mat_albedo=f32([m.albedo for m in self.materials]),
            mat_roughness=f32([m.roughness for m in self.materials]),
            mat_metallic=f32([m.metallic for m in self.materials]),
            mat_illumination=f32([m.illumination for m in self.materials]),
            mat_reflectivity=f32([m.reflectivity for m in self.materials]),
            mat_tex_start=i32(tex_start),
            mat_tex_w=i32(tex_w),
            mat_tex_h=i32(tex_h),
            tex_atlas=jnp.asarray(atlas, jnp.int32),
            mat_tex_mip_start=i32(mip_start),
            sky_tex_start=i32(sky_start),
            sky_tex_w=i32(sky_w),
            sky_tex_h=i32(sky_h),
            has_sky=self.sky_texture is not None,
            has_textures=any(s >= 0 for s in tex_start),
            has_emissive=any(m.illumination > 0 for m in self.materials),
            tri_vnorm=(
                f32(cat(vnorm_parts))
                if any(m.vn0 is not None for m in self.meshes) else None
            ),
        )
        return arrays
