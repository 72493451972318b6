"""Same-device oracle: a backend's hits against the brute-force cast.

``cast_rays_brute`` tests every ray against every triangle with the
arithmetic of render/intersect.py; every other backend must agree with
it on the device it runs on. The CPU suite (tests/test_oracle.py), the
GPU suite (tests/test_gpu_oracle.py) and ``chip_smoke.py`` all run the
checks below, on the scenes below, at these tolerances:

* hit/miss agrees on at least ``HITMISS_MIN`` of the rays;
* ``t`` agrees to a relative ``T_RTOL`` where both hit, the relative
  error weighted by |cos| of the angle between ray and surface: the
  plane test divides by that cosine, so a grazing hit's t carries the
  rounding of its inputs amplified by 1/|cos| (XLA's own brute cast,
  compiled in two contexts on the CPU, differs by 1.2e-5 relative on
  a ray at cos = 0.008 and by 1e-7 after weighting);
* ``tri``/``inst`` agree on at least ``IDS_MIN`` of the joint hits,
  counting a t-tie as agreement: where two surfaces meet at one point
  (a shared edge, a coplanar pair) the brute cast keeps the lowest
  triangle index and a walk keeps the first it visits, so the ids
  differ at equal t by design (``ids_raw`` reports the plain share);
* rendered images differ in at most ``PIXELS_MAX`` of their pixels.

They are tolerances and not equality because XLA and nvcc contract
multiplies and adds into FMAs differently, so the last bits of ``t`` can
differ and an exact edge or t-tie can resolve the other way. The host
build of the kernel (-ffp-contract=off) matches XLA's CPU code exactly
on these scenes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .render.camera import Camera, generate_rays, reference_calibration
from .render.renderer import (
    Hit, cast_rays_brute, get_cast_fn, hit_attributes, occlusion_cast_fn,
)
from .scene import (
    Material, MeshInstance, MeshPrimitive, Scene, objloader, procgen,
)

HITMISS_MIN = 0.9999
T_RTOL = 1e-5
IDS_MIN = 0.999
PIXELS_MAX = 0.0005
# carried u/v/n against hit_attributes' redo (absolute; barycentrics
# and unit normals are O(1))
ATTR_ATOL = 1e-4
MISS_T = 3e38


def cube_scene(textured: bool = False, size: int = 64):
    """One cube, camera 4 units back (y-forward)."""
    scene = Scene()
    if textured:
        mat = Material()
        mat.set_texture(procgen.checkerboard_texture(64, 8))
        scene.add_material(mat)
    else:
        scene.add_material(Material(albedo=(0.1, 0.2, 0.9)))
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    scene.add_mesh_instance(MeshInstance(0, 0))
    cam = Camera.looking(size, size, fov_deg=45.0, pose=[0, -4, 0, 0, 0, 0])
    return scene.compile(), cam


def sphere_scene(subdiv: int = 3, size: int = 32):
    """A rotated, nonuniformly scaled icosphere with a multi-level BVH."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    v0, v1, v2 = procgen.icosphere(subdiv)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    inst = MeshInstance(0, 0)
    inst.pose = np.array([0, 0, 0, 0.3, 0.2, 0.1], np.float32)
    inst.scale = np.array([1.0, 1.3, 0.8], np.float32)
    scene.add_mesh_instance(inst)
    cam = Camera.looking(size, size, fov_deg=40.0,
                         pose=[0.2, -3.5, 0.1, 0, 0, 0])
    return scene.compile(), cam


def two_instance_scene(size: int = 64):
    """Posed + non-uniformly scaled instances of two meshes: exercises
    the per-instance quaternion transform, the t_best carry across
    instances, and the inst-index output."""
    scene = Scene()
    scene.add_material(Material(albedo=(0.8, 0.3, 0.2)))
    mat = Material()
    mat.set_texture(procgen.checkerboard_texture(32, 4))
    scene.add_material(mat)
    scene.add_mesh(objloader.loads(procgen.cube_obj()))
    v0, v1, v2 = procgen.icosphere(2)
    scene.add_mesh(MeshPrimitive.from_triangles(v0, v1, v2))
    a = MeshInstance(0, 1)
    a.pose = np.array([-0.9, 0.0, 0.0, 0.4, 0.1, 0.0], np.float32)
    b = MeshInstance(1, 0)
    b.pose = np.array([1.1, 0.5, 0.2, 0.0, 0.3, 0.2], np.float32)
    b.scale = np.array([0.9, 1.2, 0.7], np.float32)
    scene.add_mesh_instance(a)
    scene.add_mesh_instance(b)
    cam = Camera.looking(size, size, fov_deg=55.0, pose=[0, -4.5, 0, 0, 0, 0])
    return scene.compile(), cam


def demo_fisheye_scene(width: int = 96, height: int = 54):
    """The demo scene (textured cube + board) through the reference's
    real fisheye calibration (D != 0), K rescaled to the size."""
    from .app.driver import build_demo_scene

    K, D = reference_calibration(width, height)
    cam = Camera(width, height, K, D)
    cam.pose = np.array([-1.0, -4.0, 2.0, 0, 0, 0], np.float32)
    return build_demo_scene().compile(), cam


def oracle_scene(name: str, size: int = 32):
    """(scene arrays, camera) of one oracle scene; ``size`` scales the
    image of the scenes that take one."""
    from .app import scenes

    if name == "cube":
        return cube_scene(textured=True, size=size)
    if name == "sphere":
        return sphere_scene(3, size=size)
    if name == "two_instance":
        return two_instance_scene(size)
    if name == "instances":  # posed instances, one nonuniformly scaled
        return scenes.scene_instances(size, size)
    if name == "cornell":
        return scenes.scene_cornell(size)
    if name == "demo_fisheye":
        return demo_fisheye_scene(size * 3, size * 3 * 9 // 16)
    raise ValueError(f"unknown oracle scene {name!r}")


ORACLE_SCENES = ("cube", "sphere", "two_instance", "instances", "cornell",
                 "demo_fisheye")


def camera_rays(cam: Camera):
    """(origin [3], directions [H, W, 3]) of a camera's primary rays."""
    p = cam.ray_params()
    return generate_rays(cam.width, cam.height, p["K_inv"], p["D"],
                         p["pose"], p["inv_pose"])


def brute_hits(scene, origin, directions, chunk: int = 4096) -> Hit:
    """cast_rays_brute over the flattened rays, ``chunk`` rays at a time
    (its [rays, triangles] test matrix must fit in device memory)."""
    directions = np.asarray(directions, np.float32)
    origin = np.broadcast_to(np.asarray(origin, np.float32),
                             directions.shape)
    shape = directions.shape[:-1]
    o = origin.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    cast = jax.jit(cast_rays_brute)
    parts = []
    for s in range(0, len(d), chunk):
        oc, dc = o[s:s + chunk], d[s:s + chunk]
        pad = chunk - len(dc) if len(d) > chunk else 0
        if pad:  # keep one compiled shape
            oc = np.concatenate([oc, np.repeat(oc[-1:], pad, 0)])
            dc = np.concatenate([dc, np.repeat(dc[-1:], pad, 0)])
        h = cast(scene, jnp.asarray(oc), jnp.asarray(dc))
        parts.append([np.asarray(x)[:len(o[s:s + chunk])] for x in h[:3]])
    t, tri, inst = (np.concatenate(c).reshape(shape) for c in zip(*parts))
    return Hit(t=t, tri=tri, inst=inst)


def incidence_cos(scene, origin, directions, hit: Hit) -> np.ndarray:
    """|cos| of the angle between each ray and the surface it hit (the
    world normal under the correct inverse-transpose transform)."""
    attrs = jax.jit(hit_attributes, static_argnames="normal_mode")(
        scene, origin, directions, Hit(t=hit.t, tri=hit.tri, inst=hit.inst),
        normal_mode="inverse_transpose")
    d = np.asarray(directions, np.float32)
    return np.abs((np.asarray(attrs.normal) * d).sum(-1)) / np.maximum(
        np.linalg.norm(d, axis=-1), 1e-30)


def hit_agreement(got: Hit, want: Hit, any_hit: bool = False,
                  cos=None) -> dict:
    """Agreement statistics of two hit records, and whether they meet
    the tolerances. An any-hit cast is held to hit/miss only. ``cos``
    (incidence_cos of ``want``) weights the relative t error; without
    it the raw relative error is held to T_RTOL."""
    tg, tw = np.asarray(got.t), np.asarray(want.t)
    hg, hw = tg < MISS_T, tw < MISS_T
    out = {"rays": int(tg.size), "hits": int(hw.sum()),
           "hitmiss": float((hg == hw).mean()) if tg.size else 1.0}
    ok = out["hitmiss"] >= HITMISS_MIN
    if not any_hit:
        j = hg & hw
        rel = np.abs(tg[j] - tw[j]) / np.maximum(np.abs(tw[j]), 1e-30)
        weighted = rel if cos is None else rel * np.asarray(cos)[j]
        same = ((np.asarray(got.tri) == np.asarray(want.tri))
                & (np.asarray(got.inst) == np.asarray(want.inst)))[j]
        out["t_rel_max"] = float(rel.max()) if rel.size else 0.0
        out["t_err_max"] = float(weighted.max()) if rel.size else 0.0
        out["ids_raw"] = float(same.mean()) if same.size else 1.0
        tie = weighted <= T_RTOL
        out["ids"] = float((same | tie).mean()) if same.size else 1.0
        ok = ok and out["t_err_max"] <= T_RTOL and out["ids"] >= IDS_MIN
    out["ok"] = bool(ok)
    return out


def attr_agreement(scene, origin, directions, hit: Hit) -> dict:
    """Carried u/v/n of ``hit`` against hit_attributes' redo of the same
    hit record: uv, normal and location must agree on every hit."""
    bare = Hit(t=hit.t, tri=hit.tri, inst=hit.inst)
    attrs = jax.jit(hit_attributes)
    a = attrs(scene, origin, directions, hit)
    b = attrs(scene, origin, directions, bare)
    m = np.asarray(b.hit)
    err = {
        k: float(np.abs(np.asarray(getattr(a, k))[m]
                        - np.asarray(getattr(b, k))[m]).max())
        if m.any() else 0.0
        for k in ("uv", "normal", "location")
    }
    return {**err, "ok": all(v <= ATTR_ATOL for v in err.values())}


def check_backend(backend: str, scene, origin, directions,
                  want: Hit | None = None) -> dict:
    """Closest-hit, any-hit and carried attributes of ``backend`` against
    the brute oracle on one ray set. Returns each check's statistics."""
    if want is None:
        want = brute_hits(scene, origin, directions)
    closest = jax.jit(get_cast_fn(backend, want_normals=True))(
        scene, origin, directions)
    anyhit = jax.jit(occlusion_cast_fn(backend))(scene, origin, directions)
    cos = incidence_cos(scene, origin, directions, want)
    out = {
        "closest": hit_agreement(closest, want, cos=cos),
        "any_hit": hit_agreement(anyhit, want, any_hit=True),
    }
    if closest.u is not None:
        out["attrs"] = attr_agreement(scene, origin, directions, closest)
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def image_agreement(a, b) -> dict:
    """Share of pixels that differ between two u8 images."""
    a, b = np.asarray(a), np.asarray(b)
    frac = float((a != b).any(-1).mean())
    return {"pixels_differ": frac, "ok": frac <= PIXELS_MAX}
