// Per-ray BVH traversal, shared by the CUDA kernel (traverse_cuda.cu) and
// its host build (traverse_cpu.cc). One call traces one ray through every
// mesh instance, as the reference's render megakernel does for its pixel
// (raycast.cu:26-138): move the ray into object space by the inverse
// instance transform, walk that mesh's binary BVH with a private stack,
// push the far child and descend into the near one, prune both against
// the best t.
//
// The arithmetic is render/intersect.py's, operation for operation, so the
// kernel agrees with the brute-force oracle and the XLA walk:
//   * slab test with the 1e-12 outward nudge, fmin/fmax NaN suppression
//     and the clamped reciprocal direction (intersect.py:123-170);
//   * two-step triangle test: plane hit (|denom| >= 1e-6, t >= 0), then
//     the barycentric rows rA/rB precomputed per triangle
//     (intersect.barycentric_rows) with the EDGE_EPS inclusive bound;
//   * back-face culling (dot(d, n) < 0) and strict t < t_best.
//
// Tables (packed per call by kernels/traverse.py):
//   nodes     int32 [N, 16]: for an internal node, the boxes of its two
//             children and their indices, so one 64-byte record answers
//             a visit:  [a.min xyz | a] [a.max xyz | b] [b.min xyz | 0]
//             [b.max xyz | 0], floats stored as their bits. For a leaf:
//             [0 0 0 | -(first triangle) - 1] [0 0 0 | triangle count].
//   tris      float [T, 12]: v0 xyz, n xyz, rA xyz, rB xyz.
//   inst      float [I, 10]: rotation quaternion (w x y z) of the
//             instance pose, pose xyz, inverse scale xyz.
//   inst_root int32 [I]: BVH root node of the instance's mesh.
#pragma once

#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define TRT_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define TRT_HD inline
#endif

namespace trt {

// Deepest node the BVH builders make (accel/bvh.py MAX_BVH_DEPTH; the
// root has depth 1). A walk holds at most one pending sibling per level
// plus the two children just pushed, so kMaxDepth entries suffice; one
// spare keeps the bound obvious.
constexpr int kMaxDepth = 48;
constexpr int kStackSize = kMaxDepth + 1;
constexpr float kFltMax = 3.4028235e38f;
constexpr float kParallelEps = 1e-6f;
constexpr float kEdgeEps = 1e-3f;
constexpr float kEdgeHi = 1.001f;  // f32(1.0 + EDGE_EPS)
constexpr float kNudge = 1e-12f;
constexpr float kTiny = 1e-30f;

// mode bits of a cast
constexpr int kAnyHit = 1;     // stop at the first accepted hit
constexpr int kWantAttrs = 2;  // also write u, v and the face normal

struct V3 {
  float x, y, z;
};

TRT_HD V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
TRT_HD V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
TRT_HD V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
TRT_HD V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
// jnp.sum over the last axis: (a0 + a1) + a2
TRT_HD float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

TRT_HD float as_float(int32_t i) {
#if defined(__CUDA_ARCH__)
  return __int_as_float(i);
#else
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
#endif
}

TRT_HD float min_f(float a, float b) {
#if defined(__CUDA_ARCH__)
  return fminf(a, b);
#else
  return std::fmin(a, b);
#endif
}

TRT_HD float max_f(float a, float b) {
#if defined(__CUDA_ARCH__)
  return fmaxf(a, b);
#else
  return std::fmax(a, b);
#endif
}

TRT_HD float abs_f(float a) {
#if defined(__CUDA_ARCH__)
  return fabsf(a);
#else
  return std::fabs(a);
#endif
}

struct I4 {
  int32_t x, y, z, w;
};
struct F4 {
  float x, y, z, w;
};

// Scene tables are read-only for the whole call: on the card they go
// through the non-coherent read-only path (and stay in the 50 MB L2).
TRT_HD I4 load_i4(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

TRT_HD F4 load_f4(const float* p) {
#if defined(__CUDA_ARCH__)
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

TRT_HD float load_f(const float* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

TRT_HD int32_t load_i(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

struct Tables {
  const int32_t* nodes;
  const float* tris;
  const float* inst;
  const int32_t* inst_root;
  int32_t num_inst;
};

struct Hit {
  float t;
  int32_t tri;
  int32_t inst;
  float u, v;
  V3 n;
};

// core/transforms.apply_quat; q.w is the scalar part
TRT_HD V3 apply_quat(F4 q, V3 v) {
  float a = (-v.x * q.x - v.y * q.y) - v.z * q.z;
  float b = (v.x * q.w + v.y * q.z) - v.z * q.y;
  float c = (v.y * q.w + v.z * q.x) - v.x * q.z;
  float d = (v.z * q.w + v.x * q.y) - v.y * q.x;
  return {((q.w * b - q.x * a) - q.y * d) + q.z * c,
          ((q.w * c - q.y * a) - q.z * b) + q.x * d,
          ((q.w * d - q.z * a) - q.x * c) + q.y * b};
}

// intersect.safe_reciprocal
TRT_HD float safe_rcp(float d) {
  if (abs_f(d) < kTiny) d = (d < 0.f ? -kTiny : kTiny) + 0.f * d;
  return 1.f / d;
}

// intersect.ray_aabb_entry: entry distance or FLT_MAX on a miss
TRT_HD float box_entry(V3 o, V3 inv, V3 lo, V3 hi) {
  float x0 = ((lo.x - o.x) - kNudge) * inv.x, x1 = ((hi.x - o.x) + kNudge) * inv.x;
  float y0 = ((lo.y - o.y) - kNudge) * inv.y, y1 = ((hi.y - o.y) + kNudge) * inv.y;
  float z0 = ((lo.z - o.z) - kNudge) * inv.z, z1 = ((hi.z - o.z) + kNudge) * inv.z;
  float tnx = min_f(x0, x1), tfx = max_f(x0, x1);
  float tny = min_f(y0, y1), tfy = max_f(y0, y1);
  float tnz = min_f(z0, z1), tfz = max_f(z0, z1);
  float far_t = min_f(min_f(tfx, tfy), tfz);
  float near_t = max_f(max_f(tnx, tny), tnz);
  return (far_t >= near_t && far_t > 0.f) ? near_t : kFltMax;
}

// Plane + barycentric test of triangle k (intersect.ray_plane_hit and
// point_in_triangle_uv). Accepts only a front-facing hit closer than
// t_best; on success fills t, u, v.
TRT_HD bool hit_triangle(const float* tris, int32_t k, V3 o, V3 d,
                         float t_best, float& t, float& u, float& v) {
  const float* rec = tris + 12 * static_cast<int64_t>(k);
  F4 r0 = load_f4(rec), r1 = load_f4(rec + 4), r2 = load_f4(rec + 8);
  V3 v0{r0.x, r0.y, r0.z}, n{r0.w, r1.x, r1.y};
  float denom = dot(d, n);
  if (!(denom < 0.f) || abs_f(denom) < kParallelEps) return false;
  float tt = dot(sub(v0, o), n) / denom;
  if (!(tt >= 0.f) || !(tt < t_best)) return false;
  V3 e2 = add(sub(o, v0), scale(tt, d));
  V3 ra{r1.z, r1.w, r2.x}, rb{r2.y, r2.z, r2.w};
  float uu = dot(ra, e2), vv = dot(rb, e2);
  if (!(uu >= -kEdgeEps && vv >= -kEdgeEps && uu + vv <= kEdgeHi)) return false;
  t = tt;
  u = uu;
  v = vv;
  return true;
}

// Walk one instance's BVH from `root`. Updates `best` in place; returns
// true when an any-hit cast accepted a hit (the caller stops).
TRT_HD bool walk(const Tables& s, int32_t root, int32_t inst, V3 o, V3 d,
                 V3 inv, int mode, Hit& best) {
  int32_t stack_node[kStackSize];
  float stack_entry[kStackSize];
  int sp = 0;
  int32_t node = root;
  for (;;) {
    const int32_t* rec = s.nodes + 16 * static_cast<int64_t>(node);
    I4 w0 = load_i4(rec);
    I4 w1 = load_i4(rec + 4);
    if (w0.w >= 0) {
      // internal: test both children, descend into the near one and
      // keep the far one for later (raycast.cu:69-79)
      I4 w2 = load_i4(rec + 8);
      I4 w3 = load_i4(rec + 12);
      float da = box_entry(o, inv, {as_float(w0.x), as_float(w0.y), as_float(w0.z)},
                           {as_float(w1.x), as_float(w1.y), as_float(w1.z)});
      float db = box_entry(o, inv, {as_float(w2.x), as_float(w2.y), as_float(w2.z)},
                           {as_float(w3.x), as_float(w3.y), as_float(w3.z)});
      bool a_near = da < db;
      int32_t near_node = a_near ? w0.w : w1.w;
      int32_t far_node = a_near ? w1.w : w0.w;
      float d_near = a_near ? da : db;
      float d_far = a_near ? db : da;
      bool go_near = d_near < best.t;
      bool go_far = d_far < best.t;
      if (go_near) {
        if (go_far) {
          stack_node[sp] = far_node;
          stack_entry[sp] = d_far;
          ++sp;
        }
        node = near_node;
        continue;
      }
      if (go_far) {
        node = far_node;
        continue;
      }
    } else {
      int32_t first = -w0.w - 1;
      int32_t count = w1.w;
      for (int32_t k = first; k < first + count; ++k) {
        float t, u, v;
        if (!hit_triangle(s.tris, k, o, d, best.t, t, u, v)) continue;
        best.t = t;
        best.tri = k;
        best.inst = inst;
        best.u = u;
        best.v = v;
        if (mode & kWantAttrs) {
          const float* tr = s.tris + 12 * static_cast<int64_t>(k);
          best.n = {load_f(tr + 3), load_f(tr + 4), load_f(tr + 5)};
        }
        if (mode & kAnyHit) return true;
      }
    }
    // pop the next pending node that can still beat the best hit
    for (;;) {
      if (sp == 0) return false;
      --sp;
      if (stack_entry[sp] < best.t) break;
    }
    node = stack_node[sp];
  }
}

// Trace ray r through every instance and store its hit record.
TRT_HD void trace(const Tables& s, const float* org, const float* dir,
                  int64_t r, int mode, float* out_t, int32_t* out_tri,
                  int32_t* out_inst, float* out_u, float* out_v,
                  float* out_n) {
  V3 o{org[3 * r], org[3 * r + 1], org[3 * r + 2]};
  V3 d{dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
  Hit best{kFltMax, -1, -1, 0.f, 0.f, {0.f, 0.f, 0.f}};
  for (int32_t i = 0; i < s.num_inst; ++i) {
    const float* ip = s.inst + 10 * i;
    // stored (w, x, y, z), as core/transforms.euler2quat returns it
    F4 q{load_f(ip + 1), load_f(ip + 2), load_f(ip + 3), load_f(ip)};
    V3 p{load_f(ip + 4), load_f(ip + 5), load_f(ip + 6)};
    V3 inv_scale{load_f(ip + 7), load_f(ip + 8), load_f(ip + 9)};
    // render/renderer._instance_object_ray
    V3 od = mul(apply_quat(q, d), inv_scale);
    V3 oo = mul(apply_quat(q, sub(o, p)), inv_scale);
    V3 inv{safe_rcp(od.x), safe_rcp(od.y), safe_rcp(od.z)};
    if (walk(s, load_i(s.inst_root + i), i, oo, od, inv, mode, best)) break;
  }
  out_t[r] = best.t;
  out_tri[r] = best.tri;
  out_inst[r] = best.inst;
  if (mode & kWantAttrs) {
    out_u[r] = best.u;
    out_v[r] = best.v;
    out_n[3 * r] = best.n.x;
    out_n[3 * r + 1] = best.n.y;
    out_n[3 * r + 2] = best.n.z;
  }
}

}  // namespace trt
