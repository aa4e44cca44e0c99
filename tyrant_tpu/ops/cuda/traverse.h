// Per-ray BVH traversal shared by the CUDA kernels (traverse_gpu.cu) and the
// host build (traverse_cpu.cc) that the CPU tests run.
//
// One ray per thread, the reference's design (bvh.h:118-161 closest hit,
// bvh.h:213-256 any hit): a ray walks the depth-first node array near child
// first (dirIsNeg[splitAxis], bvh.h:146-152).  Instead of a private stack it
// follows the per-octant escape links the scene already builds
// (BVHDevice.miss_flat, scene/bvh.py thread_links), which give the same
// visit order with no depth limit.
//
// The arithmetic mirrors ops/traverse.py (the XLA cascade) operation by
// operation, so the two agree up to floating-point contraction:
//   * the slab test takes NaN-propagating max/min like jnp.max/jnp.min;
//   * a leaf tests its slots against the distance the ray carried INTO the
//     leaf and keeps the first of the nearest accepted slots (jnp.argmin);
//   * accept rule t > EPSILON and (limit - t) > EPSILON (bvh.h:134, 231).
//
// Tables (BVHDevice.from_host):
//   nodes  [Nn, 8] f32: lo.xyz, hi.xyz, meta (i32 bits), lane7 (i32 bits:
//          second child of an interior node, leaf row of a leaf).  32 bytes.
//   miss   [8 * Nn] i32: escape link per direction octant, octant-major.
//   leaves [L, 9 * LEAF_WIDTH] f32: v0, e1, e2 per slot.
#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define TY_HD __host__ __device__ __forceinline__
#else
#define TY_HD inline
#endif

namespace tyrant {

constexpr float kEpsilon = 1e-3f;   // config.EPSILON (variables.h:14)
constexpr float kVeryFar = 1e20f;   // config.VERY_FAR (kernel.cu:15)
constexpr int kLeafWidth = 6;       // ops/traverse.LEAF_WIDTH
constexpr int kMetaCountMask = 7;   // scene/bvh.py meta packing
constexpr int kMetaAxisShift = 3;
constexpr int kMetaAxisMask = 3;
constexpr int kMetaOffsetShift = 5;

struct V3 {
  float x, y, z;
};

TY_HD float ld(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

TY_HD int ldi(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

TY_HD int f2i(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int i;
  std::memcpy(&i, &f, sizeof(i));
  return i;
#endif
}

// NaN-propagating max/min (XLA's semantics; fmaxf would drop the NaN).
TY_HD float pmax(float a, float b) { return (a > b || a != a) ? a : b; }
TY_HD float pmin(float a, float b) { return (a < b || a != a) ? a : b; }

TY_HD V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

TY_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

TY_HD V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

// Möller-Trumbore with backface culling (loader.h:21-46,
// ops/intersect.moller_trumbore): 0 on a miss.
TY_HD float moller_trumbore(V3 o, V3 d, V3 v0, V3 e1, V3 e2) {
  V3 pvec = cross(d, e2);
  float det = dot(e1, pvec);
  float inv_det = 1.0f / ((det < 1e-30f && det > -1e-30f) ? 1.0f : det);
  V3 tvec = sub(o, v0);
  float u = dot(tvec, pvec) * inv_det;
  V3 qvec = cross(tvec, e1);
  float v = dot(d, qvec) * inv_det;
  float t = dot(e2, qvec) * inv_det;
  bool valid = (det >= 1e-7f) & (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) &
               (u + v <= 1.0f);
  return valid ? t : 0.0f;
}

struct Bvh {
  const float* nodes;
  const int32_t* miss;
  const float* leaves;
  int n_nodes;
};

struct Ray {
  V3 o, d, inv;
  bool neg[3];
  int octant;
};

TY_HD Ray make_ray(const float* origin, const float* direction, int64_t i) {
  Ray r;
  r.o = {origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]};
  r.d = {direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]};
  r.inv = {1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z};
  r.neg[0] = r.d.x < 0.0f;
  r.neg[1] = r.d.y < 0.0f;
  r.neg[2] = r.d.z < 0.0f;
  r.octant = int(r.neg[0]) + 2 * int(r.neg[1]) + 4 * int(r.neg[2]);
  return r;
}

struct Visit {
  bool box_hit;
  int count, axis, offset, lane7;
};

// One node row: slab test against ``prune`` (bbox.h:38-62 with the
// early-out against the running limit, Bbox.h:61).
TY_HD Visit visit(const Bvh& b, const Ray& r, int node, float prune) {
  const float* row = b.nodes + 8 * int64_t(node);
  float lo[3] = {ld(row), ld(row + 1), ld(row + 2)};
  float hi[3] = {ld(row + 3), ld(row + 4), ld(row + 5)};
  int meta = f2i(ld(row + 6));
  Visit v;
  v.lane7 = f2i(ld(row + 7));
  v.count = meta & kMetaCountMask;
  v.axis = (meta >> kMetaAxisShift) & kMetaAxisMask;
  v.offset = meta >> kMetaOffsetShift;
  float o[3] = {r.o.x, r.o.y, r.o.z};
  float inv[3] = {r.inv.x, r.inv.y, r.inv.z};
  float tn[3], tf[3];
  for (int a = 0; a < 3; ++a) {
    float nb = r.neg[a] ? hi[a] : lo[a];
    float fb = r.neg[a] ? lo[a] : hi[a];
    tn[a] = (nb - o[a]) * inv[a];
    tf[a] = (fb - o[a]) * inv[a];
  }
  float t0 = pmax(pmax(tn[0], tn[1]), tn[2]);
  float t1 = pmin(pmin(tf[0], tf[1]), tf[2]);
  v.box_hit = (t0 <= t1) & (t0 < prune) & (t1 > 0.0f);
  return v;
}

TY_HD int next_node(const Bvh& b, const Ray& r, int node, const Visit& v) {
  if (v.box_hit && v.count == 0) return r.neg[v.axis] ? v.lane7 : node + 1;
  return ldi(b.miss + int64_t(r.octant) * b.n_nodes + node);
}

// Distance of leaf slot j, or 0 (moller_trumbore's miss).
TY_HD float slot_t(const Bvh& b, const Ray& r, int leaf_row, int j) {
  const float* s = b.leaves + int64_t(leaf_row) * (9 * kLeafWidth) + 9 * j;
  V3 v0 = {ld(s), ld(s + 1), ld(s + 2)};
  V3 e1 = {ld(s + 3), ld(s + 4), ld(s + 5)};
  V3 e2 = {ld(s + 6), ld(s + 7), ld(s + 8)};
  return moller_trumbore(r.o, r.d, v0, e1, e2);
}

// Closest hit: (t, prim) seeded with t_init; prim -1 when nothing beat it.
TY_HD void closest_hit(const Bvh& b, const Ray& r, float t_init, float* t_out,
                       int* id_out) {
  float t_best = t_init;
  int hit = -1;
  int node = 0;
  while (node >= 0) {
    Visit v = visit(b, r, node, t_best);
    if (v.box_hit && v.count > 0) {
      float limit = t_best;
      float t_min = kVeryFar;
      int j_min = 0;
      for (int j = 0; j < v.count; ++j) {
        float t = slot_t(b, r, v.lane7, j);
        bool ok = (t > kEpsilon) & ((limit - t) > kEpsilon);
        float tm = ok ? t : kVeryFar;
        if (tm < t_min) {
          t_min = tm;
          j_min = j;
        }
      }
      if (t_min < t_best) {
        t_best = t_min;
        hit = v.offset + j_min;
      }
    }
    node = next_node(b, r, node, v);
  }
  *t_out = t_best;
  *id_out = hit;
}

// Any hit closer than max_dist (shadow rays); an inactive ray is unoccluded.
TY_HD bool any_hit(const Bvh& b, const Ray& r, float max_dist, bool active) {
  int node = active ? 0 : -1;
  while (node >= 0) {
    Visit v = visit(b, r, node, max_dist);
    if (v.box_hit && v.count > 0) {
      for (int j = 0; j < v.count; ++j) {
        float t = slot_t(b, r, v.lane7, j);
        if ((t > kEpsilon) & ((max_dist - t) > kEpsilon)) return true;
      }
    }
    node = next_node(b, r, node, v);
  }
  return false;
}

}  // namespace tyrant
