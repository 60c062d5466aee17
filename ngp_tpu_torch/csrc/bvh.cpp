// Host BVH over a triangle mesh, for the SDF engine's ground truth
// (ref: src/triangle_bvh.cu and src/optix/*.cu). Signed distances are
// training-data generation, irregular tree traversal on the host, run as
// multithreaded C++ called through ctypes (ngp_tpu_torch/data/mesh.py):
//   - bvh_build: median-split binary BVH over triangles
//   - bvh_signed_distance: closest-point queries; sign via
//       mode 0 (watertight): pseudonormal test at the closest feature
//       mode 1 (raystab):    parity of 32 fixed-direction ray stabs
//       mode 2 (pathescape): random walks that escape the mesh's box
//   - bvh_closest_points: the closest surface point and its triangle
//   - bvh_raytrace: closest-hit ray casting (mesh ground-truth frames)
//
// The port's own copy of the JAX package's csrc/bvh.cpp. mesh.py builds it
// at first use: g++ -O3 -march=native -shared -fPIC -pthread, into
// build/ngp_tpu_torch/.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 v3(float x, float y, float z) { return {x, y, z}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float len2(V3 a) { return dot(a, a); }

struct Tri {
  V3 a, b, c;
  int id;
};

struct Node {
  V3 bmin, bmax;
  int left;    // internal: left child (right = left+1); leaf: -1
  int start, count;  // leaf triangle range
};

struct Bvh {
  std::vector<Tri> tris;
  std::vector<Node> nodes;
};

// closest point on triangle (Ericson, Real-Time Collision Detection §5.1.5)
static V3 closest_on_tri(V3 p, const Tri& t) {
  V3 ab = t.b - t.a, ac = t.c - t.a, ap = p - t.a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return t.a;
  V3 bp = p - t.b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return t.b;
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    float v = d1 / (d1 - d3);
    return t.a + ab * v;
  }
  V3 cp = p - t.c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return t.c;
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    float w = d2 / (d2 - d6);
    return t.a + ac * w;
  }
  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    return t.b + (t.c - t.b) * w;
  }
  float denom = 1.0f / (va + vb + vc);
  float v = vb * denom, w = vc * denom;
  return t.a + ab * v + ac * w;
}

static float box_dist2(V3 p, V3 bmin, V3 bmax) {
  float dx = std::max({bmin.x - p.x, 0.0f, p.x - bmax.x});
  float dy = std::max({bmin.y - p.y, 0.0f, p.y - bmax.y});
  float dz = std::max({bmin.z - p.z, 0.0f, p.z - bmax.z});
  return dx * dx + dy * dy + dz * dz;
}

static int build_node(Bvh& bvh, int start, int count) {
  Node n;
  n.bmin = v3(1e30f, 1e30f, 1e30f);
  n.bmax = v3(-1e30f, -1e30f, -1e30f);
  for (int i = start; i < start + count; i++) {
    const Tri& t = bvh.tris[i];
    for (const V3* v : {&t.a, &t.b, &t.c}) {
      n.bmin.x = std::min(n.bmin.x, v->x);
      n.bmin.y = std::min(n.bmin.y, v->y);
      n.bmin.z = std::min(n.bmin.z, v->z);
      n.bmax.x = std::max(n.bmax.x, v->x);
      n.bmax.y = std::max(n.bmax.y, v->y);
      n.bmax.z = std::max(n.bmax.z, v->z);
    }
  }
  int idx = (int)bvh.nodes.size();
  bvh.nodes.push_back(n);
  if (count <= 8) {  // 8 tris per leaf like the reference
    bvh.nodes[idx].left = -1;
    bvh.nodes[idx].start = start;
    bvh.nodes[idx].count = count;
    return idx;
  }
  V3 ext = n.bmax - n.bmin;
  int axis = (ext.x > ext.y && ext.x > ext.z) ? 0 : (ext.y > ext.z ? 1 : 2);
  auto key = [axis](const Tri& t) {
    float c = axis == 0 ? (t.a.x + t.b.x + t.c.x)
            : axis == 1 ? (t.a.y + t.b.y + t.c.y)
                        : (t.a.z + t.b.z + t.c.z);
    return c;
  };
  std::nth_element(bvh.tris.begin() + start,
                   bvh.tris.begin() + start + count / 2,
                   bvh.tris.begin() + start + count,
                   [&](const Tri& x, const Tri& y) { return key(x) < key(y); });
  int mid = count / 2;
  int l = build_node(bvh, start, mid);
  int r = build_node(bvh, start + mid, count - mid);
  (void)r;  // r == l_subtree_end; children are contiguous? no — store l
  bvh.nodes[idx].left = l;
  bvh.nodes[idx].start = r;  // reuse: right child index
  bvh.nodes[idx].count = -1;
  return idx;
}

struct Hit {
  float d2;
  int tri;
  V3 point;
};

static void closest_point(const Bvh& bvh, V3 p, Hit& best, int node_idx) {
  const Node& n = bvh.nodes[node_idx];
  if (box_dist2(p, n.bmin, n.bmax) >= best.d2) return;
  if (n.left < 0) {
    for (int i = n.start; i < n.start + n.count; i++) {
      V3 cp = closest_on_tri(p, bvh.tris[i]);
      float d2 = len2(p - cp);
      if (d2 < best.d2) best = {d2, i, cp};
    }
    return;
  }
  int a = n.left, b = n.start;
  float da = box_dist2(p, bvh.nodes[a].bmin, bvh.nodes[a].bmax);
  float db = box_dist2(p, bvh.nodes[b].bmin, bvh.nodes[b].bmax);
  if (da > db) std::swap(a, b);
  closest_point(bvh, p, best, a);
  closest_point(bvh, p, best, b);
}

// Möller–Trumbore
static bool ray_tri(V3 o, V3 d, const Tri& t, float* out_t) {
  V3 e1 = t.b - t.a, e2 = t.c - t.a;
  V3 pv = cross(d, e2);
  float det = dot(e1, pv);
  if (std::fabs(det) < 1e-12f) return false;
  float inv = 1.0f / det;
  V3 tv = o - t.a;
  float u = dot(tv, pv) * inv;
  if (u < 0 || u > 1) return false;
  V3 qv = cross(tv, e1);
  float v = dot(d, qv) * inv;
  if (v < 0 || u + v > 1) return false;
  float tt = dot(e2, qv) * inv;
  if (tt <= 1e-7f) return false;
  *out_t = tt;
  return true;
}

// A ray with the inverse of its direction per axis, for the slab tests
struct Ray {
  V3 o, d;
  float inv[3];
};
static inline Ray make_ray(V3 o, V3 d) {
  Ray r{o, d, {}};
  const float* dd = &d.x;
  for (int i = 0; i < 3; i++)
    r.inv[i] = 1.0f / (std::fabs(dd[i]) < 1e-12f ? 1e-12f : dd[i]);
  return r;
}

// prune=true: closest-hit only (raytrace). prune=false: visit every box
// so the crossing COUNT is exact (raystab parity needs all hits).
static void ray_all(const Bvh& bvh, const Ray& ray, int node_idx, int* count,
                    float* closest, int* closest_tri, bool prune) {
  const Node& n = bvh.nodes[node_idx];
  // slab test
  float t0 = 0, t1 = 1e30f;
  const float* bm = &n.bmin.x;
  const float* bM = &n.bmax.x;
  const float* oo = &ray.o.x;
  for (int i = 0; i < 3; i++) {
    float a = (bm[i] - oo[i]) * ray.inv[i], b = (bM[i] - oo[i]) * ray.inv[i];
    t0 = std::max(t0, std::min(a, b));
    t1 = std::min(t1, std::max(a, b));
  }
  if (t0 > t1 || (prune && t0 > *closest)) return;
  if (n.left < 0) {
    for (int i = n.start; i < n.start + n.count; i++) {
      float t;
      if (ray_tri(ray.o, ray.d, bvh.tris[i], &t)) {
        (*count)++;
        if (t < *closest) {
          *closest = t;
          *closest_tri = i;
        }
      }
    }
    return;
  }
  ray_all(bvh, ray, n.left, count, closest, closest_tri, prune);
  ray_all(bvh, ray, n.start, count, closest, closest_tri, prune);
}

static void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  int nt = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// 32 quasi-uniform stab directions (golden spiral)
static std::vector<V3> stab_dirs() {
  std::vector<V3> dirs;
  const float ga = 2.39996323f;
  for (int i = 0; i < 32; i++) {
    float z = 1.0f - 2.0f * (i + 0.5f) / 32.0f;
    float r = std::sqrt(std::max(0.0f, 1.0f - z * z));
    float th = ga * i;
    dirs.push_back(v3(r * std::cos(th), r * std::sin(th), z));
  }
  return dirs;
}

}  // namespace

extern "C" {

void* bvh_build(const float* vertices, int64_t n_vertices,
                const int32_t* indices, int64_t n_tris) {
  (void)n_vertices;
  Bvh* bvh = new Bvh();
  bvh->tris.resize(n_tris);
  for (int64_t i = 0; i < n_tris; i++) {
    const int32_t* f = indices + i * 3;
    bvh->tris[i] = {v3(vertices[f[0] * 3], vertices[f[0] * 3 + 1], vertices[f[0] * 3 + 2]),
                    v3(vertices[f[1] * 3], vertices[f[1] * 3 + 1], vertices[f[1] * 3 + 2]),
                    v3(vertices[f[2] * 3], vertices[f[2] * 3 + 1], vertices[f[2] * 3 + 2]),
                    (int)i};
  }
  bvh->nodes.reserve(2 * n_tris);
  build_node(*bvh, 0, (int)n_tris);
  return bvh;
}

void bvh_free(void* handle) { delete (Bvh*)handle; }

// xorshift64* — deterministic per-point RNG for PathEscape
static inline float rng01(uint64_t* s) {
  *s ^= *s >> 12;
  *s ^= *s << 25;
  *s ^= *s >> 27;
  return (float)(((*s * 0x2545F4914F6CDD1Dull) >> 40) & 0xFFFFFF) /
         16777216.0f;
}

static inline V3 random_sphere_dir(uint64_t* s) {
  float z = rng01(s) * 2.0f - 1.0f;
  float phi = rng01(s) * 6.28318530718f;
  float r = std::sqrt(std::max(0.0f, 1.0f - z * z));
  return v3(r * std::cos(phi), r * std::sin(phi), z);
}

// cosine-weighted hemisphere around n (ref: random_dir_cosine + Onb,
// src/optix/pathescape.cu:31-56)
static inline V3 cosine_dir(V3 n, uint64_t* s) {
  float u1 = rng01(s), u2 = rng01(s);
  float r = std::sqrt(u1), phi = 6.28318530718f * u2;
  float x = r * std::cos(phi), y = r * std::sin(phi);
  float z = std::sqrt(std::max(0.0f, 1.0f - u1));
  V3 bin = std::fabs(n.x) > std::fabs(n.z) ? v3(-n.y, n.x, 0.0f)
                                           : v3(0.0f, -n.z, n.y);
  float l = std::sqrt(len2(bin));
  bin = bin * (1.0f / (l > 0 ? l : 1.0f));
  V3 tan = cross(bin, n);
  return tan * x + bin * y + n * z;
}

// mode 0 = watertight (pseudonormal), 1 = raystab parity,
// 2 = PathEscape (ref: src/optix/pathescape.cu — 32 random-walk paths of
//     up to 4 cosine bounces; >2 escaped paths => outside)
void bvh_signed_distance(void* handle, const float* points, int64_t n,
                         float* out, int mode) {
  const Bvh& bvh = *(const Bvh*)handle;
  auto dirs = stab_dirs();
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      V3 p = v3(points[i * 3], points[i * 3 + 1], points[i * 3 + 2]);
      Hit best = {1e30f, -1, p};
      closest_point(bvh, p, best, 0);
      float d = std::sqrt(best.d2);
      float sign = 1.0f;
      if (mode == 0) {
        const Tri& t = bvh.tris[best.tri];
        V3 nrm = cross(t.b - t.a, t.c - t.a);
        sign = dot(p - best.point, nrm) >= 0 ? 1.0f : -1.0f;
      } else if (mode == 2) {
        uint64_t seed = 0x9E3779B97F4A7C15ull ^ (uint64_t)(i + 1);
        int n_escaped = 0;
        for (int path = 0; path < 32 && n_escaped <= 2; path++) {
          V3 o2 = p;
          V3 dir = random_sphere_dir(&seed);
          for (int b = 0; b < 4; b++) {
            int cnt = 0;
            float closest = 1e30f;
            int ctri = -1;
            ray_all(bvh, make_ray(o2, dir), 0, &cnt, &closest, &ctri,
                    /*prune=*/true);
            if (ctri < 0) {
              n_escaped++;
              break;
            }
            const Tri& t = bvh.tris[ctri];
            V3 nrm = cross(t.b - t.a, t.c - t.a);
            float l = std::sqrt(len2(nrm));
            if (l > 0) nrm = nrm * (1.0f / l);
            if (dot(nrm, dir) > 0) nrm = nrm * -1.0f;  // faceforward
            o2 = o2 + dir * std::max(0.0f, closest - 1e-3f);
            dir = cosine_dir(nrm, &seed);
          }
        }
        sign = n_escaped > 2 ? 1.0f : -1.0f;
      } else {
        // inside on a strict majority of odd crossing counts; the stabs
        // stop once the votes cast decide it either way
        const int n_dirs = (int)dirs.size(), majority = n_dirs / 2 + 1;
        int inside_votes = 0, cast = 0;
        for (const V3& dir : dirs) {
          int cnt = 0;
          float closest = 1e30f;
          int ctri = -1;
          ray_all(bvh, make_ray(p, dir), 0, &cnt, &closest, &ctri,
                  /*prune=*/false);
          if (cnt % 2 == 1) inside_votes++;
          cast++;
          if (inside_votes >= majority ||
              inside_votes + (n_dirs - cast) < majority)
            break;
        }
        sign = inside_votes * 2 > n_dirs ? -1.0f : 1.0f;
      }
      out[i] = sign * d;
    }
  });
}

void bvh_closest_points(void* handle, const float* points, int64_t n,
                        float* out_points, int32_t* out_tris) {
  const Bvh& bvh = *(const Bvh*)handle;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      V3 p = v3(points[i * 3], points[i * 3 + 1], points[i * 3 + 2]);
      Hit best = {1e30f, -1, p};
      closest_point(bvh, p, best, 0);
      out_points[i * 3] = best.point.x;
      out_points[i * 3 + 1] = best.point.y;
      out_points[i * 3 + 2] = best.point.z;
      out_tris[i] = best.tri >= 0 ? bvh.tris[best.tri].id : -1;
    }
  });
}

// closest-hit raytrace: out_t = hit distance (1e10 for miss), out_tri id,
// out_n = geometric normal
void bvh_raytrace(void* handle, const float* origins, const float* dirs_in,
                  int64_t n, float* out_t, int32_t* out_tri, float* out_n) {
  const Bvh& bvh = *(const Bvh*)handle;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      V3 o = v3(origins[i * 3], origins[i * 3 + 1], origins[i * 3 + 2]);
      V3 d = v3(dirs_in[i * 3], dirs_in[i * 3 + 1], dirs_in[i * 3 + 2]);
      int cnt = 0;
      float closest = 1e30f;
      int ctri = -1;
      ray_all(bvh, make_ray(o, d), 0, &cnt, &closest, &ctri, /*prune=*/true);
      if (ctri < 0) {
        out_t[i] = 1e10f;
        out_tri[i] = -1;
        out_n[i * 3] = out_n[i * 3 + 1] = out_n[i * 3 + 2] = 0;
      } else {
        out_t[i] = closest;
        out_tri[i] = bvh.tris[ctri].id;
        const Tri& t = bvh.tris[ctri];
        V3 nrm = cross(t.b - t.a, t.c - t.a);
        float l = std::sqrt(len2(nrm));
        if (l > 0) nrm = nrm * (1.0f / l);
        out_n[i * 3] = nrm.x;
        out_n[i * 3 + 1] = nrm.y;
        out_n[i * 3 + 2] = nrm.z;
      }
    }
  });
}

}  // extern "C"
