// exactgeom — native host-side exact collision backend.
//
// Role parity: the reference delegates exact collision checking to libfcl
// (C++) through python-fcl/trimesh (urdf_interface.py:100-344,
// env_interface.py). This library provides the equivalent native runtime
// piece for diffco_tpu: batched signed-distance queries of
// sphere-decomposed robots against primitive scenes, OpenMP-parallel over
// configurations, callable from Python via ctypes. It lives off the TPU
// compute path (dataset labeling, trajectory validation, CI oracles) and
// matches the semantics of diffco_tpu.geometry.geometry3d (positive =
// penetration).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC exactgeom.cpp -o
//        libexactgeom.so   (see diffco_tpu/native/__init__.py)

#include <cmath>
#include <cstdint>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 sub(const Vec3 &a, const Vec3 &b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

inline double norm(const Vec3 &a) {
  return std::sqrt(a.x * a.x + a.y * a.y + a.z * a.z);
}

// rotate world->local with row-major R (local = R^T * (p - t))
inline Vec3 to_local(const Vec3 &p, const double *R, const Vec3 &t) {
  Vec3 d = sub(p, t);
  return {R[0] * d.x + R[3] * d.y + R[6] * d.z,
          R[1] * d.x + R[4] * d.y + R[7] * d.z,
          R[2] * d.x + R[5] * d.y + R[8] * d.z};
}

inline double box_sdf(const Vec3 &p, const double *half) {
  double qx = std::fabs(p.x) - half[0];
  double qy = std::fabs(p.y) - half[1];
  double qz = std::fabs(p.z) - half[2];
  double ox = std::max(qx, 0.0), oy = std::max(qy, 0.0),
         oz = std::max(qz, 0.0);
  double outside = std::sqrt(ox * ox + oy * oy + oz * oz);
  double inside = std::min(std::max(qx, std::max(qy, qz)), 0.0);
  return outside + inside;
}

inline double cylinder_sdf(const Vec3 &p, double r, double hh) {
  double dxy = std::sqrt(p.x * p.x + p.y * p.y) - r;
  double dz = std::fabs(p.z) - hh;
  double ox = std::max(dxy, 0.0), oz = std::max(dz, 0.0);
  double outside = std::sqrt(ox * ox + oz * oz);
  double inside = std::min(std::max(dxy, dz), 0.0);
  return outside + inside;
}

inline double capsule_sdf(const Vec3 &p, double r, double hh) {
  double z = std::min(std::max(p.z, -hh), hh);
  double dx = p.x, dy = p.y, dz = p.z - z;
  return std::sqrt(dx * dx + dy * dy + dz * dz) - r;
}

// Scene layout (all doubles, row-major):
//   spheres:   [ns, 4]  (cx, cy, cz, r)
//   boxes:     [nb, 15] (t 3, R 9, half 3)
//   cylinders: [nc, 14] (t 3, R 9, r, hh)
//   capsules:  [nk, 14] (t 3, R 9, r, hh)
//   mesh spheres: [nm, 5] (cx, cy, cz, r, obj_id) — sphere decompositions
struct Scene {
  const double *sph;
  int ns;
  const double *box;
  int nb;
  const double *cyl;
  int nc;
  const double *cap;
  int nk;
  const double *msh;
  int nm;
};

// signed distance (positive = penetration) of one robot sphere vs scene;
// returns the max over all objects.
inline double sphere_vs_scene(const Vec3 &c, double r, const Scene &s) {
  double best = -1e30;
  for (int i = 0; i < s.ns; ++i) {
    const double *o = s.sph + 4 * i;
    double d = norm(sub(c, {o[0], o[1], o[2]})) - o[3];
    best = std::max(best, r - d);
  }
  for (int i = 0; i < s.nb; ++i) {
    const double *o = s.box + 15 * i;
    Vec3 pl = to_local(c, o + 3, {o[0], o[1], o[2]});
    best = std::max(best, r - box_sdf(pl, o + 12));
  }
  for (int i = 0; i < s.nc; ++i) {
    const double *o = s.cyl + 14 * i;
    Vec3 pl = to_local(c, o + 3, {o[0], o[1], o[2]});
    best = std::max(best, r - cylinder_sdf(pl, o[12], o[13]));
  }
  for (int i = 0; i < s.nk; ++i) {
    const double *o = s.cap + 14 * i;
    Vec3 pl = to_local(c, o + 3, {o[0], o[1], o[2]});
    best = std::max(best, r - capsule_sdf(pl, o[12], o[13]));
  }
  for (int i = 0; i < s.nm; ++i) {
    const double *o = s.msh + 5 * i;
    double d = norm(sub(c, {o[0], o[1], o[2]})) - o[3];
    best = std::max(best, r - d);
  }
  return best;
}

}  // namespace

extern "C" {

// Batched robot-vs-scene signed distance.
// centers: [B, P, 3]; radii: [P]; out: [B] (max signed dist; >0 collision)
void batch_spheres_vs_scene(const double *centers, const double *radii,
                            int64_t B, int64_t P, const double *sph, int ns,
                            const double *box, int nb, const double *cyl,
                            int nc, const double *cap, int nk,
                            const double *msh, int nm, double *out) {
  Scene s{sph, ns, box, nb, cyl, nc, cap, nk, msh, nm};
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    double best = -1e30;
    const double *row = centers + b * P * 3;
    for (int64_t p = 0; p < P; ++p) {
      Vec3 c{row[3 * p], row[3 * p + 1], row[3 * p + 2]};
      best = std::max(best, sphere_vs_scene(c, radii[p], s));
    }
    out[b] = best;
  }
}

// Batched self-collision: max overlap over sphere pairs.
// centers: [B, P, 3]; pairs: [n_pairs, 2] int32; out: [B]
void batch_self_collision(const double *centers, const double *radii,
                          int64_t B, int64_t P, const int32_t *pairs,
                          int64_t n_pairs, double *out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    const double *row = centers + b * P * 3;
    double best = -1e30;
    for (int64_t k = 0; k < n_pairs; ++k) {
      int i = pairs[2 * k], j = pairs[2 * k + 1];
      Vec3 ci{row[3 * i], row[3 * i + 1], row[3 * i + 2]};
      Vec3 cj{row[3 * j], row[3 * j + 1], row[3 * j + 2]};
      best = std::max(best, (radii[i] + radii[j]) - norm(sub(ci, cj)));
    }
    out[b] = best;
  }
}

// Batched per-object point SDFs (negative inside), for validation tooling.
// points: [N, 3]; out: [N, n_objects] ordered spheres, boxes, cylinders,
// capsules (mesh objects excluded — query their decompositions directly).
void batch_point_sdf(const double *points, int64_t N, const double *sph,
                     int ns, const double *box, int nb, const double *cyl,
                     int nc, const double *cap, int nk, double *out) {
  int n_obj = ns + nb + nc + nk;
#pragma omp parallel for schedule(static)
  for (int64_t n = 0; n < N; ++n) {
    Vec3 p{points[3 * n], points[3 * n + 1], points[3 * n + 2]};
    double *row = out + n * n_obj;
    int k = 0;
    for (int i = 0; i < ns; ++i, ++k) {
      const double *o = sph + 4 * i;
      row[k] = norm(sub(p, {o[0], o[1], o[2]})) - o[3];
    }
    for (int i = 0; i < nb; ++i, ++k) {
      const double *o = box + 15 * i;
      row[k] = box_sdf(to_local(p, o + 3, {o[0], o[1], o[2]}), o + 12);
    }
    for (int i = 0; i < nc; ++i, ++k) {
      const double *o = cyl + 14 * i;
      row[k] = cylinder_sdf(to_local(p, o + 3, {o[0], o[1], o[2]}), o[12],
                            o[13]);
    }
    for (int i = 0; i < nk; ++i, ++k) {
      const double *o = cap + 14 * i;
      row[k] = capsule_sdf(to_local(p, o + 3, {o[0], o[1], o[2]}), o[12],
                           o[13]);
    }
  }
}

int exactgeom_version() { return 1; }

}  // extern "C"
