// Native marching-tetrahedra polygoniser (a host library, not a kernel).
//
// The port's copy of runtime/mc_native.cpp: the host-side half of mesh
// extraction (the SDF grid is evaluated on the GPU,
// mneslam_tpu_torch/mapping/mesher.py). Truncation-aware isosurface
// extraction over a dense volume.
//
// Same 6-tetrahedra decomposition and 16-case table as the numpy path of
// mneslam_tpu_torch/ops/mc.py (kept in lockstep; the tests compare the two).
// `mtet_weld` is the numpy weld (`mc._weld`: np.round to 5 decimals,
// np.unique over the rows, first occurrence of each key) as one sort, with
// the same result bit for bit.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC, at first use, into
// mneslam_tpu_torch/kernels/_build/ (kernels/build.py `load_host`).
// ABI: plain C, loaded with ctypes (ops/mc.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Cube corners by binary (dx, dy, dz); v index bits: x + 2y + 4z.
const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

// Six tetrahedra sharing the 0-7 diagonal (equator walk 1,3,2,6,4,5).
const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

// Tetra edges as local vertex pairs.
const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// 16-case table: up to 2 triangles of edge ids (-1 = unused).
// Case bit i set <=> tet vertex i inside (value < isovalue).
const int8_t TET_TRIS[16][2][3] = {
    /*0000*/ {{-1, -1, -1}, {-1, -1, -1}},
    /*0001*/ {{0, 1, 2}, {-1, -1, -1}},
    /*0010*/ {{0, 4, 3}, {-1, -1, -1}},
    /*0011*/ {{1, 2, 4}, {1, 4, 3}},
    /*0100*/ {{1, 3, 5}, {-1, -1, -1}},
    /*0101*/ {{0, 2, 5}, {0, 5, 3}},
    /*0110*/ {{0, 4, 5}, {0, 5, 1}},
    /*0111*/ {{2, 4, 5}, {-1, -1, -1}},
    /*1000*/ {{2, 5, 4}, {-1, -1, -1}},
    /*1001*/ {{0, 1, 5}, {0, 5, 4}},
    /*1010*/ {{0, 3, 5}, {0, 5, 2}},
    /*1011*/ {{1, 5, 3}, {-1, -1, -1}},
    /*1100*/ {{1, 3, 4}, {1, 4, 2}},
    /*1101*/ {{0, 3, 4}, {-1, -1, -1}},
    /*1110*/ {{0, 2, 1}, {-1, -1, -1}},
    /*1111*/ {{-1, -1, -1}, {-1, -1, -1}},
};

}  // namespace

extern "C" {

// Polygonize `volume` [nx, ny, nz] (C-order) at `isovalue`.
// Cubes with any corner non-finite or |v - iso| >= truncation (if
// truncation > 0) are skipped. Writes up to max_verts vertices (xyz index
// coordinates, 3 floats each, consecutive triplets = triangles) into
// out_verts. Returns the total number of vertices the surface needs —
// callers grow the buffer and retry if the return exceeds max_verts.
int64_t mtet_polygonize(const float* volume, int64_t nx, int64_t ny, int64_t nz,
                        float isovalue, float truncation,
                        float* out_verts, int64_t max_verts) {
  const int64_t sy = nz;          // stride for y in C-order [x][y][z]
  const int64_t sx = ny * nz;
  int64_t count = 0;

  float f[8];
  for (int64_t x = 0; x + 1 < nx; ++x) {
    for (int64_t y = 0; y + 1 < ny; ++y) {
      const float* base = volume + x * sx + y * sy;
      for (int64_t z = 0; z + 1 < nz; ++z) {
        bool ok = true;
        bool any_in = false, all_in = true;
        for (int c = 0; c < 8; ++c) {
          const float v = base[CORNERS[c][0] * sx + CORNERS[c][1] * sy +
                               CORNERS[c][2] + z];
          if (!std::isfinite(v) ||
              (truncation > 0 && std::fabs(v - isovalue) >= truncation)) {
            ok = false;
            break;
          }
          f[c] = v;
          const bool in = v < isovalue;
          any_in |= in;
          all_in &= in;
        }
        if (!ok || !any_in || all_in) continue;

        for (int t = 0; t < 6; ++t) {
          int caseid = 0;
          for (int v = 0; v < 4; ++v) {
            if (f[TETS[t][v]] < isovalue) caseid |= 1 << v;
          }
          for (int tri = 0; tri < 2; ++tri) {
            if (TET_TRIS[caseid][tri][0] < 0) continue;
            for (int e = 0; e < 3; ++e) {
              const int eid = TET_TRIS[caseid][tri][e];
              const int a = TETS[t][TET_EDGES[eid][0]];
              const int b = TETS[t][TET_EDGES[eid][1]];
              const float fa = f[a], fb = f[b];
              float tt = (isovalue - fa) /
                         (std::fabs(fb - fa) < 1e-12f ? 1e-12f : (fb - fa));
              tt = tt < 0.f ? 0.f : (tt > 1.f ? 1.f : tt);
              if (count < max_verts) {
                float* o = out_verts + count * 3;
                o[0] = float(x) + CORNERS[a][0] + tt * (CORNERS[b][0] - CORNERS[a][0]);
                o[1] = float(y) + CORNERS[a][1] + tt * (CORNERS[b][1] - CORNERS[a][1]);
                o[2] = float(z) + CORNERS[a][2] + tt * (CORNERS[b][2] - CORNERS[a][2]);
              }
              ++count;
            }
          }
        }
      }
    }
  }
  return count;
}

// Weld raw triangle vertices `raw` [n, 3] (index coordinates, >= 0):
// key = np.round(v, 5) in float32 (v * 1e5, round half to even, / 1e5),
// keys sorted lexicographically as np.unique(axis=0) sorts them. Writes
// inv[i] = rank of raw vertex i's key and first[k] = the smallest raw
// index with key rank k; returns the number of distinct keys.
int64_t mtet_weld(const float* raw, int64_t n, int64_t* inv, int64_t* first) {
  struct Key {
    float x, y, z;
    int32_t pad;
    int64_t i;
  };
  std::vector<Key> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    const float* v = raw + 3 * i;
    keys[i] = {std::nearbyint(v[0] * 100000.0f) / 100000.0f,
               std::nearbyint(v[1] * 100000.0f) / 100000.0f,
               std::nearbyint(v[2] * 100000.0f) / 100000.0f, 0, i};
  }
  std::sort(keys.begin(), keys.end(), [](const Key& a, const Key& b) {
    if (a.x != b.x) return a.x < b.x;
    if (a.y != b.y) return a.y < b.y;
    if (a.z != b.z) return a.z < b.z;
    return a.i < b.i;
  });
  int64_t k = -1;
  for (int64_t j = 0; j < n; ++j) {
    const Key& c = keys[j];
    if (j == 0 || c.x != keys[j - 1].x || c.y != keys[j - 1].y ||
        c.z != keys[j - 1].z) {
      first[++k] = c.i;  // equal keys sort by raw index: the first is least
    }
    inv[c.i] = k;
  }
  return k + 1;
}

}  // extern "C"
