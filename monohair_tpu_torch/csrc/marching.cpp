// Marching tetrahedra over a scalar grid: the coarse-mesh export's host
// kernel (the port's own copy of monohair_tpu/native/marching.cpp, same
// arithmetic, so that both give the same triangles in the same order).
//
// The mesh export runs on the host (the reference uses instant-ngp's CUDA
// marching cubes, run.py:272-276); a 256^3 grid has ~100M tetrahedra. This
// kernel streams the grid once and emits a triangle soup. Built by
// monohair_tpu_torch/ops/_build.py (g++ with the JAX package's flags),
// called through ctypes by monohair_tpu_torch/nerf/marching.py.
//
// 6 tets per cube sharing the 0-7 diagonal, inside = value > iso; cube
// corners in x-major order (CUBE below).

#include <cstdint>
#include <cstring>

namespace {

// cube corner k -> (x, y, z) offset bits (meshgrid 'ij' order: x-major)
const int CUBE[8][3] = {{0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
                        {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1}};

const int TETS[6][4] = {{0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
                        {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7}};

const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// case -> up to 2 triangles of tet-edge ids, -1 terminated
const int CASES[16][6] = {
    {-1, -1, -1, -1, -1, -1},
    {0, 1, 2, -1, -1, -1},        // 0001
    {0, 3, 4, -1, -1, -1},        // 0010
    {1, 2, 4, 1, 4, 3},           // 0011
    {1, 3, 5, -1, -1, -1},        // 0100
    {0, 2, 5, 0, 5, 3},           // 0101
    {0, 5, 1, 0, 4, 5},           // 0110
    {2, 5, 4, -1, -1, -1},        // 0111
    {2, 4, 5, -1, -1, -1},        // 1000
    {0, 1, 5, 0, 5, 4},           // 1001
    {0, 5, 2, 0, 3, 5},           // 1010
    {1, 5, 3, -1, -1, -1},        // 1011
    {1, 4, 2, 1, 3, 4},           // 1100
    {0, 4, 3, -1, -1, -1},        // 1101
    {0, 2, 1, -1, -1, -1},        // 1110
    {-1, -1, -1, -1, -1, -1},
};

}  // namespace

extern "C" {

// Returns number of triangles written (each 9 floats: 3 verts x xyz in grid
// coords), or -1 on overflow of max_tris.
int64_t marching_tets(const float* grid, int64_t X, int64_t Y, int64_t Z,
                      float iso, float* out, int64_t max_tris) {
  int64_t ntri = 0;
  const int64_t sx = Y * Z, sy = Z;
  for (int64_t x = 0; x + 1 < X; ++x) {
    for (int64_t y = 0; y + 1 < Y; ++y) {
      const float* base = grid + x * sx + y * sy;
      for (int64_t z = 0; z + 1 < Z; ++z) {
        float v[8];
        int inside_mask = 0;
        for (int k = 0; k < 8; ++k) {
          v[k] = base[CUBE[k][0] * sx + CUBE[k][1] * sy + CUBE[k][2] + z];
          if (v[k] > iso) inside_mask |= 1 << k;
        }
        if (inside_mask == 0 || inside_mask == 0xFF) continue;
        float px[8], py[8], pz[8];
        for (int k = 0; k < 8; ++k) {
          px[k] = float(x + CUBE[k][0]);
          py[k] = float(y + CUBE[k][1]);
          pz[k] = float(z + CUBE[k][2]);
        }
        for (int t = 0; t < 6; ++t) {
          int c = 0;
          for (int k = 0; k < 4; ++k)
            if (v[TETS[t][k]] > iso) c |= 1 << k;
          const int* tri = CASES[c];
          if (tri[0] < 0) continue;
          // edge intersection points
          float ex[6], ey[6], ez[6];
          for (int e = 0; e < 6; ++e) {
            int a = TETS[t][TET_EDGES[e][0]], b = TETS[t][TET_EDGES[e][1]];
            float da = v[a], db = v[b];
            float denom = db - da;
            float u = (denom > -1e-12f && denom < 1e-12f)
                          ? 0.5f
                          : (iso - da) / denom;
            if (u < 0.f) u = 0.f;
            if (u > 1.f) u = 1.f;
            ex[e] = px[a] + (px[b] - px[a]) * u;
            ey[e] = py[a] + (py[b] - py[a]) * u;
            ez[e] = pz[a] + (pz[b] - pz[a]) * u;
          }
          for (int k = 0; k < 2; ++k) {
            if (tri[3 * k] < 0) break;
            if (ntri >= max_tris) return -1;
            float* o = out + ntri * 9;
            for (int j = 0; j < 3; ++j) {
              int e = tri[3 * k + j];
              o[3 * j + 0] = ex[e];
              o[3 * j + 1] = ey[e];
              o[3 * j + 2] = ez[e];
            }
            ++ntri;
          }
        }
      }
    }
  }
  return ntri;
}

}  // extern "C"
