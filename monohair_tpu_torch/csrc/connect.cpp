// Native connect_to_scalp — the stage-4 host hot spot (HairGrow.py:606-784).
//
// The PyTorch port's own copy of monohair_tpu/native/connect.cpp, built by
// monohair_tpu_torch/ops/_build.py with the same g++ flags, so that both give
// the same bits. Semantics mirror
// monohair_tpu_torch/strands/connect.py::connect_to_scalp_plain (the Python
// version, held against the JAX package's): iterative rounds attach rootless
// strands to scalp-rooted ones with progressively relaxed distance/angle
// thresholds; grafted prefixes are occupancy-validated with jitter retries.
//
// Structure choices vs the Python:
// - the per-round scipy cKDTree over all core points becomes a uniform grid
//   hash (cell = thr_dist); neighbor point indices are returned ascending,
//   matching the ball-query contract;
// - per-strand nearest-point queries are brute force (strands are <= a few
//   hundred points — a tree would be slower than the SIMD loop);
// - RNG is an xorshift; the Python uses numpy Generator. Jitter draws are
//   not bit-matched (they only fire on failed occupancy validation).
// - pending strands within a round are INDEPENDENT (the core set and every
//   value they read — strands[nj], out_ratio[nj], root_flag — is snapshotted
//   before the round; each iteration writes only its own strand's state), so
//   the round loop runs under OpenMP. Jitter RNG is seeded per (strand,
//   round) so results are deterministic under any thread schedule and
//   identical to the serial build. (This bench host has 1 core — the win
//   shows on multi-core deployment hosts; OMP_NUM_THREADS governs.)
//
// Exported C ABI (ctypes): cts_run / cts_fetch / cts_free.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <unordered_map>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct V3 { double x, y, z; };

static inline V3 operator-(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator+(const V3& a, const V3& b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator*(const V3& a, double s) { return {a.x * s, a.y * s, a.z * s}; }
static inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline double norm(const V3& a) { return std::sqrt(dot(a, a)); }
static inline double dist2(const V3& a, const V3& b) { V3 d = a - b; return dot(d, d); }

// compute_similar: cosine with the reference's 1e-4 denominator floor
// (Utils.py compute_similar — voxel-scale vectors).
static inline double similar(const V3& a, const V3& b) {
    double den = norm(a) * norm(b);
    return dot(a, b) / std::max(den, 1e-4);
}

struct Rng {  // xorshift128+, uniform double in [0, 1)
    uint64_t s0, s1;
    explicit Rng(uint64_t seed) {
        s0 = seed ^ 0x9E3779B97F4A7C15ull; s1 = (seed << 1) | 1;
        for (int i = 0; i < 8; i++) next();
    }
    uint64_t next() {
        uint64_t a = s0, b = s1;
        s0 = b;
        a ^= a << 23;
        s1 = a ^ b ^ (a >> 18) ^ (b >> 5);
        return s1 + b;
    }
    double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

struct Strand {
    std::vector<V3> pts;
};

struct OccGrids {
    const float* occ;
    const float* ori;  // (R0, R1, R2, 3)
    int64_t r0, r1, r2;
};

// strand_occupancy_stats (PMVO_utils.py:596-616): in-ratio, |cos| similarity
// against the ori grid, and bounds flag, over the first `plen` points.
static void occupancy_stats(const OccGrids& g, const std::vector<V3>& s,
                            size_t plen, double* in_ratio, double* sim_score,
                            bool* in_bounds) {
    plen = std::min(plen, s.size());
    double occ_sum = 0.0, sim_sum = 0.0;
    bool ok = true;
    for (size_t i = 0; i < plen; i++) {
        // np.round is half-to-even; nearbyint under the default FE_TONEAREST
        // matches it (llround is half-away-from-zero and diverges on exact .5
        // coordinates, which integer-grid strands do produce).
        int64_t ix = (int64_t)std::nearbyint(s[i].x);
        int64_t iy = (int64_t)std::nearbyint(s[i].y);
        int64_t iz = (int64_t)std::nearbyint(s[i].z);
        if (ix < 0 || iy < 0 || iz < 0 || ix >= g.r0 || iy >= g.r1 || iz >= g.r2) {
            ok = false;
            ix = std::min(std::max(ix, (int64_t)0), g.r0 - 1);
            iy = std::min(std::max(iy, (int64_t)0), g.r1 - 1);
            iz = std::min(std::max(iz, (int64_t)0), g.r2 - 1);
        }
        int64_t lin = (ix * g.r1 + iy) * g.r2 + iz;
        occ_sum += g.occ[lin];
        // direction: forward diff, last point repeats the previous diff
        V3 d = (plen >= 2) ? ((i + 1 < plen) ? s[i + 1] - s[i]
                                             : s[plen - 1] - s[plen - 2])
                           : V3{0, 0, 0};
        V3 o = {g.ori[lin * 3], g.ori[lin * 3 + 1], g.ori[lin * 3 + 2]};
        sim_sum += std::fabs(similar(o, d));
    }
    *in_ratio = occ_sum / std::max((double)plen, 1.0);
    *sim_score = sim_sum / std::max(occ_sum, 1e-6);
    *in_bounds = ok;
}

// nearest point of `s` to q: returns index, writes squared distance
static size_t nearest(const std::vector<V3>& s, const V3& q, double* d2_out) {
    size_t best = 0;
    double bd = 1e300;
    for (size_t i = 0; i < s.size(); i++) {
        double d2 = dist2(s[i], q);
        if (d2 < bd) { bd = d2; best = i; }
    }
    *d2_out = bd;
    return best;
}

struct Result {
    std::vector<double> points;   // flattened kept strands
    std::vector<int64_t> offsets; // kept+1
    std::vector<uint8_t> attached;  // per kept strand: 1 root_flag, 0 out_flag
    int64_t n_kept;
};

// _translate_join(mid, reverse(ss[0..p]))[::-1] + [mid] + strand
// (HairGrow.py:353-381 weight=0 path as staged in connect.py:329-334)
static std::vector<V3> graft(const std::vector<V3>& core, size_t p,
                             const std::vector<V3>& strand) {
    V3 mid = strand[0] * 0.95 + core[p] * 0.05;
    // A = reverse(core[0..p]); walk = mid + cumsum(diff(A)); prefix = reverse(walk)
    std::vector<V3> walk(p);
    V3 acc = mid;
    for (size_t k = 0; k < p; k++) {
        // A[k+1] - A[k] = core[p-1-k] - core[p-k]
        acc = acc + (core[p - 1 - k] - core[p - k]);
        walk[k] = acc;
    }
    std::vector<V3> out;
    out.reserve(p + 1 + strand.size());
    for (size_t k = 0; k < p; k++) out.push_back(walk[p - 1 - k]);
    out.push_back(mid);
    for (const V3& q : strand) out.push_back(q);
    return out;
}

}  // namespace

extern "C" {

void* cts_run(const double* points, const int64_t* offsets, int64_t n_strands,
              int64_t num_root, const float* occ, const float* ori,
              int64_t r0, int64_t r1, int64_t r2,
              double out_ratio_threshold, double thr_dist, double thr_dot,
              double max_thr_dist, double min_thr_dot, int64_t jitter_retries,
              uint64_t seed, int64_t* out_n_strands, int64_t* out_n_points) {
    OccGrids g{occ, ori, r0, r1, r2};
    uint64_t round_no = 0;

    std::vector<Strand> strands(n_strands);
    for (int64_t i = 0; i < n_strands; i++) {
        int64_t beg = offsets[i], end = offsets[i + 1];
        strands[i].pts.resize(end - beg);
        for (int64_t k = beg; k < end; k++)
            strands[i].pts[k - beg] = {points[k * 3], points[k * 3 + 1],
                                       points[k * 3 + 2]};
    }
    std::vector<uint8_t> root_flag(n_strands, 0), out_root_flag(n_strands, 0);
    for (int64_t i = 0; i < std::min(num_root, n_strands); i++) root_flag[i] = 1;
    std::vector<double> out_ratio(n_strands, 0.0);

    int64_t progress_quota = std::max((n_strands - num_root) / 500, (int64_t)0);

    while (true) {
        int64_t num_good = 0;
        for (int64_t i = 0; i < n_strands; i++) num_good += root_flag[i];
        // core points: every point of every good strand, in strand order —
        // point indices are ascending, matching the Python concatenation
        std::vector<V3> core_pts;
        std::vector<int32_t> core_info;
        for (int64_t i = 0; i < n_strands; i++) {
            if (!root_flag[i]) continue;
            for (const V3& q : strands[i].pts) {
                core_pts.push_back(q);
                core_info.push_back((int32_t)i);
            }
        }
        if (core_pts.empty()) break;

        std::vector<int64_t> pending;
        for (int64_t i = 0; i < n_strands; i++)
            if (!root_flag[i] && !out_root_flag[i]) pending.push_back(i);
        if (pending.empty()) break;

        // uniform grid hash over core points, cell = thr_dist
        double cell = thr_dist;
        auto key_of = [&](const V3& q) -> uint64_t {
            int64_t cx = (int64_t)std::floor(q.x / cell);
            int64_t cy = (int64_t)std::floor(q.y / cell);
            int64_t cz = (int64_t)std::floor(q.z / cell);
            return ((uint64_t)(cx & 0x1FFFFF) << 42) |
                   ((uint64_t)(cy & 0x1FFFFF) << 21) |
                   (uint64_t)(cz & 0x1FFFFF);
        };
        std::unordered_map<uint64_t, std::vector<int32_t>> grid;
        grid.reserve(core_pts.size() / 4 + 16);
        for (size_t k = 0; k < core_pts.size(); k++)
            grid[key_of(core_pts[k])].push_back((int32_t)k);

        double thr2 = thr_dist * thr_dist;
        // distinct neighbor strand ids; core points are concatenated in
        // ascending strand order, so "ascending point index" (the Python's
        // ball-query order) collapses to "ascending strand id" — dedupe with
        // an O(1) flag array instead of sorting thousands of point indices.
        // One scratch pair per thread (allocated once per round).
        int nthreads = 1;
#ifdef _OPENMP
        nthreads = omp_get_max_threads();
#endif
        std::vector<std::vector<int32_t>> nei_buf(nthreads);
        std::vector<std::vector<uint8_t>> seen_buf(
            nthreads, std::vector<uint8_t>(n_strands, 0));

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
        for (int64_t pi = 0; pi < (int64_t)pending.size(); pi++) {
            int64_t i = pending[pi];
            int tid = 0;
#ifdef _OPENMP
            tid = omp_get_thread_num();
#endif
            std::vector<int32_t>& nei_sids = nei_buf[tid];
            std::vector<uint8_t>& sid_seen = seen_buf[tid];
            std::vector<V3>& strand = strands[i].pts;
            // <2-point strands stay pending forever and are dropped from the
            // output, matching the Python path (which never attaches them).
            if (strand.size() < 2) continue;
            const V3 root = strand[0];

            nei_sids.clear();
            for (int dx = -1; dx <= 1; dx++)
                for (int dy = -1; dy <= 1; dy++)
                    for (int dz = -1; dz <= 1; dz++) {
                        V3 q = {root.x + dx * cell, root.y + dy * cell,
                                root.z + dz * cell};
                        auto it = grid.find(key_of(q));
                        if (it == grid.end()) continue;
                        for (int32_t k : it->second)
                            if (dist2(core_pts[k], root) <= thr2) {
                                int32_t sid = core_info[k];
                                if (!sid_seen[sid]) {
                                    sid_seen[sid] = 1;
                                    nei_sids.push_back(sid);
                                }
                            }
                    }
            for (int32_t sid : nei_sids) sid_seen[sid] = 0;
            if (nei_sids.empty()) continue;
            std::sort(nei_sids.begin(), nei_sids.end());
            if (nei_sids.size() > 30) nei_sids.resize(31);

            // orient root-first against the first neighbor's strand
            {
                int32_t closest = nei_sids[0];
                const std::vector<V3>& ss = strands[closest].pts;
                if (ss.size() >= 2) {
                    double dsum = 0.0, d2;
                    size_t ib = 0, ie = 0;
                    for (size_t k = 0; k < strand.size(); k++) {
                        size_t ni = nearest(ss, strand[k], &d2);
                        if (k == 0) ib = ni;
                        ie = ni;
                        dsum += std::sqrt(d2);
                    }
                    V3 t1 = (ib == ss.size() - 1)
                                ? ss[ib] - ss[ib - 1]
                                : ss[std::min(ib + 1, ss.size() - 1)] - ss[ib];
                    V3 t2 = strand[1] - strand[0];
                    if (similar(t1, t2) < 0 && ib > ie &&
                        dsum / strand.size() < 5.0)
                        std::reverse(strand.begin(), strand.end());
                }
            }

            const V3 tan = strand[1] - strand[0];
            double best_loss = 1e300;
            int64_t best_j = -1;
            size_t best_pt = 0;
            size_t n_cand = std::min(nei_sids.size(), (size_t)30);
            for (size_t si = 0; si < n_cand; si++) {
                int32_t nj = nei_sids[si];
                const std::vector<V3>& s_n = strands[nj].pts;
                if (s_n.size() < 2) continue;
                // one pass over s_n finds the nearest point to strand[0] and
                // the 5 head-point distances (6 separate scans would walk the
                // strand 6x through cache)
                size_t n5 = std::min((size_t)5, strand.size());
                double best5[5] = {1e300, 1e300, 1e300, 1e300, 1e300};
                double d2 = 1e300;
                size_t pt_idx = 0;
                for (size_t m = 0; m < s_n.size(); m++) {
                    double dq0 = dist2(s_n[m], strand[0]);
                    if (dq0 < d2) { d2 = dq0; pt_idx = m; }
                    if (dq0 < best5[0]) best5[0] = dq0;
                    for (size_t q = 1; q < n5; q++) {
                        double dq = dist2(s_n[m], strand[q]);
                        if (dq < best5[q]) best5[q] = dq;
                    }
                }
                double d5 = 0.0;
                for (size_t q = 0; q < n5; q++) d5 += std::sqrt(best5[q]);
                if (d5 / n5 < 1.0) continue;  // already hugs a good strand
                if (strand.size() > 60 && strand.size() + pt_idx > 150) continue;
                if (pt_idx <= 1) continue;
                V3 nei_ori = s_n[pt_idx] - s_n[pt_idx - 1];
                double d = std::sqrt(d2);
                double dd = norm(s_n[pt_idx] - strand[0]);
                (void)d;
                if (similar(nei_ori, tan) > thr_dot && dd < thr_dist) {
                    double conn_dir = similar(strand[0] - s_n[pt_idx], tan);
                    double loss = (1.0 - conn_dir) + 0.1 * thr_dist + out_ratio[nj];
                    if (loss < best_loss) {
                        best_loss = loss; best_j = nj; best_pt = pt_idx;
                    }
                }
            }
            if (best_j < 0 || best_pt <= 1) continue;

            std::vector<V3> joined = graft(strands[best_j].pts, best_pt, strand);
            size_t plen = best_pt + 2;
            double in_ratio, sim; bool in_bounds;
            occupancy_stats(g, joined, plen, &in_ratio, &sim, &in_bounds);
            bool ok = in_bounds && in_ratio > out_ratio_threshold && sim > 0.3;
            if (!ok && in_bounds) {
                // per-(strand, round) stream: thread-schedule independent
                Rng rng(seed ^ (0x9E3779B97F4A7C15ull * (uint64_t)(i + 1))
                             ^ (round_no << 32));
                for (int64_t t = 0; t < jitter_retries; t++) {
                    V3 jit = {rng.uniform() * 0.5, rng.uniform() * 0.5,
                              rng.uniform() * 0.5};
                    std::vector<V3> cand = joined;
                    for (V3& q : cand) q = q + jit;
                    double r2_, s2_; bool b2_;
                    occupancy_stats(g, cand, plen, &r2_, &s2_, &b2_);
                    if (b2_ && r2_ > out_ratio_threshold && s2_ > 0.3) {
                        joined = std::move(cand);
                        in_ratio = r2_;
                        ok = true;
                        break;
                    }
                }
            }
            out_ratio[i] = 1.0 - in_ratio;
            strands[i].pts = std::move(joined);
            if (ok) root_flag[i] = 1; else out_root_flag[i] = 1;
        }

        round_no++;
        int64_t new_good = 0;
        for (int64_t i = 0; i < n_strands; i++) new_good += root_flag[i];
        if (new_good - num_good > progress_quota) continue;
        if (thr_dist >= max_thr_dist && thr_dot <= min_thr_dot) break;
        thr_dist = std::min(thr_dist + 0.25, max_thr_dist);
        thr_dot = std::max(thr_dot - 0.075, min_thr_dot);
    }

    Result* res = new Result();
    res->offsets.push_back(0);
    for (int64_t i = 0; i < n_strands; i++) {
        if (!root_flag[i] && !out_root_flag[i]) continue;
        for (const V3& q : strands[i].pts) {
            res->points.push_back(q.x);
            res->points.push_back(q.y);
            res->points.push_back(q.z);
        }
        res->offsets.push_back((int64_t)(res->points.size() / 3));
        res->attached.push_back(root_flag[i]);
    }
    res->n_kept = (int64_t)res->attached.size();
    *out_n_strands = res->n_kept;
    *out_n_points = (int64_t)(res->points.size() / 3);
    return res;
}

void cts_fetch(void* handle, double* points, int64_t* offsets, uint8_t* attached) {
    Result* res = (Result*)handle;
    std::memcpy(points, res->points.data(), res->points.size() * sizeof(double));
    std::memcpy(offsets, res->offsets.data(),
                res->offsets.size() * sizeof(int64_t));
    std::memcpy(attached, res->attached.data(), res->attached.size());
}

void cts_free(void* handle) { delete (Result*)handle; }

}  // extern "C"
