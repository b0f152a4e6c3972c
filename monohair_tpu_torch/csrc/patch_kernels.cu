// Hand-written Hopper (sm_90a) kernels for the PMVO line search.
//
// Built by monohair_tpu_torch/ops/_build.py with plain nvcc into a shared
// library with a C interface, loaded with ctypes (no PyTorch headers). Each
// entry point takes raw device pointers, sizes and a cudaStream_t, launches on
// that stream, does not synchronise and returns cudaGetLastError().
//
// patch_gather is the simple, correct first form; patch_min_loss is designed
// for the instruction stream that bounds it. Their times on the card beside
// their bounds are recorded in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// ---------------------------------------------------------------------------
// patch_gather
//
// Replaces the TPU kernel patch_gather_dma (monohair_tpu/ops/pallas_kernels.py,
// body _gather_kernel): for each view v and point n, copy the patch x patch
// window whose top-left corner in the edge-padded map is rc[v, n] (the clamped
// centre in unpadded coordinates) out of an 8-channel packed map.
//
// padded: (V, Hp, Wp, 8) f32 (bf16 below), rc: (V, N, 2) int32 (row, col),
// out: (V, N, patch*patch, 8) f32, taps in row-major offset order.
//
// One thread per (v, n, tap); the 8 channels are one 32-byte pixel, moved as
// two float4 loads and two float4 stores. A pure copy, so bit-exact.
// Bound on the H100: bytes. At full width (V=16, N=8192, patch 7) it writes
// about 205 MB per chunk; the TPU version's aligned DMA spans and one-hot MXU
// shifts have no counterpart here, a 32-byte pixel is already a full sector.
// The row/col are clamped into the padded map as a guard against a bad
// caller; the caller clamps centres, so the clamp never changes a result.
// ---------------------------------------------------------------------------
__global__ void patch_gather_kernel(const float4* __restrict__ padded,
                                    const int* __restrict__ rc,
                                    float4* __restrict__ out,
                                    int V, int N, int Hp, int Wp, int patch) {
  const int P = patch * patch;
  const int64_t total = (int64_t)V * N * P;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int tap = (int)(t % P);
  const int64_t vn = t / P;
  const int v = (int)(vn / N);
  int row = rc[2 * vn] + tap / patch;
  int col = rc[2 * vn + 1] + tap % patch;
  row = min(max(row, 0), Hp - 1);
  col = min(max(col, 0), Wp - 1);
  const int64_t src = (((int64_t)v * Hp + row) * Wp + col) * 2;
  const float4 a = padded[src];
  const float4 b = padded[src + 1];
  out[2 * t] = a;
  out[2 * t + 1] = b;
}

// The bf16 variant (PMVO.bf16_maps): the same windows of a (V, Hp, Wp, 8)
// bf16 map, written as f32, which fuses the .astype(float32) that follows
// the TPU kernel's gather (monohair_tpu/pmvo/solver.py observe_points). A
// pixel's 8 __nv_bfloat16 channels are one 16-byte uint4 load, half the f32
// kernel's reads; its writes are the same two float4 stores. bf16 -> f32 puts
// the 16 bits above 16 zero bits, which is exact, so the result equals the
// plain version's gather-then-.float() bit for bit.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__global__ void patch_gather_bf16_kernel(const uint4* __restrict__ padded,
                                         const int* __restrict__ rc,
                                         float4* __restrict__ out,
                                         int V, int N, int Hp, int Wp, int patch) {
  const int P = patch * patch;
  const int64_t total = (int64_t)V * N * P;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int tap = (int)(t % P);
  const int64_t vn = t / P;
  const int v = (int)(vn / N);
  int row = rc[2 * vn] + tap / patch;
  int col = rc[2 * vn + 1] + tap % patch;
  row = min(max(row, 0), Hp - 1);
  col = min(max(col, 0), Wp - 1);
  const uint4 w = padded[((int64_t)v * Hp + row) * Wp + col];
  out[2 * t] = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
  out[2 * t + 1] = make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
}

// ---------------------------------------------------------------------------
// patch_min_loss
//
// Replaces the TPU kernel patch_min_loss_fused (monohair_tpu/ops/
// pallas_kernels.py, body _kernel): for each (point n, depth sample s), loop
// over views v and stream over the P patch taps with
//     loss = 1 - |o . d| / max(|o| |d|, 1e-8)
// keeping the min-loss tap (strict <, so the earlier tap wins a tie). When any
// tap of (v, n) has conf > thr, only such taps may replace the running best.
// weight = best_conf * [visible != -1]; the outputs are sum_v weight*min_loss,
// sum_v weight and #(weight > 0), each (N, S), summed in f32 in view order.
//
// prj: (V, N, S, 2), ori: (V, N, P, 2), conf: (V, N, P), vis: (V, N), all f32.
//
// Bound on the H100: operations, about 9 f32 operations per (v, n, s, tap)
// against about 180 MB of traffic at V=16, N=8192, S=90, P=49. What limits the
// kernel is its instruction stream, so the design cuts instructions per step:
// - Per-window work once. A warp owns G points (one contiguous run of G*P taps
//   in ori[v] and conf[v]) and stages their windows into shared memory, one
//   view at a time, as one float4 {o.x, o.y, |o|, conf} per tap: |o| (an IEEE
//   square root), the window's high-confidence flag and the marks of taps that
//   cannot win (o = (0, 0), or o equal to the previous tap's) are computed once
//   per (v, n, p), not once per sample. The staging is not double-buffered:
//   one warp's copy is hidden behind the tap loops of the SM's other warps.
// - Thread mapping. S > 16 (the line search, S = 90): one point per warp, lane
//   l owns samples l, l+32, l+64 (R = 3), so one broadcast LDS.128 of a tap
//   serves three samples, no warp straddles two points, and a tap that cannot
//   be taken is skipped by the whole warp at once. S <= 16 (the refine pass,
//   S = 1): up to 16 points per warp, L >= S lanes each; the windows sit P|1
//   float4s apart, which keeps the lanes' LDS.128s free of bank conflicts.
//   Both mappings run the same device function, tap_loop.
// - The IEEE divide only on near ties. With a = |o.d| and b = max(|o||d|, 1e-8)
//   as rounded f32 values, x = fl(a_p * b_b), y = fl(a_b * b_p):
//   * x < y: rounding is monotone, so a_p * b_b < a_b * b_p exactly, the tap's
//     quotient is below the best's and its rounded loss is no smaller: skip.
//   * fl(fl(a_p - 2^-20 b_p) * b_b) > y: each rounding moves a value by at most
//     2^-24 of it and a <= b (1 + 2^-21), so a_p / b_p - a_b / b_b > 2^-21, more
//     than the roundings of the quotients and of 1 - q can close: take.
//   * otherwise (near ties, NaN): divide both and compare the rounded losses,
//     unless (a, b) equals the best's, whose loss is then the same.
//   The best tap's loss is divided out once per (v, n, s), at the end.
// Every product, sum, quotient and root that decides a result uses the
// round-to-nearest intrinsics or IEEE sqrtf (no multiply-add contraction, no
// flush to zero), so each tap's loss is bitwise the one the plain PyTorch
// version computes, and near ties between taps resolve the same way in both.
// ---------------------------------------------------------------------------
constexpr int kMaxWarpsPerBlock = 4;
// Six blocks of four warps an SM caps a thread at 80 registers; with that cap
// ptxas keeps every value in registers (no spills) and the line search's tap
// loop measured fastest among the caps tried (PERF.md).
constexpr int kMinBlocksPerSM = 6;
constexpr int kSmemDefault = 48 * 1024;   // dynamic shared memory a block gets unasked
constexpr int kStageBatch = 4;          // window loads in flight per lane
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMargin = 9.5367431640625e-07f;   // 2^-20

__device__ __forceinline__ float2 nan2() {
  return make_float2(__int_as_float(0x7fffffff), __int_as_float(0x7fffffff));
}

// One depth sample of one view: its direction d and |d|.
struct Sample {
  float x, y, norm;
};

// 1 - fl(a / b), rounded as the plain version rounds it.
__device__ __forceinline__ float tap_loss(float a, float b) {
  return __fsub_rn(1.0f, __fdiv_rn(a, b));
}

// Min-loss tap of one staged window {o.x, o.y, |o|, conf} for the R samples of
// one thread. A negative |o| marks a tap whose o is (0, 0), which cannot win
// (its loss is 1 or NaN), or equals the previous tap's, which cannot win when
// that tap was compared. The best tap is held as a_b = |o.d| and
// b_b = max(|o||d|, 1e-8); its loss is divided out once, at the end.
template <int R>
__device__ __forceinline__ void tap_loop(const float4* __restrict__ win, int P,
                                         float thr, bool high_conf, const Sample (&d)[R],
                                         float (&loss_b)[R], float (&conf_b)[R]) {
  float a_b[R], b_b[R];
  const float4 t0 = win[0];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a_b[r] = fabsf(__fadd_rn(__fmul_rn(t0.x, d[r].x), __fmul_rn(t0.y, d[r].y)));
    b_b[r] = fmaxf(__fmul_rn(t0.z, d[r].norm), 1e-8f);
    conf_b[r] = t0.w;
  }
  bool compared = true;   // tap p - 1 was compared with the best
  for (int p = 1; p < P; ++p) {
    const float4 t = win[p];
    const bool eligible = !high_conf || t.w > thr;
    const bool skip = !eligible || (signbit(t.z) && (t.z == 0.0f || compared));
    compared = eligible;
    if (skip) continue;   // uniform for G = 1
    float a[R], b[R];
    bool exact[R], any_exact = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[r] = fabsf(__fadd_rn(__fmul_rn(t.x, d[r].x), __fmul_rn(t.y, d[r].y)));
      b[r] = fmaxf(__fmul_rn(fabsf(t.z), d[r].norm), 1e-8f);
      const float x = __fmul_rn(a[r], b_b[r]), y = __fmul_rn(a_b[r], b[r]);
      const bool take = __fmul_rn(fmaf(-kMargin, b[r], a[r]), b_b[r]) > y;
      exact[r] = !take && !(x < y);
      any_exact |= exact[r];
      if (take) {
        a_b[r] = a[r];
        b_b[r] = b[r];
        conf_b[r] = t.w;
      }
    }
    if (any_exact) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (exact[r] && !(a[r] == a_b[r] && b[r] == b_b[r]) &&
            tap_loss(a[r], b[r]) < tap_loss(a_b[r], b_b[r])) {
          a_b[r] = a[r];
          b_b[r] = b[r];
          conf_b[r] = t.w;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) loss_b[r] = tap_loss(a_b[r], b_b[r]);
}

// A warp owns G consecutive points (L = 32 / G lanes each) and one chunk of
// L * R samples of them; lane (g, j) owns samples chunk * L * R + j + L * r.
// Lanes past the last point or sample repeat the last one and store nothing.
// Counts: for V <= 1023 (kWide false) the R counts of a thread are packed
// 10 bits each into one register; beyond that (kWide true) each has its own.
template <int R, bool kWide>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32, kMinBlocksPerSM)
patch_min_loss_kernel(const float2* __restrict__ prj, const float2* __restrict__ ori,
                      const float* __restrict__ conf, const float* __restrict__ vis,
                      float thr, float* __restrict__ num, float* __restrict__ den,
                      float* __restrict__ cnt, int V, int N, int S, int P, int G,
                      int chunks) {
  extern __shared__ float4 smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t wid = (int64_t)blockIdx.x * warps + warp;
  if (wid >= (int64_t)((N + G - 1) / G) * chunks) return;   // whole warps
  const int L = 32 / G, stride = P | 1;
  float4* win = smem + warp * G * stride;
  int* flag = reinterpret_cast<int*>(smem + warps * G * stride) + warp * G;

  const int chunk = (int)(wid % chunks);
  const int n0 = (int)(wid / chunks) * G;
  const int points = min(G, N - n0);
  const int g = min(lane / L, points - 1);
  const bool point_stored = lane / L < points;
  const int s0 = chunk * L * R + lane % L;   // sample r is s0 + L * r

  if (lane < G) flag[lane] = 0;
  float acc_num[R], acc_den[R];
  unsigned acc_cnt = 0;   // #(weight > 0) of sample r in bits 10r .. 10r + 9
  unsigned wide_cnt[kWide ? R : 1];
#pragma unroll
  for (int r = 0; r < R; ++r) acc_num[r] = acc_den[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < (kWide ? R : 1); ++r) wide_cnt[r] = 0;

  for (int v = 0; v < V; ++v) {
    const int64_t vn0 = (int64_t)v * N + n0;
    Sample d[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 dr = prj[(vn0 + g) * S + min(s0 + L * r, S - 1)];
      d[r] = Sample{dr.x, dr.y,
                    sqrtf(__fadd_rn(__fmul_rn(dr.x, dr.x), __fmul_rn(dr.y, dr.y)))};
    }
    const float vis_v = vis[vn0 + g];

    __syncwarp();                   // every lane is done with the last view
    const float2* o = ori + vn0 * P;
    const float* c = conf + vn0 * P;
    const int taps = points * P;
    int ge = lane / P, pe = lane % P;   // tap e = ge * P + pe of the run
    float2 last = nan2();   // tap e0 - 1, from lane 31
    for (int e0 = 0; e0 < taps; e0 += 32 * kStageBatch) {
      float2 op[kStageBatch];
      float cp[kStageBatch];
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const bool in = e0 + lane + 32 * k < taps;
        op[k] = in ? o[e0 + lane + 32 * k] : nan2();
        cp[k] = in ? c[e0 + lane + 32 * k] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        float2 prev = make_float2(__shfl_up_sync(kFullMask, op[k].x, 1),
                                  __shfl_up_sync(kFullMask, op[k].y, 1));
        if (lane == 0) prev = last;
        last = make_float2(__shfl_sync(kFullMask, op[k].x, 31),
                           __shfl_sync(kFullMask, op[k].y, 31));
        if (e0 + lane + 32 * k < taps) {
          const float onorm =
              sqrtf(__fadd_rn(__fmul_rn(op[k].x, op[k].x), __fmul_rn(op[k].y, op[k].y)));
          const bool zero = op[k].x == 0.0f && op[k].y == 0.0f;
          const bool repeat = op[k].x == prev.x && op[k].y == prev.y;
          win[ge * stride + pe] =
              make_float4(op[k].x, op[k].y, pe > 0 && (zero || repeat) ? -onorm : onorm, cp[k]);
          if (cp[k] > thr) flag[ge] = v + 1;  // the window of ge is high-confidence
        }
        for (pe += 32; pe >= P; pe -= P) ++ge;
      }
    }
    __syncwarp();

    float loss_b[R], conf_b[R];
    tap_loop<R>(win + g * stride, P, thr, flag[g] == v + 1, d, loss_b, conf_b);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w = (vis_v == -1.0f) ? 0.0f : conf_b[r];
      acc_num[r] = __fadd_rn(acc_num[r], __fmul_rn(w, loss_b[r]));
      acc_den[r] = __fadd_rn(acc_den[r], w);
      if (kWide)
        wide_cnt[kWide ? r : 0] += (w > 0.0f) ? 1u : 0u;
      else
        acc_cnt += (w > 0.0f) ? 1u << (10 * r) : 0u;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!point_stored || s0 + L * r >= S) continue;
    const int64_t i = (int64_t)(n0 + g) * S + s0 + L * r;
    num[i] = acc_num[r];
    den[i] = acc_den[r];
    cnt[i] = kWide ? (float)wide_cnt[kWide ? r : 0] : (float)((acc_cnt >> (10 * r)) & 1023u);
  }
}

// One instantiation of the tap-loop kernel: a launch that needs more than the
// default 48 KB of dynamic shared memory first raises the kernel's limit to it.
template <int R, bool kWide>
static int launch_min_loss(unsigned blocks, dim3 block, size_t smem, cudaStream_t st,
                           const void* prj, const void* ori, const void* conf,
                           const void* vis, float thr, void* num, void* den, void* cnt,
                           int V, int N, int S, int P, int G, int chunks) {
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        patch_min_loss_kernel<R, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  patch_min_loss_kernel<R, kWide><<<blocks, block, smem, st>>>(
      (const float2*)prj, (const float2*)ori, (const float*)conf, (const float*)vis, thr,
      (float*)num, (float*)den, (float*)cnt, V, N, S, P, G, chunks);
  return (int)cudaGetLastError();
}

extern "C" {

int patch_gather(const void* padded, const void* rc, void* out, int V, int N,
                 int Hp, int Wp, int patch, void* stream) {
  const int64_t total = (int64_t)V * N * patch * patch;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  patch_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)padded, (const int*)rc, (float4*)out, V, N, Hp, Wp, patch);
  return (int)cudaGetLastError();
}

int patch_gather_bf16(const void* padded, const void* rc, void* out, int V, int N,
                      int Hp, int Wp, int patch, void* stream) {
  const int64_t total = (int64_t)V * N * patch * patch;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  patch_gather_bf16_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)padded, (const int*)rc, (float4*)out, V, N, Hp, Wp, patch);
  return (int)cudaGetLastError();
}

int patch_min_loss(const void* prj, const void* ori, const void* conf,
                   const void* vis, float thr, void* num, void* den, void* cnt,
                   int V, int N, int S, int P, void* stream) {
  if ((int64_t)N * S == 0) return (int)cudaGetLastError();
  if (V > (1 << 24)) return (int)cudaErrorInvalidValue;   // counts exact in f32
  // S > 16: one point per warp, R = 3 samples per lane (R = 1 for S <= 32).
  // S <= 16: L >= S lanes per point, at most 16 points per warp: the windows
  // of 32 points (25 KB at P = 49) leave too few warps on an SM to hide the
  // staging's latency.
  int G = 1, R = S <= 32 ? 1 : 3;
  if (S <= 16) {
    int L = 1;
    while (L < S) L *= 2;
    G = std::min(16, 32 / L);
  }
  // a warp's windows and flags; up to 4 warps a block within the default
  // 48 KB, or, for windows that need more (the refine pass at patch >= 15),
  // within what the card lets a block opt in to (227 KB on the H100)
  int dev = 0, optin = kSmemDefault;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t per_warp = (size_t)G * ((P | 1) * sizeof(float4) + sizeof(int));
  const size_t budget = per_warp > (size_t)kSmemDefault ? (size_t)optin : kSmemDefault;
  if (per_warp > budget) return (int)cudaErrorInvalidValue;
  const int wpb = (int)std::min<size_t>(kMaxWarpsPerBlock, budget / per_warp);
  const size_t smem = wpb * per_warp;
  const int chunks = (S + 32 / G * R - 1) / (32 / G * R);
  const int64_t warps = (int64_t)((N + G - 1) / G) * chunks;
  const unsigned blocks = (unsigned)((warps + wpb - 1) / wpb);
  const dim3 block(wpb * 32);
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = V > 1023;   // 10-bit packed counts up to 1023 views
  if (R == 1)
    return wide ? launch_min_loss<1, true>(blocks, block, smem, st, prj, ori, conf, vis, thr,
                                           num, den, cnt, V, N, S, P, G, chunks)
                : launch_min_loss<1, false>(blocks, block, smem, st, prj, ori, conf, vis,
                                            thr, num, den, cnt, V, N, S, P, G, chunks);
  return wide ? launch_min_loss<3, true>(blocks, block, smem, st, prj, ori, conf, vis, thr,
                                         num, den, cnt, V, N, S, P, G, chunks)
              : launch_min_loss<3, false>(blocks, block, smem, st, prj, ori, conf, vis, thr,
                                          num, den, cnt, V, N, S, P, G, chunks);
}

}  // extern "C"
