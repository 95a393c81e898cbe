// Multilevel RoIAlign: every RoI pooled to (7, 7, C) from its own FPN level.
//
// Replaces the Pallas kernel `_windowed_kernel`
// (panoswintransformerobjectdetection_tpu/ops/roi_align_pallas.py:205) and,
// on the detector's path, the dense overflow pass and fallback around it
// (ops/roi_align.py:256-329).  The TPU needed a fixed (32, 40) window per
// RoI, an eligibility test and a fallback because it cannot gather; here
// each block reads the few feature rows and columns its RoI's taps name, so
// one kernel covers every RoI.
//
// Semantics (ops/roi_align.py:36-80, 550-590): level = clamp(floor(log2(
// sqrt(area) / 56 + 1e-6)), 0, L-1); aligned=True (-0.5 pixel offset); a
// fixed 2x2 sample grid per bin; a sample outside (-1, size) reads 0, taps
// are clamped to [0, size-1].  The pooling is separable: per axis and bin,
// the weight of a column is (1/2) * the sum of its tap weights over the
// samples, rounded to the feature type.  Stage one contracts one axis with
// f32 accumulation and rounds to the feature type; stage two contracts the
// other.  Wide maps (sum of widths > sum of heights, the 2:1 pano case)
// contract W first, because the JAX wrapper transposes them.  The weight
// arithmetic uses non-contracting intrinsics so that it matches the plain
// PyTorch twin bit for bit.
//
// What bounds it on the H100: at the flagship's 2 x 1000 RoIs, C = 256 in
// bf16, the function must read the four level maps (about 45 MB) and write
// 50 MB, about 0.03 ms at 3.35 TB/s; its arithmetic (about 1 GFLOP) is far
// below the compute rates.  So it is bound by bytes.  This first version
// re-reads each RoI's taps from L1/L2 for every output bin (16 loads per
// output value) rather than staging them, which costs issue slots but no
// extra device-memory traffic beyond each RoI's footprint.  A large RoI's
// 784 taps are distinct pixels: 400 KB of L1/L2 reads a RoI at C = 256
// against 25 KB of output, so the gathers' rate, not device memory, is
// what the redesign has to raise.
//
// bfloat16 entry (`roi_align_bf16_launch`): vectorised gathers with
// stage-one reuse.  One block of 7 warps per (RoI, slice of 32 * VEC
// channels): its first 14 threads work out the RoI's level and taps into
// shared memory, as in the first version; then warp i takes bin i of the
// axis contracted first, and each lane VEC neighbouring channels, so that a
// warp reads one tap's 256 channels (VEC = 8) in one 16-byte load a lane
// and writes an output bin in one 16-byte store a lane.  VEC is the widest
// of 8, 4, 2 and 1 that divides C and to whose bytes every level and the
// output are aligned: narrower accesses, in the same entry, take any C.
// The warp walks the bins j of the other axis and their four candidate
// columns in order; a stage-one sum round(sum_k1 w1 f) depends only on (i,
// column), and a RoI's candidate columns come in non-decreasing order, so a
// column equal to the one before reuses its sum (kept in registers) and
// every distinct column is summed once a bin i.  A bin j's loads of the
// columns it has to sum are issued together, before any sum: behind a
// branch per column they ran 15% slower.  The additions keep the first
// version's order: k1 in order, rounded to bf16, then k2 in order, repeated
// columns included with their weight 0, so the result is the twin's bit for
// bit.  What holds it at about 4x its bound: a large RoI's 784 taps are
// distinct pixels, so it reads about 400 KB from L1/L2 for 25 KB of output
// (800 MB at the flagship's 2000 RoIs), and about as much time again goes
// to the scalar f32 arithmetic of the separable sums; a copy without the
// loads took 58% of the time.
//
// float32 entry (`roi_align_launch`), the first version, f32 and bf16: the
// wrapper calls it for float32; its bf16 instantiation is there so that
// `chip_smoke.py` times the redesign against it.  One block per (RoI,
// slice of 128 channels), one thread per channel, so every feature read is
// coalesced along C in the NHWC maps; after the taps each thread walks the
// 49 output bins with 16 scalar loads each.

// Backward (`roi_align_backward_kernel`): the function is linear in the
// maps, so the maps' gradient is the transposed gather, a scatter-add of
// grad_out[r, i, j, c] * w1 * w2 into the RoI's level.  Same blocks, same
// taps; every nonzero tap is one f32 `atomicAdd` into f32 gradient maps,
// which the wrapper zeroes before and casts to the feature type after.  As
// autograd through the twin does, it rounds the stage-one gradient w2 * d
// to the feature type.  RoIs overlap, so the atomics are needed, and their
// order changes the last bits of a sum from run to run.  It is bound by
// bytes (grad_out in, the level gradients out); the atomics' traffic in L2
// is what it really pays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int O = 7;        // output bins per side
constexpr int S = 2;        // samples per bin side
constexpr int K = 2 * S;    // candidate taps per bin
constexpr int MAX_LEVELS = 4;
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to the feature type and back.
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

}  // namespace

struct RoiLevels {
  const void* feat[MAX_LEVELS];   // (B, H, W, C) each
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
  float inv_stride[MAX_LEVELS];
  int num_levels;
};

namespace {

// Merged taps of one bin along one axis: for each of the K candidate
// columns, (1/S) * sum over samples of the tap weights landing on it,
// rounded to T; a repeated column gets weight 0 after its first occurrence.
template <typename T>
__device__ void axis_taps(float start, float bin, int size, int o, int* idx, float* w) {
  int col[K];
  float wt[K];
  const float sizef = float(size);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float off = (float(s) + 0.5f) / float(S);
    const float v = __fadd_rn(start, __fmul_rn(bin, float(o) + off));
    const float inside = (v > -1.f && v < sizef) ? 1.f : 0.f;
    const float vc = fminf(fmaxf(v, 0.f), sizef - 1.f);
    const float v0 = floorf(vc);
    const float v1 = fminf(v0 + 1.f, sizef - 1.f);
    const float frac = __fsub_rn(vc, v0);
    col[2 * s] = int(v0);
    col[2 * s + 1] = int(v1);
    wt[2 * s] = __fmul_rn(__fsub_rn(1.f, frac), inside);
    wt[2 * s + 1] = __fmul_rn(frac, inside);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = col[k];
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float a = __fadd_rn(col[2 * s] == c ? wt[2 * s] : 0.f,
                                col[2 * s + 1] == c ? wt[2 * s + 1] : 0.f);
      total = s == 0 ? a : __fadd_rn(total, a);
    }
    bool repeat = false;
#pragma unroll
    for (int j = 0; j < k; ++j) repeat = repeat || col[j] == c;
    idx[k] = c;
    w[k] = repeat ? 0.f : round_t<T>(__fdiv_rn(total, float(S)));
  }
}

// A RoI's level, image and merged taps, in shared memory.
struct RoiTaps {
  int idx[2][O][K];     // [axis][bin][tap]; axis 0 = y (rows), 1 = x (columns)
  float w[2][O][K];
  int level;
  int batch;            // -1: the index lies outside [0, batch), or is NaN
};

// Fills `taps` for the block's RoI with its first 14 threads and
// synchronises the block.
template <typename T>
__device__ void roi_taps(const RoiLevels& levels, const float* roi, int batch,
                         float finest_scale, RoiTaps& taps) {
  const int t = threadIdx.x;
  if (t < 2 * O) {
    const float x1 = roi[1], y1 = roi[2], x2 = roi[3], y2 = roi[4];
    const float wr = __fsub_rn(x2, x1), hr = __fsub_rn(y2, y1);
    const float scale = sqrtf(fmaxf(__fmul_rn(wr, hr), 0.f));
    int lvl = int(floorf(log2f(__fadd_rn(__fdiv_rn(scale, finest_scale), 1e-6f))));
    lvl = min(max(lvl, 0), levels.num_levels - 1);
    const float inv = levels.inv_stride[lvl];
    const int axis = t / O, o = t % O;
    const float lo = axis == 0 ? y1 : x1;
    const float extent = axis == 0 ? hr : wr;
    const float start = __fsub_rn(__fmul_rn(lo, inv), 0.5f);
    const float bin = __fdiv_rn(__fmul_rn(extent, inv), float(O));
    const int size = axis == 0 ? levels.height[lvl] : levels.width[lvl];
    axis_taps<T>(start, bin, size, o, taps.idx[axis][o], taps.w[axis][o]);
    if (t == 0) {
      // an index outside [0, batch), or NaN, pools zeros (as the twin does)
      const float b = roi[0];
      taps.level = lvl;
      taps.batch = (b >= 0.f && b < float(batch)) ? int(b) : -1;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void roi_align_kernel(RoiLevels levels, const float* __restrict__ rois,
                                 T* __restrict__ out, int batch, int C, int w_first,
                                 float finest_scale) {
  __shared__ RoiTaps taps;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  roi_taps<T>(levels, rois + size_t(r) * 5, batch, finest_scale, taps);
  auto& s_idx = taps.idx;
  auto& s_w = taps.w;
  const int s_level = taps.level, s_batch = taps.batch;

  const int c = blockIdx.y * THREADS + t;
  if (c >= C) return;
  if (s_batch < 0) {
    for (int q = 0; q < O * O; ++q) out[(size_t(r) * O * O + q) * C + c] = from_f<T>(0.f);
    return;
  }
  const int lvl = s_level;
  const int Hl = levels.height[lvl], Wl = levels.width[lvl];
  const T* f = static_cast<const T*>(levels.feat[lvl]) + size_t(s_batch) * Hl * Wl * C + c;
  // stage one runs over axis a1 for each bin i of a1, then stage two over
  // axis a2 for each bin j of a2
  const int a1 = w_first ? 1 : 0, a2 = 1 - a1;
  for (int i = 0; i < O; ++i) {
    for (int j = 0; j < O; ++j) {
      float acc2 = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < K; ++k2) {
        float acc1 = 0.f;
#pragma unroll
        for (int k1 = 0; k1 < K; ++k1) {
          const int i1 = s_idx[a1][i][k1], i2 = s_idx[a2][j][k2];
          const int row = w_first ? i2 : i1, col = w_first ? i1 : i2;
          const float p = __fmul_rn(s_w[a1][i][k1], to_f(f[(size_t(row) * Wl + col) * C]));
          acc1 = k1 == 0 ? p : __fadd_rn(acc1, p);
        }
        const float p2 = __fmul_rn(s_w[a2][j][k2], round_t<T>(acc1));
        acc2 = k2 == 0 ? p2 : __fadd_rn(acc2, p2);
      }
      const int oy = w_first ? j : i, ox = w_first ? i : j;
      out[((size_t(r) * O + oy) * O + ox) * C + c] = from_f<T>(acc2);
    }
  }
}

template <typename T>
__global__ void roi_align_backward_kernel(RoiLevels levels, const float* __restrict__ rois,
                                          const T* __restrict__ grad_out, int batch, int C,
                                          int w_first, float finest_scale) {
  __shared__ RoiTaps taps;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  roi_taps<T>(levels, rois + size_t(r) * 5, batch, finest_scale, taps);
  const int c = blockIdx.y * THREADS + t;
  if (c >= C || taps.batch < 0) return;
  const int lvl = taps.level;
  const int Hl = levels.height[lvl], Wl = levels.width[lvl];
  // levels.feat holds the f32 gradient maps here
  float* g = static_cast<float*>(const_cast<void*>(levels.feat[lvl])) +
             size_t(taps.batch) * Hl * Wl * C + c;
  const int a1 = w_first ? 1 : 0, a2 = 1 - a1;
  for (int i = 0; i < O; ++i) {
    for (int j = 0; j < O; ++j) {
      const int oy = w_first ? j : i, ox = w_first ? i : j;
      const float d = to_f(grad_out[((size_t(r) * O + oy) * O + ox) * C + c]);
#pragma unroll
      for (int k2 = 0; k2 < K; ++k2) {
        const float w2 = taps.w[a2][j][k2];
        if (w2 == 0.f) continue;
        const float dt = round_t<T>(__fmul_rn(w2, d));
#pragma unroll
        for (int k1 = 0; k1 < K; ++k1) {
          const float w1 = taps.w[a1][i][k1];
          if (w1 == 0.f) continue;
          const int i1 = taps.idx[a1][i][k1], i2 = taps.idx[a2][j][k2];
          const int row = w_first ? i2 : i1, col = w_first ? i1 : i2;
          atomicAdd(g + (size_t(row) * Wl + col) * C, __fmul_rn(w1, dt));
        }
      }
    }
  }
}

// ----------------------------------------------------------------- bfloat16

namespace vec {

constexpr int THREADS = 32 * O;         // a warp per stage-one bin
// Two blocks an SM: at most 146 registers a thread.  Left free, the 16
// chunks a lane has in flight took 154 registers, one block fit an SM and
// it ran 1.7x slower; capped for three blocks, it spilled and ran 2.8x
// slower.
constexpr int MIN_BLOCKS = 2;

template <int VEC> struct Chunk;
template <> struct Chunk<8> { using type = uint4; };
template <> struct Chunk<4> { using type = uint2; };
template <> struct Chunk<2> { using type = uint32_t; };
template <> struct Chunk<1> { using type = uint16_t; };

// Element e of VEC bf16 values held as one chunk, as a float.
template <int VEC>
__device__ __forceinline__ float element(const typename Chunk<VEC>::type& raw, int e) {
  union { typename Chunk<VEC>::type raw; uint16_t h[VEC]; } u;
  u.raw = raw;
  return __bfloat162float(__ushort_as_bfloat16(u.h[e]));
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[VEC]) {
  union { typename Chunk<VEC>::type raw; uint16_t e[VEC]; } u;
#pragma unroll
  for (int e = 0; e < VEC; ++e) u.e[e] = __bfloat16_as_ushort(__float2bfloat16_rn(f[e]));
  *reinterpret_cast<typename Chunk<VEC>::type*>(p) = u.raw;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
roi_align_vec_kernel(RoiLevels levels, const float* __restrict__ rois,
                     __nv_bfloat16* __restrict__ out, int batch, int C, int w_first,
                     float finest_scale) {
  __shared__ RoiTaps taps;
  const int r = blockIdx.x;
  roi_taps<__nv_bfloat16>(levels, rois + size_t(r) * 5, batch, finest_scale, taps);
  const int i = threadIdx.x / 32, lane = threadIdx.x % 32;   // i: bin of axis a1
  const int c = (blockIdx.y * 32 + lane) * VEC;
  if (c >= C) return;
  __nv_bfloat16* ob = out + size_t(r) * O * O * C + c;
  // output bin (oy, ox) of stage-one bin i and stage-two bin j
  auto bin = [&](int j) { return size_t(w_first ? j * O + i : i * O + j) * C; };
  if (taps.batch < 0) {
    float zero[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) zero[e] = 0.f;
    for (int j = 0; j < O; ++j) store<VEC>(ob + bin(j), zero);
    return;
  }
  const int lvl = taps.level;
  const int Hl = levels.height[lvl], Wl = levels.width[lvl];
  const __nv_bfloat16* f =
      static_cast<const __nv_bfloat16*>(levels.feat[lvl]) + size_t(taps.batch) * Hl * Wl * C + c;
  const int a1 = w_first ? 1 : 0, a2 = 1 - a1;
  int i1[K];
  float w1[K];
#pragma unroll
  for (int k1 = 0; k1 < K; ++k1) {
    i1[k1] = taps.idx[a1][i][k1];
    w1[k1] = taps.w[a1][i][k1];
  }

  // Bin by bin j, the warp issues the loads of every column it has not
  // summed yet (up to 4 columns x 4 rows of 16 bytes a lane, all in flight
  // at once), then sums each such column's stage one; a column equal to the
  // one before it reuses the sum in `t`.
  using V = typename Chunk<VEC>::type;
  float t[VEC];             // round(sum_k1 w1 f) at the last column summed
  int last = -1;            // tap indices are clamped to >= 0
  for (int j = 0; j < O; ++j) {
    int cols[K];
    bool fresh[K];          // the same for the whole warp
#pragma unroll
    for (int k2 = 0; k2 < K; ++k2) {
      cols[k2] = taps.idx[a2][j][k2];
      fresh[k2] = cols[k2] != (k2 ? cols[k2 - 1] : last);
    }
    V raw[K][K];
#pragma unroll
    for (int k2 = 0; k2 < K; ++k2)
#pragma unroll
      for (int k1 = 0; k1 < K; ++k1)
        if (fresh[k2]) {
          const int row = w_first ? cols[k2] : i1[k1], col = w_first ? i1[k1] : cols[k2];
          raw[k2][k1] = *reinterpret_cast<const V*>(f + (size_t(row) * Wl + col) * C);
        }
    float acc[VEC];
#pragma unroll
    for (int k2 = 0; k2 < K; ++k2) {
      if (fresh[k2]) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float acc1 = 0.f;
#pragma unroll
          for (int k1 = 0; k1 < K; ++k1) {
            const float p = __fmul_rn(w1[k1], element<VEC>(raw[k2][k1], e));
            acc1 = k1 == 0 ? p : __fadd_rn(acc1, p);
          }
          t[e] = round_t<__nv_bfloat16>(acc1);
        }
      }
      const float w2 = taps.w[a2][j][k2];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float p2 = __fmul_rn(w2, t[e]);
        acc[e] = k2 == 0 ? p2 : __fadd_rn(acc[e], p2);
      }
    }
    last = cols[K - 1];
    store<VEC>(ob + bin(j), acc);
  }
}

// The widest chunk, in bf16 elements, that divides C and to whose bytes
// every level and the output are aligned.
inline int chunk_width(const RoiLevels& levels, const void* out, int C) {
  for (int v = 8; v > 1; v /= 2) {
    bool ok = C % v == 0 && reinterpret_cast<uintptr_t>(out) % (2 * v) == 0;
    for (int l = 0; l < levels.num_levels; ++l)
      ok = ok && reinterpret_cast<uintptr_t>(levels.feat[l]) % (2 * v) == 0;
    if (ok) return v;
  }
  return 1;
}

template <int VEC>
int launch(const RoiLevels& levels, const float* rois, void* out, int R, int batch, int C,
           int w_first, float finest_scale, cudaStream_t stream) {
  dim3 grid(R, (C + 32 * VEC - 1) / (32 * VEC));
  roi_align_vec_kernel<VEC><<<grid, THREADS, 0, stream>>>(
      levels, rois, static_cast<__nv_bfloat16*>(out), batch, C, w_first, finest_scale);
  return int(cudaGetLastError());
}

}  // namespace vec

}  // namespace

// levels: the level maps (B, Hl, Wl, C) contiguous, all of one dtype;
// rois (R, 5) float32 (batch index, x1, y1, x2, y2) in image pixels, where
// a RoI whose index lies outside [0, batch) pools zeros; out (R, 7, 7, C).
// dtype 0 = float32, 1 = bfloat16.  w_first = 1 contracts the W axis first
// (wide maps).
extern "C" int roi_align_launch(const RoiLevels* levels, const void* rois, void* out, int R,
                                int batch, int C, int dtype, int w_first, float finest_scale,
                                void* stream) {
  if (levels->num_levels < 1 || levels->num_levels > MAX_LEVELS) return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  dim3 grid(R, (C + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  if (dtype == 0)
    roi_align_kernel<float><<<grid, THREADS, 0, s>>>(*levels, r, static_cast<float*>(out),
                                                     batch, C, w_first, finest_scale);
  else if (dtype == 1)
    roi_align_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        *levels, r, static_cast<__nv_bfloat16*>(out), batch, C, w_first, finest_scale);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// The maps' gradient.  levels: float32 gradient maps (B, Hl, Wl, C),
// contiguous and zeroed by the caller, which this adds into; grad_out
// (R, 7, 7, C) of the feature type `dtype`; the rest as above.
extern "C" int roi_align_backward_launch(const RoiLevels* levels, const void* rois,
                                         const void* grad_out, int R, int batch, int C,
                                         int dtype, int w_first, float finest_scale,
                                         void* stream) {
  if (levels->num_levels < 1 || levels->num_levels > MAX_LEVELS) return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  dim3 grid(R, (C + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  if (dtype == 0)
    roi_align_backward_kernel<float><<<grid, THREADS, 0, s>>>(
        *levels, r, static_cast<const float*>(grad_out), batch, C, w_first, finest_scale);
  else if (dtype == 1)
    roi_align_backward_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        *levels, r, static_cast<const __nv_bfloat16*>(grad_out), batch, C, w_first,
        finest_scale);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// The vectorised version: the same arguments, bfloat16 only (dtype 1).
extern "C" int roi_align_bf16_launch(const RoiLevels* levels, const void* rois, void* out,
                                     int R, int batch, int C, int dtype, int w_first,
                                     float finest_scale, void* stream) {
  if (levels->num_levels < 1 || levels->num_levels > MAX_LEVELS || dtype != 1 || C < 1)
    return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  switch (vec::chunk_width(*levels, out, C)) {
    case 8: return vec::launch<8>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
    case 4: return vec::launch<4>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
    case 2: return vec::launch<2>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
    default: return vec::launch<1>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
  }
}
