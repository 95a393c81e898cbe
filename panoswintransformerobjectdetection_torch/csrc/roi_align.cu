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
// extra device-memory traffic beyond each RoI's footprint.
//
// Design: one block per (RoI, slice of 128 channels), one thread per
// channel, so every feature read is coalesced along C in the NHWC maps.
// Fourteen threads first work out the RoI's level and the merged taps of
// the 7 bins of each axis (up to 4 distinct columns per bin) into shared
// memory; then each thread walks the 49 output bins.

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

template <typename T>
__global__ void roi_align_kernel(RoiLevels levels, const float* __restrict__ rois,
                                 T* __restrict__ out, int batch, int C, int w_first,
                                 float finest_scale) {
  // [axis][bin][tap]; axis 0 = y (rows), 1 = x (columns)
  __shared__ int s_idx[2][O][K];
  __shared__ float s_w[2][O][K];
  __shared__ int s_level;
  __shared__ int s_batch;

  const int r = blockIdx.x;
  const float* roi = rois + size_t(r) * 5;
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
    axis_taps<T>(start, bin, size, o, s_idx[axis][o], s_w[axis][o]);
    if (t == 0) {
      // an index outside [0, batch), or NaN, pools zeros (as the twin does)
      const float b = roi[0];
      s_level = lvl;
      s_batch = (b >= 0.f && b < float(batch)) ? int(b) : -1;
    }
  }
  __syncthreads();

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
