// Dense RoI crop: both interpolation contractions of one FPN level in one
// kernel,
//
//   out[b,p,i,x,c] = sum_w Wx[b,p,x,w] * round_T( sum_h Wy[b,p,i,h] * F[b,h,w,c] )
//
// with F (B, Hl, Wl, C), Wy (B, P, 7, Hl), Wx (B, P, 7, Wl), out
// (B, P, 7, 7, C), float32 or bfloat16, f32 accumulation, and the stage-one
// product t rounded to the feature type before stage two.
//
// Replaces the Pallas kernel `_kernel`
// (panoswintransformerobjectdetection_tpu/ops/roi_align_pallas.py:52, called
// from `fused_crop_per_image`, :138).  What it keeps from that kernel is the
// point of it: t, which is (B, P, 7, Wl, C) and far larger than anything
// else here, never goes to device memory.  What it drops is the TPU's
// formulation: the 128-lane channel tiles, the i-major permutation of Wy and
// the block-diagonal Wx assembled from concatenations, which exist so that
// stage two is one large matrix-unit product.
//
// What bounds it on the H100: operations.  At the flagship's finest level
// (B 2, P 640, Hl 256, Wl 128 after the wide-map transpose, C 256) stage
// one is 150 GFLOP and stage two 4 GFLOP, against 34 MB of features, 3.4 MB
// of weights and 32 MB of output in bf16.  This version does the
// multiply-adds in f32 on the CUDA cores for both types, so it sits far
// above the tensor-core bound; a bf16 version of stage one on the tensor
// cores is the next step.
//
// Design: one block per (image, 8 RoIs, 32 channels) walks over the level in
// strips of 8 columns w.  For a strip it forms t[(p, i), (w, c)] = Wy . F as
// a (56 x Hl) x (Hl x 256) product, 16 rows h at a time through shared
// memory, each thread holding a 7 x 8 register tile (its RoI's 7 bins, 8 of
// the 256 (w, c) columns); rounds t and parks it in shared memory; then
// every thread, now owning one (RoI, channel), adds the strip's share of
// sum_w Wx . t to its 7 x 7 accumulators in registers.  The register tiles
// leave room for one block of 8 warps an SM, so nothing hides a tile's loads
// but the block itself: each thread fetches its share of the next tile into
// registers before it works on the current one.  Ragged P, C, Hl and Wl are
// masked with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int O = 7;            // output bins per side
constexpr int PC = 8;           // RoIs per block
constexpr int CT = 32;          // channels per block
constexpr int WS = 8;           // columns w per strip
constexpr int HK = 16;          // rows h per stage-one step
constexpr int RP = 8;           // rows of s.wy per RoI: its 7 bins, padded to 8
constexpr int NCOL = WS * CT;   // 256 (w, c) columns of a strip
constexpr int THREADS = PC * 32;
constexpr int TN = NCOL / 32;   // 8 strip columns per thread in stage one
constexpr int WYR = (PC * O * HK + THREADS - 1) / THREADS;   // Wy values a thread loads per tile
static_assert(NCOL == THREADS && WS == PC, "a thread loads the tile's column (pl, lane)");
static_assert(THREADS % HK == 0, "a thread keeps one h offset of the Wy tile");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Smem {
  float wy[HK][PC * RP];      // Wy tile, [h][(p, i)]
  float f[HK][NCOL];          // feature tile, [h][(w, c)]
  float t[PC * O][NCOL];      // stage-one product of the strip, rounded to T
  float wx[PC][O][WS];        // Wx of the strip
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_crop_kernel(const T* __restrict__ feat, const T* __restrict__ Wy,
                  const T* __restrict__ Wx, T* __restrict__ out, int P, int Hl, int Wl,
                  int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int pl = tid / 32;      // this thread's RoI of the chunk, in both stages
  const int lane = tid % 32;
  const int c0 = blockIdx.x * CT, p0 = blockIdx.y * PC, b = blockIdx.z;
  const int p_valid = min(PC, P - p0);
  const T* fb = feat + size_t(b) * Hl * Wl * C;
  const T* wyb = Wy + (size_t(b) * P + p0) * O * Hl;
  const T* wxb = Wx + (size_t(b) * P + p0) * O * Wl;

  float acc[O][O];              // [i][x] of (p0 + pl, c0 + lane)
#pragma unroll
  for (int i = 0; i < O; ++i)
#pragma unroll
    for (int x = 0; x < O; ++x) acc[i][x] = 0.f;

  // One tile of stage one is (strip w0, rows h0 .. h0 + HK): this thread's
  // share of it is the feature column (w0 + pl, c0 + lane) at HK rows and up
  // to WYR weights.  The next tile's share is loaded into registers before
  // the current tile's arithmetic, so that its latency is hidden.
  T f_next[HK];
  T wy_next[WYR];
  auto load_tile = [&](int w0, int h0) {
    const bool col_ok = w0 + pl < Wl && c0 + lane < C;
    const T* src = fb + (size_t(h0) * Wl + w0 + pl) * C + c0 + lane;
#pragma unroll
    for (int k = 0; k < HK; ++k)
      f_next[k] = (col_ok && h0 + k < Hl) ? src[size_t(k) * Wl * C] : from_f<T>(0.f);
#pragma unroll
    for (int j = 0; j < WYR; ++j) {
      const int row = tid / HK + j * (THREADS / HK);     // (p, i) row of Wy
      const bool ok = row < p_valid * O && h0 + tid % HK < Hl;
      wy_next[j] = ok ? wyb[size_t(row) * Hl + h0 + tid % HK] : from_f<T>(0.f);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int k = 0; k < HK; ++k) s.f[k][tid] = to_f(f_next[k]);
#pragma unroll
    for (int j = 0; j < WYR; ++j) {
      const int row = tid / HK + j * (THREADS / HK);
      if (row < PC * O) s.wy[tid % HK][(row / O) * RP + row % O] = to_f(wy_next[j]);
    }
  };

  if (tid < PC * HK) s.wy[tid % HK][(tid / HK) * RP + O] = 0.f;   // the padding row
  load_tile(0, 0);
  for (int w0 = 0; w0 < Wl; w0 += WS) {
    // stage one: t[(pl, i), n] for this thread's columns n = lane * 4 + {0..3}
    // and 128 + lane * 4 + {0..3}
    float t_acc[O][TN];
#pragma unroll
    for (int i = 0; i < O; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) t_acc[i][n] = 0.f;

    for (int h0 = 0; h0 < Hl; h0 += HK) {
      __syncthreads();          // the last tile's, and the last strip's, readers are done
      store_tile();
      __syncthreads();
      if (h0 + HK < Hl)
        load_tile(w0, h0 + HK);
      else if (w0 + WS < Wl)
        load_tile(w0 + WS, 0);
#pragma unroll
      for (int k = 0; k < HK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&s.wy[k][pl * RP]);
        const float4 a1 = *reinterpret_cast<const float4*>(&s.wy[k][pl * RP + 4]);
        const float4 f0 = *reinterpret_cast<const float4*>(&s.f[k][lane * 4]);
        const float4 f1 = *reinterpret_cast<const float4*>(&s.f[k][NCOL / 2 + lane * 4]);
        const float a[O] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z};
        const float fv[TN] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
        for (int i = 0; i < O; ++i)
#pragma unroll
          for (int n = 0; n < TN; ++n) t_acc[i][n] = fmaf(a[i], fv[n], t_acc[i][n]);
      }
    }

    // t, rounded to T, and the strip's Wx go to shared memory.  Every thread
    // has passed a barrier since the last strip's stage two read them.
#pragma unroll
    for (int i = 0; i < O; ++i) {
      float r[TN];
#pragma unroll
      for (int n = 0; n < TN; ++n) r[n] = to_f(from_f<T>(t_acc[i][n]));
      *reinterpret_cast<float4*>(&s.t[pl * O + i][lane * 4]) = make_float4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<float4*>(&s.t[pl * O + i][NCOL / 2 + lane * 4]) =
          make_float4(r[4], r[5], r[6], r[7]);
    }
    for (int e = tid; e < PC * O * WS; e += THREADS) {
      const int row = e / WS, w = e % WS;
      float v = 0.f;
      if (row / O < p_valid && w0 + w < Wl) v = to_f(wxb[size_t(row) * Wl + w0 + w]);
      s.wx[row / O][row % O][w] = v;
    }
    __syncthreads();

    // stage two: this thread's (RoI pl, channel lane) over the strip's columns
#pragma unroll
    for (int w = 0; w < WS; ++w) {
      float tv[O], xv[O];
#pragma unroll
      for (int i = 0; i < O; ++i) tv[i] = s.t[pl * O + i][w * CT + lane];
#pragma unroll
      for (int x = 0; x < O; ++x) xv[x] = s.wx[pl][x][w];
#pragma unroll
      for (int i = 0; i < O; ++i)
#pragma unroll
        for (int x = 0; x < O; ++x) acc[i][x] = fmaf(xv[x], tv[i], acc[i][x]);
    }
  }

  if (pl < p_valid && c0 + lane < C) {
    T* o = out + (size_t(b) * P + p0 + pl) * O * O * C + c0 + lane;
#pragma unroll
    for (int i = 0; i < O; ++i)
#pragma unroll
      for (int x = 0; x < O; ++x) o[size_t(i * O + x) * C] = from_f<T>(acc[i][x]);
  }
}

template <typename T>
int launch(const void* feat, const void* Wy, const void* Wx, void* out, int B, int P, int Hl,
           int Wl, int C, cudaStream_t stream) {
  auto kernel = dense_crop_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(sizeof(Smem)));
  if (err != cudaSuccess) return int(err);
  dim3 grid((C + CT - 1) / CT, (P + PC - 1) / PC, B);
  kernel<<<grid, THREADS, sizeof(Smem), stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(Wy), static_cast<const T*>(Wx),
      static_cast<T*>(out), P, Hl, Wl, C);
  return int(cudaGetLastError());
}

}  // namespace

// feat (B, Hl, Wl, C), Wy (B, P, 7, Hl), Wx (B, P, 7, Wl), out (B, P, 7, 7, C),
// all contiguous and of one type.  dtype 0 = float32, 1 = bfloat16.
extern "C" int dense_crop_launch(const void* feat, const void* Wy, const void* Wx, void* out,
                                 int B, int P, int Hl, int Wl, int C, int o, int dtype,
                                 void* stream) {
  if (o != O || B < 1 || P < 1 || C < 1 || B > 65535 || (P + PC - 1) / PC > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(feat, Wy, Wx, out, B, P, Hl, Wl, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(feat, Wy, Wx, out, B, P, Hl, Wl, C, s);
  return int(cudaErrorInvalidValue);
}
