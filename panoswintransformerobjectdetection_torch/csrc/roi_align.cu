// Multilevel RoIAlign: every RoI pooled to (O, O, C) from its own FPN level,
// O = 7 (the bbox head) or 14 (the mask head), forward and backward.
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
// stage-one reuse.  One block of O warps per (RoI, slice of 32 * VEC
// channels) at O = 7: its first 2 * O threads work out the RoI's level and
// taps into shared memory, as in the first version; then warp i takes bin
// i of the axis contracted first (at O = 14 see `vec`'s note on the two
// designs), and each lane VEC neighbouring channels, so that a
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
// O * O output bins with 16 scalar loads each.
//
// At O = 14 (the mask head's 2 x 100 RoIs an 800 x 1088 batch, C = 256)
// the function reads at most the RoIs' footprints and writes 200 * 196 *
// 256 values: 20 MB in bf16, about 0.006 ms at 3.35 TB/s, far from the
// arithmetic's limit, so it is bound by bytes as at O = 7.  Nothing in the
// design changes with O: each output value is the same 16 weighted taps,
// and the bin width extent * inv / O is divided with `__fdiv_rn`, as the
// twin divides, so the kernel stays the twin's bit for bit.

// Backward.  The function is linear in the maps, so the maps' gradient is
// the transposed gather: pixel (p1, p2) of a RoI's level and image gets
//   G[p1, p2] += sum_i sum_{k1: idx1[i,k1] = p1} w1[i,k1] * A[i, p2],
//   A[i, p2]   = sum_j sum_{k2: idx2[j,k2] = p2} round(w2[j,k2] * d[r,i,j]),
// with a1 (bins i, taps k1) the axis the forward contracts first and a2
// (bins j, taps k2) the other.  As autograd through the twin does, the
// stage-one gradient w2 * d is rounded to the feature type, every other sum
// is taken in f32, and each pixel is rounded once.  It is bound by bytes:
// grad_out in (32 MB at the training step's 2 x 640 RoIs, C = 256) and the
// four bf16 level maps out (45 MB), about 0.023 ms at 3.35 TB/s.
//
// float32 entry (`roi_align_backward_launch`), the first version: the
// forward's blocks and taps, and every nonzero tap one f32 `atomicAdd` into
// f32 maps, which the wrapper zeroes before and casts after.  Those two
// passes over 89 MB of f32 maps cost about three times the bound, and the
// atomics add in an order that changes from run to run.  Its bf16
// instantiation is there so that `chip_smoke.py` times the redesign
// against it.
//
// bfloat16 entry (`roi_align_backward_bf16_launch`): owner computes.  A
// first kernel works out every RoI's level, image and taps once (the
// forward's `roi_taps`, so the taps are the forward's bit for bit) and its
// footprint: the least and greatest pixel its taps of nonzero weight name
// on each axis.  Then one block of 8 warps owns a tile of 8 x 8 pixels of
// one level and image and a slice of 32 * VEC channels: warp w the pixels
// (o1 .. o1 + 7, o2 + w), lane l channels VEC * l .. VEC * l + VEC - 1 of
// all eight, in f32 registers (VEC as in the forward: 8, or narrower where
// C or the addresses require).  The block lists, in index order, the RoIs
// of its level and image whose footprint meets the tile, and walks the
// list with each RoI's gradient and taps staged in shared memory by
// `cp.async`, the next one's copy in flight; a warp adds the RoIs whose
// footprint holds its column: for each bin i with a tap on the tile's
// rows, A = sum_j round(w2 * d) (w2 and d are bf16, so the f32 product is
// exact and its rounding is the bf16 product, two channels an
// instruction), then w1 * A into each row bin i has a tap on.  Every pixel
// is written once, in bf16, zeros included: no f32 maps, no zero-fill, no
// cast, no atomics, and the additions follow the RoI index, so two runs
// give the same bits.  A coarse level has few tiles, each under many RoIs,
// so the coarsest level's blocks come first in the grid, and their long
// lists overlap the fine levels' work.
//
// At O = 14 (the mask head's positives, 2 x 128 RoIs, C = 256) a RoI's
// staged gradient is 196 bins, 100 KB at VEC = 8: two stages leave room for
// one block an SM, so a block there has 16 warps (a tile of 8 x 16 pixels)
// and the SM keeps the 16 warps and 128 registers a thread that two blocks
// of 8 warps give at O = 7; each staged RoI also serves twice the pixels.
// A warp holds two of a RoI's 56 taps of each axis a lane, and the rows of
// the tile that each bin i has a tap on in four words of 4 bins (two at 7).
// The function reads 26 MB of grad_out and writes the four bf16 maps of an
// 800 x 1088 batch (74 MB), about 0.03 ms at 3.35 TB/s: bound by bytes.
// Measured (NVIDIA H100 80GB HBM3, 700 W): 0.171 ms on 2 x 128 random RoIs,
// 5.8x the bound; 0.278 ms on the RoIs a training step samples, which
// cluster on level 0 around a few objects, so that a few tiles list most
// RoIs and each such list is walked by one block.
//
// What holds it at 8-9x its bound at O = 7 (NVIDIA H100 80GB HBM3, 700 W):
// the arithmetic.  A warp spends some 800 instructions on a small RoI (all
// seven bins i on its rows, two or three bins j on its column, 8 channels
// a lane), and the training step's 1280 RoIs give some 60000 such (RoI,
// warp) pairs; copies of the source that skipped the arithmetic took less
// than half the time, ones that skipped the copies most of it.  A kernel
// that writes zeros after reading every header costs about 0.05 ms alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// A RoI's level, image and merged taps at O bins a side, in shared memory
// (16-byte aligned, so that the backward's blocks copy them in 16-byte
// pieces).
template <int O>
struct alignas(16) RoiTaps {
  int idx[2][O][K];     // [axis][bin][tap]; axis 0 = y (rows), 1 = x (columns)
  float w[2][O][K];
  int level;
  int batch;            // -1: the index lies outside [0, batch), or is NaN
};

// Fills `taps` for the block's RoI with its first 2 * O threads (the block
// has at least that many) and synchronises the whole block.
template <typename T, int O>
__device__ void roi_taps(const RoiLevels& levels, const float* roi, int batch,
                         float finest_scale, RoiTaps<O>& taps) {
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

template <typename T, int O>
__global__ void roi_align_kernel(RoiLevels levels, const float* __restrict__ rois,
                                 T* __restrict__ out, int batch, int C, int w_first,
                                 float finest_scale) {
  static_assert(2 * O <= THREADS, "the taps take 2 * O threads of the block");
  __shared__ RoiTaps<O> taps;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  roi_taps<T, O>(levels, rois + size_t(r) * 5, batch, finest_scale, taps);
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

template <typename T, int O>
__global__ void roi_align_backward_kernel(RoiLevels levels, const float* __restrict__ rois,
                                          const T* __restrict__ grad_out, int batch, int C,
                                          int w_first, float finest_scale) {
  __shared__ RoiTaps<O> taps;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  roi_taps<T, O>(levels, rois + size_t(r) * 5, batch, finest_scale, taps);
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

// A warp takes one stage-one bin, so a block has 32 * O threads, and the
// blocks an SM holds follow.  At O = 7, two blocks an SM: at most 146
// registers a thread.  Left free, the 16 chunks a lane has in flight took
// 154 registers, one block fit an SM and it ran 1.7x slower; capped for
// three blocks, it spilled and ran 2.8x slower.  At O = 14 the 448 threads
// of a block would be capped at 73 registers (a spill) by two blocks an
// SM, so it holds one, with the same 146 registers a thread.  (Giving each
// of 7 warps two bins, two blocks an SM, measured 3% slower.)
__host__ __device__ constexpr int threads(int O) { return 32 * O; }
__host__ __device__ constexpr int min_blocks(int O) { return threads(O) > 256 ? 1 : 2; }

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

template <int VEC, int O>
__global__ void __launch_bounds__(threads(O), min_blocks(O))
roi_align_vec_kernel(RoiLevels levels, const float* __restrict__ rois,
                     __nv_bfloat16* __restrict__ out, int batch, int C, int w_first,
                     float finest_scale) {
  __shared__ RoiTaps<O> taps;
  const int r = blockIdx.x;
  roi_taps<__nv_bfloat16, O>(levels, rois + size_t(r) * 5, batch, finest_scale, taps);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = (blockIdx.y * 32 + lane) * VEC;
  if (c >= C) return;
  __nv_bfloat16* ob = out + size_t(r) * O * O * C + c;
  // output bin (oy, ox) of stage-one bin i and stage-two bin j
  auto bin = [&](int i, int j) { return size_t(w_first ? j * O + i : i * O + j) * C; };
  if (taps.batch < 0) {
    float zero[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) zero[e] = 0.f;
    for (int j = 0; j < O; ++j) store<VEC>(ob + bin(warp, j), zero);
    return;
  }
  const int a1 = w_first ? 1 : 0, a2 = 1 - a1;
  const int lvl = taps.level;
  const int Hl = levels.height[lvl], Wl = levels.width[lvl];
  const __nv_bfloat16* f =
      static_cast<const __nv_bfloat16*>(levels.feat[lvl]) + size_t(taps.batch) * Hl * Wl * C + c;
  using V = typename Chunk<VEC>::type;
  const int i = warp;                                         // bin of axis a1
  int i1[K];
  float w1[K];
#pragma unroll
  for (int k1 = 0; k1 < K; ++k1) {
    i1[k1] = taps.idx[a1][i][k1];
    w1[k1] = taps.w[a1][i][k1];
  }

  // Bin by bin j, the warp issues the loads of every column it has not
  // summed yet (up to 4 columns x 4 rows of 16 bytes a lane, all in
  // flight at once), then sums each such column's stage one; a column
  // equal to the one before it reuses the sum in `t`.
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
    store<VEC>(ob + bin(i, j), acc);
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

template <int VEC, int O>
int launch_width(const RoiLevels& levels, const float* rois, void* out, int R, int batch, int C,
                 int w_first, float finest_scale, cudaStream_t stream) {
  dim3 grid(R, (C + 32 * VEC - 1) / (32 * VEC));
  roi_align_vec_kernel<VEC, O><<<grid, threads(O), 0, stream>>>(
      levels, rois, static_cast<__nv_bfloat16*>(out), batch, C, w_first, finest_scale);
  return int(cudaGetLastError());
}

template <int O>
int launch(const RoiLevels& levels, const float* rois, void* out, int R, int batch, int C,
           int w_first, float finest_scale, cudaStream_t stream) {
  const auto go = [&](auto width) {
    return launch_width<decltype(width)::value, O>(levels, rois, out, R, batch, C, w_first,
                                                   finest_scale, stream);
  };
  switch (chunk_width(levels, out, C)) {
    case 8: return go(std::integral_constant<int, 8>{});
    case 4: return go(std::integral_constant<int, 4>{});
    case 2: return go(std::integral_constant<int, 2>{});
    default: return go(std::integral_constant<int, 1>{});
  }
}

}  // namespace vec

// ------------------------------------------------------- bfloat16 backward

namespace owner {

constexpr int TILE = 8;                   // pixels a warp owns along a1
constexpr int LIST = 2048;                // RoIs a block filters at a time
constexpr unsigned FULL = 0xffffffffu;

// The block at O bins a side: a warp per pixel of the tile along a2, 8 warps
// and two blocks an SM at O = 7; 16 warps and one block an SM at O = 14,
// where two stages of a RoI's gradient take 200 KB (see the note above).
template <int O>
struct Shape {
  static constexpr int WARPS = O <= 8 ? 8 : 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = O <= 8 ? 2 : 1;
  static constexpr int PER_THREAD = LIST / THREADS;
  static constexpr int TAPS = O * K;                // candidate taps of a RoI along one axis
  static constexpr int LANE_TAPS = (TAPS + 31) / 32;   // of them, a lane holds
  static_assert(O <= 16 && LIST % THREADS == 0, "a lane holds at most two taps an axis");
};

// What a block needs to choose a RoI: its level (-1: it adds nothing), its
// image, and its footprint on each axis, lo | hi << 16 over its taps of
// nonzero weight.
struct alignas(16) Header {
  int level, batch, span1, span2;
};

// The grid, level by level, the coarsest first (its tiles take the most
// RoIs each): a level's blocks are (image, tile1, tile2).
struct Plan {
  int first_block[MAX_LEVELS], blocks[MAX_LEVELS];
  int tiles1[MAX_LEVELS], tiles2[MAX_LEVELS];   // tiles of an image along a1, a2
};

// One RoI as a block stages it: its gradient (O * O bins, 32 * VEC
// channels) and its taps; two stages, the next RoI's copied while one is
// added.
template <int O, int VEC> constexpr int D_BYTES = O * O * 32 * VEC * 2;
template <int O, int VEC> constexpr int STAGE_BYTES = D_BYTES<O, VEC> + int(sizeof(RoiTaps<O>));
template <int O, int VEC> constexpr int SMEM_BYTES = 2 * STAGE_BYTES<O, VEC>;

// An asynchronous copy of BYTES (2, 4, 8 or 16) from device to shared
// memory; 2 bytes, below `cp.async`'s least, go by a plain load and store.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (BYTES == 2) {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  } else {
    const unsigned s = unsigned(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
  }
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The whole block copies RoI r's gradient (this block's channels) and taps
// into a stage.
template <int O, int VEC>
__device__ __forceinline__ void stage_roi(char* stage, const __nv_bfloat16* grad_out,
                                          const RoiTaps<O>* taps, int r, int C, int c0) {
  for (int q = threadIdx.x; q < O * O * 32; q += Shape<O>::THREADS) {
    const int bin = q / 32, c = c0 + (q % 32) * VEC;
    if (c < C)
      copy_async<2 * VEC>(stage + q * 2 * VEC, grad_out + (size_t(r) * O * O + bin) * C + c);
  }
  char* tstage = stage + D_BYTES<O, VEC>;
  for (int q = threadIdx.x; q < int(sizeof(RoiTaps<O>)) / 16; q += Shape<O>::THREADS)
    copy_async<16>(tstage + q * 16, reinterpret_cast<const char*>(taps + r) + q * 16);
  copy_commit();
}

// One block of 32 threads a RoI: its taps and header.
template <int O>
__global__ void roi_meta_kernel(RoiLevels levels, const float* __restrict__ rois, int batch,
                                int w_first, float finest_scale, Header* __restrict__ headers,
                                RoiTaps<O>* __restrict__ taps) {
  static_assert(2 * O <= 32, "the taps take 2 * O threads of the block");
  __shared__ RoiTaps<O> t;
  const int r = blockIdx.x, lane = threadIdx.x;
  roi_taps<__nv_bfloat16, O>(levels, rois + size_t(r) * 5, batch, finest_scale, t);
  const int* src = reinterpret_cast<const int*>(&t);
  int* dst = reinterpret_cast<int*>(taps + r);
  for (int k = lane; k < int(sizeof(RoiTaps<O>) / 4); k += 32) dst[k] = src[k];
  // lane 0 the footprint along a1, lane 1 along a2
  const int a1 = w_first ? 1 : 0;
  const int ax = lane == 0 ? a1 : 1 - a1;
  int lo = 1 << 30, hi = -1;
  for (int i = 0; i < O; ++i)
    for (int k = 0; k < K; ++k)
      if (t.w[ax][i][k] != 0.f) {
        lo = min(lo, t.idx[ax][i][k]);
        hi = max(hi, t.idx[ax][i][k]);
      }
  const int span = hi < 0 ? -1 : lo | (hi << 16);
  const int span1 = __shfl_sync(FULL, span, 0), span2 = __shfl_sync(FULL, span, 1);
  if (lane == 0) {
    const bool adds = t.batch >= 0 && span1 >= 0 && span2 >= 0;
    headers[r] = Header{adds ? t.level : -1, t.batch, span1, span2};
  }
}

// a[e] += round(w * d[e]) for the VEC bf16 values d of a chunk; w is a bf16
// value, so the f32 product is exact and its rounding is the bf16 product.
template <int VEC>
__device__ __forceinline__ void add_products(float w, const typename vec::Chunk<VEC>::type& raw,
                                             float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    a[0] = __fadd_rn(a[0], round_t<__nv_bfloat16>(__fmul_rn(w, vec::element<1>(raw, 0))));
  } else {
    union { typename vec::Chunk<VEC>::type raw; __nv_bfloat162 h[VEC / 2]; } u;
    u.raw = raw;
    const __nv_bfloat162 w2 = __float2bfloat162_rn(w);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      const float2 p = __bfloat1622float2(__hmul2(w2, u.h[e]));
      a[2 * e] = __fadd_rn(a[2 * e], p.x);
      a[2 * e + 1] = __fadd_rn(a[2 * e + 1], p.y);
    }
  }
}

template <int O, int VEC>
__global__ void __launch_bounds__(Shape<O>::THREADS, Shape<O>::MIN_BLOCKS)
roi_align_backward_owner_kernel(RoiLevels maps, Plan plan, const Header* __restrict__ headers,
                                const RoiTaps<O>* __restrict__ taps,
                                const __nv_bfloat16* __restrict__ grad_out, int R, int C,
                                int w_first) {
  using Sh = Shape<O>;
  constexpr int WARPS = Sh::WARPS, PER_THREAD = Sh::PER_THREAD;
  constexpr int TAPS = Sh::TAPS, LANE_TAPS = Sh::LANE_TAPS;
  __shared__ int list[LIST];
  __shared__ int list_span[LIST];         // the listed RoIs' footprints along a2
  __shared__ int warp_count[WARPS];
  __shared__ float w1s[WARPS][TILE][O];   // each warp's w1 of the RoI at hand, by row
  extern __shared__ float4 smem_store[];  // SMEM_BYTES<O, VEC>: two stages
  char* smem = reinterpret_cast<char*>(smem_store);

  int lvl = 0, blk = int(blockIdx.x) - plan.first_block[0];
  while (blk < 0 || blk >= plan.blocks[lvl]) blk = int(blockIdx.x) - plan.first_block[++lvl];
  const int tile2 = blk % plan.tiles2[lvl];
  blk /= plan.tiles2[lvl];
  const int tile1 = blk % plan.tiles1[lvl];
  const int b = blk / plan.tiles1[lvl];
  const int Hl = maps.height[lvl], Wl = maps.width[lvl];
  const int N1 = w_first ? Wl : Hl, N2 = w_first ? Hl : Wl;
  const int o1 = tile1 * TILE, o2 = tile2 * WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p2 = o2 + warp;
  const bool owns = p2 < N2;                            // the same for the warp
  const int c = (blockIdx.y * 32 + lane) * VEC;
  const bool active = c < C;            // idle lanes still take part in the shuffles
  const int a1 = w_first ? 1 : 0, a2 = 1 - a1;
  using V = typename vec::Chunk<VEC>::type;

  float acc[TILE][VEC];
#pragma unroll
  for (int t = 0; t < TILE; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[t][e] = 0.f;

  for (int base = 0; base < R; base += LIST) {
    // list, in index order, the RoIs of this level and image that meet the tile
    unsigned mine = 0;
    int n = 0, spans[PER_THREAD];
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int r = base + threadIdx.x * PER_THREAD + q;
      spans[q] = 0;
      if (r < R) {
        const Header h = headers[r];
        const bool meets = h.level == lvl && h.batch == b && (h.span1 & 0xffff) < o1 + TILE &&
                           (h.span1 >> 16) >= o1 && (h.span2 & 0xffff) < o2 + WARPS &&
                           (h.span2 >> 16) >= o2;
        if (meets) {
          mine |= 1u << q;
          ++n;
        }
        spans[q] = h.span2;
      }
    }
    int incl = n;
#pragma unroll
    for (int dd = 1; dd < 32; dd *= 2) {
      const int v = __shfl_up_sync(FULL, incl, dd);
      if (lane >= dd) incl += v;
    }
    if (lane == 31) warp_count[warp] = incl;
    __syncthreads();
    int pos = incl - n, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int v = warp_count[w];
      pos += w < warp ? v : 0;
      total += v;
    }
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q)
      if (mine >> q & 1u) {
        list[pos] = base + threadIdx.x * PER_THREAD + q;
        list_span[pos] = spans[q];
        ++pos;
      }
    __syncthreads();

    // The whole block stages each listed RoI (gradient and taps) in shared
    // memory, in order, the next one's copy in flight while this one is
    // added; a warp adds the ones whose footprint holds its column.
    const int c0 = blockIdx.y * 32 * VEC;
    if (total > 0) stage_roi<O, VEC>(smem, grad_out, taps, list[0], C, c0);
    for (int q = 0; q < total; ++q) {
      char* stage = smem + (q & 1) * STAGE_BYTES<O, VEC>;
      if (q + 1 < total) {
        stage_roi<O, VEC>(smem + ((q + 1) & 1) * STAGE_BYTES<O, VEC>, grad_out, taps,
                          list[q + 1], C, c0);
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
      __syncthreads();
      const int sp = list_span[q];
      if (owns && p2 >= (sp & 0xffff) && p2 <= (sp >> 16)) {     // the same for the warp
        const RoiTaps<O>& tp = *reinterpret_cast<const RoiTaps<O>*>(stage + D_BYTES<O, VEC>);
        // lane l: taps l and l + 32 of a1 and of a2, where there are that many
        int ia[LANE_TAPS], ib[LANE_TAPS];
        float wa[LANE_TAPS], wb[LANE_TAPS];
#pragma unroll
        for (int h = 0; h < LANE_TAPS; ++h) {
          const int k = lane + 32 * h;
          ia[h] = ib[h] = -1;
          wa[h] = wb[h] = 0.f;
          if (k < TAPS) {
            ia[h] = (&tp.idx[a1][0][0])[k];
            wa[h] = (&tp.w[a1][0][0])[k];
            ib[h] = (&tp.idx[a2][0][0])[k];
            wb[h] = (&tp.w[a2][0][0])[k];
          }
        }
        // w1 by row of the tile: a bin has at most one tap of nonzero
        // weight on a pixel (repeated columns carry weight 0)
        float* w1 = &w1s[warp][0][0];
#pragma unroll
        for (int k = 0; k < TILE * O; k += 32)
          if (k + lane < TILE * O) w1[k + lane] = 0.f;
        __syncwarp();
        // rows of each bin i: the tile's rows that it has a tap on, 8 bits
        // a bin, 4 bins a word; tap k's bin k / K lies in word k / 16
        unsigned rows[2 * LANE_TAPS];
        unsigned m2[LANE_TAPS];
#pragma unroll
        for (int h = 0; h < LANE_TAPS; ++h) {
          const int k = lane + 32 * h;
          const bool in1 = wa[h] != 0.f && ia[h] >= o1 && ia[h] < o1 + TILE;
          if (in1) w1s[warp][ia[h] - o1][k / K] = wa[h];
          const unsigned bit = in1 ? 1u << ((k / K % 4) * TILE + ia[h] - o1) : 0u;
          rows[2 * h] = __reduce_or_sync(FULL, lane < 4 * K ? bit : 0u);
          rows[2 * h + 1] = __reduce_or_sync(FULL, lane >= 4 * K ? bit : 0u);
          m2[h] = __ballot_sync(FULL, wb[h] != 0.f && ib[h] == p2);
        }
        float w2[O];                    // w2 of each bin j on this warp's column
#pragma unroll
        for (int j = 0; j < O; ++j) {
          const int h = K * j / 32, s = K * j % 32;
          const unsigned bits = (m2[h] >> s) & 0xfu;
          const float v = __shfl_sync(FULL, wb[h], s + (bits ? __ffs(bits) - 1 : 0));
          w2[j] = bits ? v : 0.f;
        }
        __syncwarp();
        // Bin by bin i with a tap on the tile's rows: A = sum_j round(w2 *
        // d) over the bins j with a tap on this warp's column, then w1 * A
        // into each row the bin has a tap on.  w2 and d are bf16, so their
        // f32 product is exact and round(w2 * d) is the bf16 product, two
        // channels an instruction.
        const V* dv = reinterpret_cast<const V*>(stage) + lane;
#pragma unroll
        for (int i = 0; i < O; ++i) {
          const unsigned rw = (rows[i / 4] >> ((i % 4) * TILE)) & 0xffu;
          if (!rw) continue;                                       // the same for the warp
          float a[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) a[e] = 0.f;
#pragma unroll
          for (int j = 0; j < O; ++j)
            if (w2[j] != 0.f)
              add_products<VEC>(w2[j], dv[(w_first ? j * O + i : i * O + j) * 32], a);
#pragma unroll
          for (int t = 0; t < TILE; ++t)
            if (rw >> t & 1u) {
              const float w = w1s[warp][t][i];
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[t][e] = __fmaf_rn(w, a[e], acc[t][e]);
            }
        }
        __syncwarp();                   // w1s is written again for the next RoI
      }
      __syncthreads();                  // the stage is copied into again
    }
    __syncthreads();                    // the list is written again
  }

  if (owns && active)
#pragma unroll
    for (int t = 0; t < TILE; ++t)
      if (o1 + t < N1) {
        const int y = w_first ? p2 : o1 + t, x = w_first ? o1 + t : p2;
        vec::store<VEC>(static_cast<__nv_bfloat16*>(const_cast<void*>(maps.feat[lvl])) +
                            ((size_t(b) * Hl + y) * Wl + x) * C + c,
                        acc[t]);
      }
}

template <int O, int VEC>
int launch_width(const RoiLevels& maps, const Plan& plan, const Header* headers,
                 const RoiTaps<O>* taps, const void* grad_out, int R, int C, int w_first,
                 cudaStream_t stream) {
  int blocks = 0;
  for (int l = 0; l < maps.num_levels; ++l) blocks += plan.blocks[l];
  if (blocks == 0) return 0;
  static const int attributes = int(cudaFuncSetAttribute(
      roi_align_backward_owner_kernel<O, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES<O, VEC>));
  if (attributes) return attributes;
  dim3 grid(blocks, (C + 32 * VEC - 1) / (32 * VEC));
  roi_align_backward_owner_kernel<O, VEC><<<grid, Shape<O>::THREADS, SMEM_BYTES<O, VEC>, stream>>>(
      maps, plan, headers, taps, static_cast<const __nv_bfloat16*>(grad_out), R, C, w_first);
  return int(cudaGetLastError());
}

// The workspace of R RoIs: a header and the taps of each.
template <int O>
long long workspace_bytes(int R) {
  return (long long)R * (sizeof(Header) + sizeof(RoiTaps<O>));
}

// The plan, the per-RoI kernel, then the owner kernel at the widest chunk.
template <int O>
int launch(const RoiLevels& levels, const float* rois, const void* grad_out, int R, int batch,
           int C, int w_first, float finest_scale, void* workspace, cudaStream_t s) {
  Plan plan{};
  long long blocks = 0;
  for (int l = levels.num_levels - 1; l >= 0; --l) {
    const int H = levels.height[l], W = levels.width[l];
    if (H < 0 || W < 0 || H >= (1 << 15) || W >= (1 << 15)) return int(cudaErrorInvalidValue);
    const int N1 = w_first ? W : H, N2 = w_first ? H : W;
    plan.first_block[l] = int(blocks);
    plan.tiles1[l] = (N1 + TILE - 1) / TILE;
    plan.tiles2[l] = (N2 + Shape<O>::WARPS - 1) / Shape<O>::WARPS;
    const long long level_blocks = (long long)batch * plan.tiles1[l] * plan.tiles2[l];
    if (blocks + level_blocks >= (1LL << 31)) return int(cudaErrorInvalidValue);
    plan.blocks[l] = int(level_blocks);
    blocks += level_blocks;
  }
  auto* headers = static_cast<Header*>(workspace);
  auto* taps = reinterpret_cast<RoiTaps<O>*>(headers + R);
  if (R > 0) {
    roi_meta_kernel<O><<<R, 32, 0, s>>>(levels, rois, batch, w_first, finest_scale, headers,
                                        taps);
    const int status = int(cudaGetLastError());
    if (status) return status;
  }
  switch (vec::chunk_width(levels, grad_out, C)) {
    case 8: return launch_width<O, 8>(levels, plan, headers, taps, grad_out, R, C, w_first, s);
    case 4: return launch_width<O, 4>(levels, plan, headers, taps, grad_out, R, C, w_first, s);
    case 2: return launch_width<O, 2>(levels, plan, headers, taps, grad_out, R, C, w_first, s);
    default: return launch_width<O, 1>(levels, plan, headers, taps, grad_out, R, C, w_first, s);
  }
}

}  // namespace owner

}  // namespace

namespace {

template <typename T, int O>
void launch_first(const RoiLevels& levels, const float* rois, void* out, int R, int batch, int C,
                  int w_first, float finest_scale, cudaStream_t s) {
  dim3 grid(R, (C + THREADS - 1) / THREADS);
  roi_align_kernel<T, O><<<grid, THREADS, 0, s>>>(levels, rois, static_cast<T*>(out), batch, C,
                                                  w_first, finest_scale);
}

bool valid_levels(const RoiLevels* levels) {
  return levels->num_levels >= 1 && levels->num_levels <= MAX_LEVELS;
}

}  // namespace

// levels: the level maps (B, Hl, Wl, C) contiguous, all of one dtype;
// rois (R, 5) float32 (batch index, x1, y1, x2, y2) in image pixels, where
// a RoI whose index lies outside [0, batch) pools zeros; out (R, O, O, C)
// with O = out_size, 7 or 14.  dtype 0 = float32, 1 = bfloat16 (O = 7 only:
// the vectorised entry serves bfloat16).  w_first = 1 contracts the W axis
// first (wide maps).
extern "C" int roi_align_launch(const RoiLevels* levels, const void* rois, void* out, int R,
                                int batch, int C, int dtype, int w_first, float finest_scale,
                                int out_size, void* stream) {
  if (!valid_levels(levels) || (out_size != 7 && out_size != 14) ||
      !(dtype == 0 || (dtype == 1 && out_size == 7)))
    return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  if (dtype == 0 && out_size == 7)
    launch_first<float, 7>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
  else if (dtype == 0)
    launch_first<float, 14>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
  else
    launch_first<__nv_bfloat16, 7>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
  return int(cudaGetLastError());
}

// The maps' gradient.  levels: float32 gradient maps (B, Hl, Wl, C),
// contiguous and zeroed by the caller, which this adds into; grad_out
// (R, O, O, C) of the feature type `dtype`, O = out_size, 7 or 14; the rest
// as above.
extern "C" int roi_align_backward_launch(const RoiLevels* levels, const void* rois,
                                         const void* grad_out, int R, int batch, int C,
                                         int dtype, int w_first, float finest_scale,
                                         int out_size, void* stream) {
  if (!valid_levels(levels) || (dtype != 0 && dtype != 1) || (out_size != 7 && out_size != 14))
    return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  dim3 grid(R, (C + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const auto go = [&](auto dt, auto o) {
    using T = decltype(dt);
    roi_align_backward_kernel<T, decltype(o)::value><<<grid, THREADS, 0, s>>>(
        *levels, r, static_cast<const T*>(grad_out), batch, C, w_first, finest_scale);
  };
  if (dtype == 0 && out_size == 7) go(float{}, std::integral_constant<int, 7>{});
  else if (dtype == 0) go(float{}, std::integral_constant<int, 14>{});
  else if (out_size == 7) go(__nv_bfloat16{}, std::integral_constant<int, 7>{});
  else go(__nv_bfloat16{}, std::integral_constant<int, 14>{});
  return int(cudaGetLastError());
}

// The vectorised version: the same arguments, bfloat16 only (dtype 1).
extern "C" int roi_align_bf16_launch(const RoiLevels* levels, const void* rois, void* out,
                                     int R, int batch, int C, int dtype, int w_first,
                                     float finest_scale, int out_size, void* stream) {
  if (!valid_levels(levels) || dtype != 1 || C < 1 || (out_size != 7 && out_size != 14))
    return int(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  if (out_size == 7)
    return vec::launch<7>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
  return vec::launch<14>(*levels, r, out, R, batch, C, w_first, finest_scale, s);
}

// The bf16 entry's workspace at O = out_size (7 or 14), in bytes: a header
// and the taps of every RoI; -1 for another size.
extern "C" long long roi_align_backward_bf16_workspace(int R, int out_size) {
  return out_size == 7 ? owner::workspace_bytes<7>(R)
                       : out_size == 14 ? owner::workspace_bytes<14>(R) : -1;
}

// The maps' gradient in bfloat16, deterministic.  levels: the bf16 gradient
// maps (B, Hl, Wl, C), contiguous, which this writes whole (the caller
// need not zero them); grad_out (R, O, O, C) bf16, O = out_size, 7 or 14;
// dtype must be 1; workspace: device memory of
// `roi_align_backward_bf16_workspace(R, out_size)` bytes or more, 16-byte
// aligned.  The rest as for the float32 entry.
extern "C" int roi_align_backward_bf16_launch(const RoiLevels* levels, const void* rois,
                                              const void* grad_out, int R, int batch, int C,
                                              int dtype, int w_first, float finest_scale,
                                              int out_size, void* workspace,
                                              long long workspace_bytes, void* stream) {
  const long long need = roi_align_backward_bf16_workspace(R, out_size);
  if (!valid_levels(levels) || dtype != 1 || C < 1 || R < 0 || batch < 0 || need < 0 ||
      workspace_bytes < need || reinterpret_cast<uintptr_t>(workspace) % 16)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  if (out_size == 7)
    return owner::launch<7>(*levels, r, grad_out, R, batch, C, w_first, finest_scale, workspace,
                            s);
  return owner::launch<14>(*levels, r, grad_out, R, batch, C, w_first, finest_scale, workspace,
                           s);
}
