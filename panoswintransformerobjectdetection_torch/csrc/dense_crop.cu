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
// the block-diagonal Wx assembled from concatenations.
//
// What bounds it on the H100: operations.  At the flagship's finest level
// (B 2, P 640, Hl 256, Wl 128 after the wide-map transpose, C 256) stage
// one is 150 GFLOP and stage two 4 GFLOP, against 34 MB of features, 3.4 MB
// of weights and 32 MB of output in bf16: 0.156 ms at the 989 TFLOP/s of
// the bf16 tensor cores.
//
// bfloat16 entry (`dense_crop_bf16_launch`), on the tensor cores.  Stage one
// is, per image, the GEMM t[(p, i), (w, c)] = sum_h Wy[(p, i), h] F[h, (w, c)]
// with K = Hl, on `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`.  One
// block of 8 warps takes 18 RoIs (126 rows of t, padded to an M tile of
// 128) and 16 channels, and walks the level in passes of 8 columns w, N =
// 8 w x 16 c = 128; a warp keeps a 64 x 32 tile of f32 accumulators.  Wy
// stays in shared memory for the whole block (up to a padded Hl of 384;
// past that its k-tiles stream beside F's); F comes in k-tiles of 64 rows h
// through a `cp.async` ring of 4, so three load while one multiplies.  Both
// stay bf16, with rows padded by 16 bytes so that `ldmatrix` (`.trans` for
// F, which is row-major over h) hits no bank twice.  The wrapper lays F out
// channel-tile-major, (B, C / 16, Hl, Wl, 16), so that a block's rows are
// whole 128-byte lines: one copy, which the dense route makes anyway to
// transpose its wide maps.  Once a pass's K sum is complete, t is rounded
// to bf16 where the twin rounds it and parked in shared memory.  Stage two,
// out[p, i, x, c] = sum_w Wx[p, x, w] t[p, i, w, c], is 2.5% of the
// operations but would cost a third of the time on the CUDA cores, so it
// runs on `mma.sync.m16n8k8` too, with the roles chosen so that little is
// padded: per (RoI, bin i) the 16 channels are M, the pass's 8 columns w
// are K and the 7 output bins x are N, padded to 8.  Its accumulators (16
// m16n8 tiles a warp) stay in registers across the passes; at the end they
// are rounded and leave through shared memory as 16-byte stores.  Blocks
// are ordered RoI block fastest, so the blocks in flight share one image's
// 16-channel slice of the level (1 MB at level 0) while it sits in L2.
// Ragged P, Hl and Wl are masked with zeros by cp.async's zero fill; the
// wrapper pads C to a multiple of 16 and Wy's h to a multiple of 8 with
// zeros.  Tensor-core sums run in another order than the twin's and need
// not round every addition as IEEE does; the stated bf16 tolerances allow
// for that.
//
// What holds it far above its bound is not the multiply: a version without
// the stage-one `mma`s took as long, and one with `wgmma` for stage one
// (operands read by the tensor cores straight from shared memory) was
// slower.  Fetching F is: without F's copies it ran markedly faster.  One
// block of 8 warps fits an SM (the registers hold stage two's accumulators
// beside stage one's), so nothing but the ring hides a k-tile's trip from
// L2.
//
// float32 entry (`dense_crop_f32_launch`), on the tensor cores in 3xTF32
// (`tf32.cuh`: each operand split into a TF32 hi and lo, lo.hi + hi.lo +
// hi.hi with f32 sums), since one TF32 product keeps 10 bits of mantissa
// and breaks the f32 tolerance.  The bfloat16 entry's structure on
// `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`: 18 RoIs and 16
// channels a block, the channel-tile-major F, passes of 8 columns w, 8
// warps each with a 64 x 32 tile of t, stage two on the tensor cores.
// What f32 changes: F's k-tiles and Wy's take twice the bytes, and Wy its
// hi and lo besides, so Wy cannot stay resident: k-tiles of 32 rows h
// stream through a `cp.async` ring of 3 slots, each Wy's hi and lo (split
// on the host, `roi_align.crop_f32_operands`; A fragments by `ldmatrix`,
// which reads 32-bit elements as pairs) and F (B fragments by scalar loads
// from rows padded to 136 floats, split in registers as they load).  t is
// parked unrounded (the f32 twin does not round it) and split as stage
// two reads it; Wx's hi and lo come from global memory (L2), since three
// slots and t fill 226 KB of shared memory.  Stage one's accumulators live
// for one pass, so that stage two's fragments find registers.  A block
// takes one k-tile at the coarsest level, where the ring's latency shows:
// there the first version is faster.
//
// CUDA-core entry (`dense_crop_launch`), the first version, float32 and
// bfloat16: no wrapper calls it; `chip_smoke.py` times the redesigns
// against it (`roi_align.CROP_FIRST_VERSION`).  One block per (image, 8
// RoIs, 32 channels) walks over the level in strips of 8 columns; a
// thread holds a 7 x 8 register tile of t, then its (RoI, channel)'s 7 x 7
// outputs, and fetches its share of the next tile into registers before
// it works on the current one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"   // rna_tf32, split, mma_tf32, mma_3xtf32 (namespace tf32)

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

// ----------------------------------------------------------------- bfloat16

namespace tc {

constexpr int RB = 18;                  // RoIs per block: 126 rows of t
constexpr int MT = 128;                 // rows of the stage-one M tile
constexpr int CT = 16;                  // channels per block
constexpr int WP = 8;                   // columns w per pass: stage two's k8
constexpr int NP = WP * CT;             // 128 (w, c) columns of a pass
constexpr int KT = 64;                  // rows h per k-tile
constexpr int STAGES = 4;               // cp.async ring
constexpr int RESIDENT_H = 384;         // Wy stays in shared memory up to this padded Hl
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARPS_N = 4;              // warps across the pass's 128 columns: 32 each
constexpr int MI = MT / (WARPS / WARPS_N) / 16;   // m16 tiles of a warp's rows
constexpr int PAD = 8;                  // bf16 elements (16 bytes) of row padding
constexpr int A_LD = KT + PAD;          // streamed Wy tile row stride
constexpr int B_LD = NP + PAD;          // F tile row stride
constexpr int T_LD = NP + PAD;          // t row stride
constexpr int X_LD = WP + PAD;          // Wx row stride
constexpr int TILES2 = (RB * O + WARPS - 1) / WARPS;   // stage-two (RoI, bin) tiles a warp
constexpr int WXR = (RB * 8 * WP + THREADS - 1) / THREADS;   // Wx values a thread loads a pass
static_assert(RB * O <= MT && NP == WARPS_N * 32 && MI >= 1, "warp grid of (MI x 16) x 32");
static_assert(RB * O * O * CT <= MT * T_LD, "the output tile fits in s.t");

// Shared memory, in bytes from the start: Wy, whole when its padded height
// Hk is at most RESIDENT_H ([row (p, i)][h], loaded once), else a ring of
// k-tiles beside F's; the ring of F k-tiles ([h][(w, c)]); t of a pass
// ([(p, i)][(w, c)]); Wx of a pass ([p][x][w], x padded to 8).
struct Layout {
  bool resident;
  int wy_ld;
  size_t wy, b, t, wx, total;
};

__host__ __device__ inline Layout layout(int Hl) {
  Layout L;
  const int Hk = (Hl + KT - 1) / KT * KT;
  L.resident = Hk <= RESIDENT_H;
  L.wy_ld = L.resident ? Hk + PAD : A_LD;
  L.wy = 0;
  L.b = L.wy + size_t(L.resident ? 1 : STAGES) * MT * L.wy_ld * 2;
  L.t = L.b + size_t(STAGES) * KT * B_LD * 2;
  L.wx = L.t + size_t(MT) * T_LD * 2;
  L.total = L.wx + size_t(RB) * 8 * X_LD * 2;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a (16 x 8, row) . b (8 x 8, col)
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// feat (B, C / 16, Hl, Wl, 16) with C % 16 == 0, channel-tile-major; Wy
// (B, P, 7, Hp) with Hp % 8 == 0, zero past Hl; Wx (B, P, 7, Wl); out
// (B, P, 7, 7, C).
__global__ void __launch_bounds__(THREADS, 1)
dense_crop_tc_kernel(const __nv_bfloat16* __restrict__ feat, const __nv_bfloat16* __restrict__ Wy,
                     const __nv_bfloat16* __restrict__ Wx, __nv_bfloat16* __restrict__ out, int P,
                     int Hl, int Hp, int Wl, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(Hl);
  __nv_bfloat16* wy_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wy);
  __nv_bfloat16* f_s = reinterpret_cast<__nv_bfloat16*>(smem + L.b);
  __nv_bfloat16* t_s = reinterpret_cast<__nv_bfloat16*>(smem + L.t);
  __nv_bfloat16* wx_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wx);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;          // mma fragment row group and column pair
  const int p0 = blockIdx.x * RB, c0 = blockIdx.y * CT, b = blockIdx.z;
  const int rows = min(RB, P - p0) * O;          // valid rows of t
  const __nv_bfloat16* fb = feat + (size_t(b) * C + c0) * Hl * Wl;   // this block's channel tile
  const __nv_bfloat16* wyb = Wy + (size_t(b) * P + p0) * O * Hp;
  const __nv_bfloat16* wxb = Wx + (size_t(b) * P + p0) * O * Wl;

  const int nk = (Hl + KT - 1) / KT;             // k-tiles a pass
  const int npass = (Wl + WP - 1) / WP;
  const int total = npass * nk;                  // k-tiles over all passes

  // Wy rows x 8-column chunks [h0, h0 + 8 * chunks), zero past Hp and rows
  auto load_wy = [&](__nv_bfloat16* dst, int h0, int chunks) {
    for (int e = tid; e < MT * chunks; e += THREADS) {
      const int r = e / chunks, h = h0 + (e % chunks) * 8;
      const bool ok = r < rows && h < Hp;
      cp_async16(dst + r * L.wy_ld + (h - h0), ok ? wyb + size_t(r) * Hp + h : Wy, ok);
    }
  };
  // k-tile `it` of the flat sequence (pass, k-tile) into ring slot it % STAGES:
  // F 64 rows h x 16 chunks of (w, 8 c), and Wy's k-tile unless it is resident
  auto load = [&](int it) {
    if (it < total) {
      const int h0 = (it % nk) * KT, w0 = (it / nk) * WP, slot = it % STAGES;
#pragma unroll
      for (int j = 0; j < (KT * 16 + THREADS - 1) / THREADS; ++j) {
        const int e = tid + j * THREADS;
        const int k = e / 16, wl = (e % 16) / 2, ch = e % 2;
        if (k >= KT) break;
        const int h = h0 + k, w = w0 + wl;
        const bool ok = h < Hl && w < Wl;
        cp_async16(f_s + (slot * KT + k) * B_LD + wl * CT + ch * 8,
                   ok ? fb + (size_t(h) * Wl + w) * CT + ch * 8 : feat, ok);
      }
      if (!L.resident) load_wy(wy_s + slot * MT * A_LD, h0, KT / 8);
    }
    cp_async_commit();
  };

  // stage one: warp (wm, wn) owns rows wm * MI * 16 .. and pass columns wn * 32 .. + 32
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float acc[MI][4][4];
  // stage two: warp owns (RoI, bin) tiles j = warp + WARPS * k
  float acc2[TILES2][4];
#pragma unroll
  for (int k = 0; k < TILES2; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[k][e] = 0.f;
#pragma unroll
  for (int m = 0; m < MI; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  if (L.resident) load_wy(wy_s, 0, (L.wy_ld - PAD) / 8);    // joins k-tile 0's group
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) load(st);

  uint16_t wx_r[WXR];            // this thread's share of the pass's Wx, fetched early
  for (int it = 0; it < total; ++it) {
    const int kt = it % nk, pass = it / nk;
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < WXR; ++j) {
        const int e = tid + j * THREADS;
        const int p = e / (8 * WP), x = (e / WP) % 8, w = pass * WP + e % WP;
        const bool ok = e < RB * 8 * WP && p * O < rows && x < O && w < Wl;
        wx_r[j] = ok ? reinterpret_cast<const uint16_t*>(wxb)[(size_t(p) * O + x) * Wl + w] : 0;
      }
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // tile `it` has landed; slot (it - 1) % STAGES is free
    load(it + STAGES - 1);
    const int slot = it % STAGES;
    const __nv_bfloat16* a_t = L.resident ? wy_s + kt * KT : wy_s + slot * MT * A_LD;
    const __nv_bfloat16* f_t = f_s + slot * KT * B_LD;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int m = 0; m < MI; ++m)
        ldmatrix_x4(af[m], a_t + ((wm * MI + m) * 16 + (lane & 15)) * L.wy_ld + kk +
                               (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, f_t + (kk + (lane & 15)) * B_LD + wn * 32 + n * 8 +
                                  (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < MI; ++m) {
          mma_k16(acc[m][n], af[m], bf[0], bf[1]);
          mma_k16(acc[m][n + 1], af[m], bf[2], bf[3]);
        }
      }
    }
    if (kt != nk - 1) continue;

    // The pass's K sum is complete: round t to bf16 and park it with the
    // pass's Wx.  Every reader of s.t and s.wx from the last pass's stage
    // two has passed the barrier at the top of this iteration.
#pragma unroll
    for (int m = 0; m < MI; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int r = (wm * MI + m) * 16 + g, col = wn * 32 + n * 8 + 2 * q;
        *reinterpret_cast<uint32_t*>(t_s + r * T_LD + col) =
            pack_bf16(acc[m][n][0], acc[m][n][1]);
        *reinterpret_cast<uint32_t*>(t_s + (r + 8) * T_LD + col) =
            pack_bf16(acc[m][n][2], acc[m][n][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      }
#pragma unroll
    for (int j = 0; j < WXR; ++j) {
      const int e = tid + j * THREADS;
      if (e < RB * 8 * WP)
        reinterpret_cast<uint16_t*>(wx_s)[(e / WP) * X_LD + e % WP] = wx_r[j];
    }
    __syncthreads();

    // stage two for the pass: out[(p, i)][c][x] += t[(p, i)][c][w] . Wx[p][w][x],
    // M = 16 channels, K = the pass's 8 columns w, N = 7 bins x padded to 8
#pragma unroll
    for (int k = 0; k < TILES2; ++k) {
      const int j = warp + WARPS * k;            // row (p, i) of t
      if (j >= rows) break;
      // A[m = c][k = w] from t[j][w * 16 + c]: memory rows are w, so .trans
      uint32_t af[2];
      ldmatrix_x2_trans(af, t_s + j * T_LD + (lane & 7) * CT + ((lane >> 3) & 1) * 8);
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(wx_s + ((j / O) * 8 + g) * X_LD + 2 * q);
      mma_k8(acc2[k], af, b0);
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // every reader of s.t is done: it becomes the output tile

  // acc2[k] of tile j = (p, i) holds out[p][i][x = 2q, 2q + 1][c = g, g + 8]
  __nv_bfloat16* o_s = t_s;                      // [p][i][x][c], 16 channels a row
#pragma unroll
  for (int k = 0; k < TILES2; ++k) {
    const int j = warp + WARPS * k;
    if (j >= rows) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 2 * q + (e & 1), c = g + (e >> 1) * 8;
      if (x < O) o_s[(j * O + x) * CT + c] = __float2bfloat16_rn(acc2[k][e]);
    }
  }
  __syncthreads();
  // 16-byte stores: 2 a (p, i, x) row of 16 channels
  __nv_bfloat16* ob = out + (size_t(b) * P + p0) * O * O * C;
  for (int e = tid; e < rows * O * 2; e += THREADS) {
    const int r = e / 2, ch = e % 2;             // r = (p, i, x)
    if (c0 + ch * 8 < C)
      *reinterpret_cast<uint4*>(ob + size_t(r) * C + c0 + ch * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * CT + ch * 8);
  }
}

int launch(const __nv_bfloat16* feat, const __nv_bfloat16* Wy, const __nv_bfloat16* Wx,
           __nv_bfloat16* out, int B, int P, int Hl, int Hp, int Wl, int C,
           cudaStream_t stream) {
  if (C % CT != 0 || Hp % 8 != 0 || Hp < Hl || C / CT > 65535)
    return int(cudaErrorInvalidValue);
  const size_t smem = layout(Hl).total;
  cudaError_t err = cudaFuncSetAttribute(dense_crop_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((P + RB - 1) / RB, (C + CT - 1) / CT, B);
  dense_crop_tc_kernel<<<grid, THREADS, smem, stream>>>(feat, Wy, Wx, out, P, Hl, Hp, Wl, C);
  return int(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------------------------------------ float32

namespace tf32 {

constexpr int RB = 18;                  // RoIs per block: 126 rows of t
constexpr int MT = 128;                 // rows of the stage-one M tile
constexpr int CT = 16;                  // channels per block
constexpr int WP = 8;                   // columns w per pass: stage two's k8
constexpr int NP = WP * CT;             // 128 (w, c) columns of a pass
constexpr int KT = 32;                  // rows h per k-tile
constexpr int STAGES = 3;               // cp.async ring
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARPS_N = 4;              // warps across the pass's 128 columns: 32 each
constexpr int MI = MT / (WARPS / WARPS_N) / 16;   // m16 tiles of a warp's rows
constexpr int A_LD = KT + 4;            // Wy tile row stride, floats: ldmatrix rows on 9 banks' offsets
constexpr int B_LD = NP + 8;            // F tile row stride: lanes (g, q) read 32 distinct banks
constexpr int T_LD = NP + 8;            // t row stride
constexpr int TROWS = RB * O;           // rows of t
constexpr int TILES2 = (TROWS + WARPS - 1) / WARPS;   // stage-two (RoI, bin) tiles a warp
constexpr int SLOT = 2 * MT * A_LD + KT * B_LD;       // floats of a ring slot: Wy hi, Wy lo, F
constexpr size_t SMEM = (size_t(STAGES) * SLOT + size_t(TROWS) * T_LD) * 4;
static_assert(TROWS <= MT && NP == WARPS_N * 32 && MI >= 1, "warp grid of (MI x 16) x 32");
static_assert(TROWS * O * CT <= TROWS * T_LD, "the output tile fits in s.t");
static_assert(SMEM <= 227 * 1024, "one block an SM");

// feat (B, C / 16, Hl, Wl, 16) with C % 16 == 0, channel-tile-major; Wy
// (2, B, P, 7, Hp), TF32 hi then lo, Hp % 4 == 0, zero past Hl; Wx (2, B, P,
// 7, Wl), TF32 hi then lo; out (B, P, 7, 7, C).
__global__ void __launch_bounds__(THREADS, 1)
dense_crop_tf32_kernel(const float* __restrict__ feat, const float* __restrict__ Wy,
                       const float* __restrict__ Wx, float* __restrict__ out, int B, int P,
                       int Hl, int Hp, int Wl, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // slot: [Wy hi][MT][A_LD], [Wy lo], [F][KT][B_LD]
  float* t_s = ring + STAGES * SLOT;             // t of a pass, [(p, i)][(w, c)]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;          // mma fragment row group and column
  const int p0 = blockIdx.x * RB, c0 = blockIdx.y * CT, b = blockIdx.z;
  const int rows = min(RB, P - p0) * O;          // valid rows of t
  const float* fb = feat + (size_t(b) * C + c0) * Hl * Wl;   // this block's channel tile
  const size_t wy_lo = size_t(B) * P * O * Hp, wx_lo = size_t(B) * P * O * Wl;
  const float* wyb = Wy + (size_t(b) * P + p0) * O * Hp;
  const float* wxb = Wx + (size_t(b) * P + p0) * O * Wl;

  const int nk = (Hl + KT - 1) / KT;             // k-tiles a pass
  const int npass = (Wl + WP - 1) / WP;
  const int total = npass * nk;                  // k-tiles over all passes

  // k-tile `it` of the flat sequence (pass, k-tile) into ring slot it %
  // STAGES: F KT rows h x 32 chunks of (w, 4 c); Wy hi and lo, MT rows x
  // KT / 4 chunks of 4 h each; zeros past Hl, Wl, Hp and the valid rows
  auto load = [&](int it) {
    if (it < total) {
      const int h0 = (it % nk) * KT, w0 = (it / nk) * WP;
      float* a_hi = ring + (it % STAGES) * SLOT;
      float* a_lo = a_hi + MT * A_LD;
      float* f_s = a_lo + MT * A_LD;
#pragma unroll
      for (int j = 0; j < KT * WP * 4 / THREADS; ++j) {
        const int e = tid + j * THREADS;
        const int k = e / (WP * 4), wl = (e / 4) % WP, ch = e % 4;
        const int h = h0 + k, w = w0 + wl;
        const bool ok = h < Hl && w < Wl;
        tc::cp_async16(f_s + k * B_LD + wl * CT + ch * 4,
                       ok ? fb + (size_t(h) * Wl + w) * CT + ch * 4 : feat, ok);
      }
#pragma unroll
      for (int j = 0; j < MT * (KT / 4) / THREADS; ++j) {
        const int e = tid + j * THREADS;
        const int r = e / (KT / 4), hc = (e % (KT / 4)) * 4;
        const bool ok = r < rows && h0 + hc < Hp;
        const float* src = wyb + size_t(r) * Hp + h0 + hc;
        tc::cp_async16(a_hi + r * A_LD + hc, ok ? src : Wy, ok);
        tc::cp_async16(a_lo + r * A_LD + hc, ok ? src + wy_lo : Wy, ok);
      }
    }
    tc::cp_async_commit();
  };

  // stage one: warp (wm, wn) owns rows wm * MI * 16 .. and pass columns wn * 32 .. + 32
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // stage two: warp owns (RoI, bin) tiles j = warp + WARPS * k
  float acc2[TILES2][4];
#pragma unroll
  for (int k = 0; k < TILES2; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[k][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) load(st);

  for (int pass = 0; pass < npass; ++pass) {
    // stage one's accumulators live within a pass only, so that their
    // registers are free for stage two's fragments
    float acc[MI][4][4];
#pragma unroll
    for (int m = 0; m < MI; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int it = pass * nk + kt;
      tc::cp_async_wait<STAGES - 2>();
      __syncthreads();             // tile `it` has landed; slot (it - 1) % STAGES is free
      load(it + STAGES - 1);
      const float* a_hi = ring + (it % STAGES) * SLOT;
      const float* a_lo = a_hi + MT * A_LD;
      const float* f_s = a_lo + MT * A_LD;
#pragma unroll
      for (int kk = 0; kk < KT; kk += 8) {
        // F's B fragments, (k = q, n = g) and (q + 4, g), by scalar loads, split
        uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* col = f_s + (kk + q) * B_LD + wn * 32 + n * 8 + g;
          split(col[0], b_hi[n][0], b_lo[n][0]);
          split(col[4 * B_LD], b_hi[n][1], b_lo[n][1]);
        }
#pragma unroll
        for (int m = 0; m < MI; ++m) {
          // Wy's A fragments, split on the host: matrices rows +0 .. 7 and
          // +8 .. 15 at h kk .. kk + 3, then at kk + 4 .. kk + 7
          uint32_t ah[4], al[4];
          const int off = ((wm * MI + m) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * A_LD + kk +
                          (lane >> 4) * 4;
          tc::ldmatrix_x4(ah, a_hi + off);
          tc::ldmatrix_x4(al, a_lo + off);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_3xtf32(acc[m][n], ah, al, b_hi[n][0], b_hi[n][1], b_lo[n][0], b_lo[n][1]);
        }
      }
    }

    // The pass's K sum is complete: park t (f32, not rounded) in s.t.
    // Every reader of s.t from the last pass's stage two has passed the
    // barrier at the top of the pass's last k-tile.
#pragma unroll
    for (int m = 0; m < MI; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int r = (wm * MI + m) * 16 + g, col = wn * 32 + n * 8 + 2 * q;
        if (r < TROWS)
          *reinterpret_cast<float2*>(t_s + r * T_LD + col) = make_float2(acc[m][n][0], acc[m][n][1]);
        if (r + 8 < TROWS)
          *reinterpret_cast<float2*>(t_s + (r + 8) * T_LD + col) =
              make_float2(acc[m][n][2], acc[m][n][3]);
      }
    __syncthreads();

    // stage two for the pass: out[(p, i)][c][x] += t[(p, i)][c][w] . Wx[p][w][x],
    // M = 16 channels, K = the pass's 8 columns w, N = 7 bins x padded to 8.
    // Wx's B fragments (k = w q, n = x g), split on the host, come from
    // global memory (L2): all of the warp's first, then the products.
    const int w = pass * WP + q;
    uint32_t wx[TILES2][4];
#pragma unroll
    for (int k = 0; k < TILES2; ++k) {
      const int j = warp + WARPS * k;            // row (p, i) of t
      const float* src = wxb + (size_t(j / O) * O + g) * Wl + w;
      const bool in = j < rows && g < O;
      wx[k][0] = in && w < Wl ? __float_as_uint(src[0]) : 0u;
      wx[k][1] = in && w + 4 < Wl ? __float_as_uint(src[4]) : 0u;
      wx[k][2] = in && w < Wl ? __float_as_uint(src[wx_lo]) : 0u;
      wx[k][3] = in && w + 4 < Wl ? __float_as_uint(src[wx_lo + 4]) : 0u;
    }
#pragma unroll
    for (int k = 0; k < TILES2; ++k) {
      const int j = warp + WARPS * k;
      if (j >= rows) break;
      // A[m = c][k = w] from t[j][w * 16 + c]: (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
      const float* tj = t_s + j * T_LD + q * CT + g;
      uint32_t ah[4], al[4];
      split(tj[0], ah[0], al[0]);
      split(tj[8], ah[1], al[1]);
      split(tj[4 * CT], ah[2], al[2]);
      split(tj[4 * CT + 8], ah[3], al[3]);
      mma_3xtf32(acc2[k], ah, al, wx[k][0], wx[k][1], wx[k][2], wx[k][3]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();              // every reader of s.t is done: it becomes the output tile

  // acc2[k] of tile j = (p, i) holds out[p][i][x = 2q, 2q + 1][c = g, g + 8]
  float* o_s = t_s;                              // [p][i][x][c], 16 channels a row
#pragma unroll
  for (int k = 0; k < TILES2; ++k) {
    const int j = warp + WARPS * k;
    if (j >= rows) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 2 * q + (e & 1), c = g + (e >> 1) * 8;
      if (x < O) o_s[(j * O + x) * CT + c] = acc2[k][e];
    }
  }
  __syncthreads();
  // 16-byte stores: 4 a (p, i, x) row of 16 channels
  float* ob = out + (size_t(b) * P + p0) * O * O * C;
  for (int e = tid; e < rows * O * 4; e += THREADS) {
    const int r = e / 4, ch = e % 4;             // r = (p, i, x)
    *reinterpret_cast<float4*>(ob + size_t(r) * C + c0 + ch * 4) =
        *reinterpret_cast<const float4*>(o_s + r * CT + ch * 4);
  }
}

int launch(const float* feat, const float* Wy, const float* Wx, float* out, int B, int P, int Hl,
           int Hp, int Wl, int C, cudaStream_t stream) {
  if (C % CT != 0 || Hp % 4 != 0 || Hp < Hl || C / CT > 65535)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(dense_crop_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  dim3 grid((P + RB - 1) / RB, C / CT, B);
  dense_crop_tf32_kernel<<<grid, THREADS, SMEM, stream>>>(feat, Wy, Wx, out, B, P, Hl, Hp, Wl, C);
  return int(cudaGetLastError());
}

}  // namespace tf32

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

// feat (B, C / 16, Hl, Wl, 16) with C a multiple of 16, Wy (B, P, 7, Hp)
// with Hp a multiple of 8 and zeros past Hl, Wx (B, P, 7, Wl), out
// (B, P, 7, 7, C), all contiguous bfloat16.
extern "C" int dense_crop_bf16_launch(const void* feat, const void* Wy, const void* Wx,
                                      void* out, int B, int P, int Hl, int Hp, int Wl, int C,
                                      int o, void* stream) {
  if (o != O || B < 1 || P < 1 || C < 1 || Hl < 1 || Wl < 1 || B > 65535)
    return int(cudaErrorInvalidValue);
  return tc::launch(static_cast<const __nv_bfloat16*>(feat),
                    static_cast<const __nv_bfloat16*>(Wy), static_cast<const __nv_bfloat16*>(Wx),
                    static_cast<__nv_bfloat16*>(out), B, P, Hl, Hp, Wl, C,
                    static_cast<cudaStream_t>(stream));
}

// feat (B, C / 16, Hl, Wl, 16) with C a multiple of 16, Wy (2, B, P, 7, Hp)
// with Hp a multiple of 4 and zeros past Hl, Wx (2, B, P, 7, Wl), each
// weight tensor its TF32 hi then its lo (`roi_align.crop_f32_operands`),
// out (B, P, 7, 7, C), all contiguous float32.
extern "C" int dense_crop_f32_launch(const void* feat, const void* Wy, const void* Wx,
                                     void* out, int B, int P, int Hl, int Hp, int Wl, int C,
                                     int o, void* stream) {
  if (o != O || B < 1 || P < 1 || C < 1 || Hl < 1 || Wl < 1 || B > 65535)
    return int(cudaErrorInvalidValue);
  return tf32::launch(static_cast<const float*>(feat), static_cast<const float*>(Wy),
                      static_cast<const float*>(Wx), static_cast<float*>(out), B, P, Hl, Hp, Wl,
                      C, static_cast<cudaStream_t>(stream));
}
