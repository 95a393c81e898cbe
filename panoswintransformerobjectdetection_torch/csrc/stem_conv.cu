// Fused PanoSwin stem: h1 = relu(conv3x3(relu(conv3x3(x, w0) + b0), w1) + b1).
//
// Replaces the Pallas kernel `_stem2cm_kernel`
// (panoswintransformerobjectdetection_tpu/ops/stem_conv.py:61), the first
// two convolutions of the 3-conv patch stem with BatchNorm folded into the
// weights.  The 4x4/4 patch projection that follows stays a library
// convolution, as it does in the JAX package.  Both versions keep h0 out of
// device memory.  Output is (B, c1, H, W) in the compute type.
//
// What bounds the bfloat16 entry on the H100: bytes.  At the flagship's
// (2, 512, 1024, 3) input with c0 = 32, c1 = 64 the work is 40.5 GFLOP
// (38.6 of them the second convolution, K = 9 * 32 = 288, N = 64) against
// 6.3 MB read and 134 MB written in bf16: 0.042 ms at 3.35 TB/s, 0.041 ms at
// the bf16 tensor cores' 989 TFLOP/s.
//
// bfloat16 entry (`stem_conv_bf16_launch`), on the tensor cores.  Each block
// keeps the weights in shared memory and walks over output tiles of 4 rows
// x 64 columns (persistent: as many blocks as fit on the card, so the 36 KB
// of w1 are read once a block).  A tile stages its 3-channel input with a
// 2-pixel halo, then computes h0 over the tile plus a 1-pixel halo as an
// im2col GEMM on `mma.sync.m16n8k16` (K = 27 taps x channels, padded to 32;
// the A fragments are gathered from the input tile through a per-thread
// table of tap offsets), adds b0 in f32, applies ReLU, zeroes h0 outside the
// image because conv1 zero-pads, rounds h0 to bf16 and stores it
// channels-last, [pixel][c0], with rows padded by 16 bytes.  conv1 is an
// implicit GEMM: M = the tile's 256 pixels (a warp takes 32 of one row),
// N = c1 in groups of 64, K = 9 taps x c0.  For a tap (dy, dx) and a k16
// slice of c0, the A fragment comes from `ldmatrix` on h0 rows shifted by
// (dy, dx) (each lane gives its own row address, so the shift costs
// nothing) and the B fragment from w1 in shared memory, [tap][c1][c0] with
// padded rows; the padding keeps both `ldmatrix` patterns free of bank
// conflicts.  The epilogue adds b1, applies ReLU, rounds to bf16 and stages
// 32 channels at a time in shared memory, so that the store to the
// (B, c1, H, W) output is 16 bytes a thread and coalesced along W.  The
// wrapper lays the weights out once (`stem_weights`) with c0 and c1 padded
// to multiples of 16 by zero weights, so any c0 and c1 whose weights fit in
// shared memory are accepted.  Any H and W; the ragged edge is masked.
// Tensor-core sums run in another order than the twin's; the stated bf16
// tolerance allows for that.
//
// float32 entry (`stem_conv_f32_launch`), on the tensor cores in 3xTF32.  A
// single TF32 product keeps 10 bits of mantissa and breaks the f32
// tolerance, so each operand is split, a = hi + lo with hi = TF32(a) and lo
// = TF32(a - hi) (rounded to nearest, ties away, as `cvt.rna.tf32.f32`
// rounds, here by two integer instructions), and each product taken as
// lo.hi + hi.lo + hi.hi (the lo.lo term, about 2**-22 of it, is dropped),
// all accumulated in f32.  What bounds it: operations.  At the flagship's
// shape the 40.5 GFLOP take 0.604 ms at the CUDA cores' 67 TFLOP/s, and
// three TF32 products of them 0.245 ms at 495 TFLOP/s (165 effective);
// 281 MB of f32 bytes take 0.084 ms.  The bfloat16 entry's structure:
// persistent blocks, one an SM (220 KB of shared memory at c0 = 32, c1 =
// 64), each walking 4 x 64 output tiles, with the weights in shared memory
// once a block, split on the host (`stem_weights`).  A tile's input, with
// its 2-pixel halo, comes by `cp.async` into one of two buffers while the
// tile before runs conv1.  conv0 is an im2col GEMM on `mma.sync.m16n8k8`
// (M = the 396 h0 pixels of the tile and its halo, K = 27 padded to 32; A
// gathered from the input tile through a table of tap offsets and split
// in registers, B in 16-byte loads of a lane's hi and lo) into h0, f32,
// channels-last, its 16-byte chunks XOR-swizzled by pixel parity so that
// the A loads of neighbouring pixels fall on different banks.  conv1 is
// the implicit GEMM over the 9 taps on `wgmma.m64n64k8.tf32`, A from
// registers, B from shared memory as hi and lo tiles of 64 x 8 in the
// 8-row x 16-byte core matrices `wgmma` reads: each of the two
// warpgroups takes two output rows (two m64 blocks), a lane's 16-byte
// load of h0 gives it 4 channels of one pixel, which serve two k8 slices
// (channel 16cb + 4q + 2h (+1) is k = q (q + 4) of slice h; the host
// orders B the same way), split in registers into hi and lo.  A step (a
// tap, 16 channels) is 12 wgmmas, run asynchronously; the warps load
// and split the next step's A into a second register buffer meanwhile,
// and wait for a step's wgmmas only before that buffer is written again.
// On `mma.sync` conv1 ran at about half that instruction's rate: eight
// warps an SM could not hide the splits and loads.  The epilogue adds b1,
// applies ReLU and stores each accumulator straight to (B, c1, H, W): a
// warp's store is 4 channels x 8 neighbouring pixels, four whole 32-byte
// sectors.  What holds it above its bound: one block an SM runs conv0,
// conv1 and the epilogue of a tile one after the other, and the tensor
// cores wait through conv0 and the stores; a second h0 buffer, which
// would let them overlap, does not fit beside w1's hi and lo (147 KB).
// The tensor cores add in another order, and with another rounding, than
// an FFMA chain; the stated f32 tolerance allows for that.
//
// CUDA-core entry (`stem_conv_launch`), the first version, float32 and
// bfloat16: no wrapper calls it; it is there so that `chip_smoke.py` times
// both redesigns against it.  One block per (image, 8-row x 32-column
// output tile), one thread per output pixel; h0 for the tile plus its halo
// in shared memory; each thread accumulates 16 output channels at a time
// from h0 and w1 ([tap][cin][cout], read at one address by every thread of
// a warp, which shared memory broadcasts).  It reached 31% of the FFMA
// bound in f32: every 16 FFMAs take one h0 and four 16-byte weight loads
// from shared memory, and one block of 8 warps fits an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"   // rna_tf32, split, mma_tf32 (namespace tf32)

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block (one warp)
constexpr int CB = 16;   // output channels per register pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 consecutive weights from 16-byte aligned shared memory.
__device__ __forceinline__ void load16(const float* p, float* w) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 a = q[i];
    w[4 * i] = a.x; w[4 * i + 1] = a.y; w[4 * i + 2] = a.z; w[4 * i + 3] = a.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* w) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 a = q[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      w[8 * i + 2 * j] = f.x;
      w[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Smem {
  size_t w1, w0, h0, xs, b0, total;
};

__host__ __device__ inline Smem smem_layout(int c0, int c1p, size_t tsize) {
  Smem s;
  s.w1 = 0;
  s.w0 = align16(s.w1 + size_t(9) * c0 * c1p * tsize);
  s.h0 = align16(s.w0 + size_t(27) * c0 * tsize);
  s.xs = align16(s.h0 + size_t(TH + 2) * (TW + 2) * c0 * tsize);
  s.b0 = align16(s.xs + size_t(3) * (TH + 4) * (TW + 4) * sizeof(float));
  s.total = align16(s.b0 + size_t(c0) * sizeof(float));
  return s;
}

template <typename T>
__global__ void stem_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                            const float* __restrict__ b0, const T* __restrict__ w1,
                            const float* __restrict__ b1, T* __restrict__ out,
                            int H, int W, int c0, int c1, int c1p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(c0, c1p, sizeof(T));
  T* w1s = reinterpret_cast<T*>(smem + L.w1);
  T* w0s = reinterpret_cast<T*>(smem + L.w0);
  T* h0s = reinterpret_cast<T*>(smem + L.h0);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* b0s = reinterpret_cast<float*>(smem + L.b0);

  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TH;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;

  for (int i = tid; i < 9 * c0 * c1p; i += nthreads) w1s[i] = w1[i];
  for (int i = tid; i < 27 * c0; i += nthreads) w0s[i] = w0[i];
  for (int i = tid; i < c0; i += nthreads) b0s[i] = b0[i];

  // input tile with a 2-pixel halo, zero outside the image
  constexpr int XH = TH + 4, XW = TW + 4;
  for (int i = tid; i < XH * XW; i += nthreads) {
    const int ly = i / XW, lx = i % XW;
    const int gy = y0 - 2 + ly, gx = x0 - 2 + lx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* px = x + ((size_t(b) * H + (in ? gy : 0)) * W + (in ? gx : 0)) * 3;
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) xs[(ci * XH + ly) * XW + lx] = in ? to_f(px[ci]) : 0.f;
  }
  __syncthreads();

  // h0 over the tile plus a 1-pixel halo
  constexpr int HH = TH + 2, HW = TW + 2;
  for (int p = tid; p < HH * HW; p += nthreads) {
    const int ly = p / HW, lx = p % HW;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float tap[27];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
          tap[(dy * 3 + dx) * 3 + ci] = xs[(ci * XH + ly + dy) * XW + lx + dx];
    for (int c = 0; c < c0; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 27; ++k) acc += tap[k] * to_f(w0s[k * c0 + c]);
      acc = fmaxf(acc + b0s[c], 0.f);
      h0s[c * HH * HW + p] = from_f<T>(in ? acc : 0.f);
    }
  }
  __syncthreads();

  // h1 for this thread's pixel, CB output channels per pass
  const int ty = threadIdx.y, tx = threadIdx.x;
  const int gy = y0 + ty, gx = x0 + tx;
  const bool live = gy < H && gx < W;
  for (int cb = 0; cb < c1p; cb += CB) {
    float acc[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) acc[j] = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const T* hp = h0s + (ty + dy) * HW + tx + dx;
        const T* wp = w1s + size_t(dy * 3 + dx) * c0 * c1p + cb;
        for (int ci = 0; ci < c0; ++ci) {
          const float h = to_f(hp[ci * HH * HW]);
          float w[CB];
          load16(wp + size_t(ci) * c1p, w);
#pragma unroll
          for (int j = 0; j < CB; ++j) acc[j] += h * w[j];
        }
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        const int co = cb + j;
        if (co < c1)
          out[((size_t(b) * c1 + co) * H + gy) * W + gx] =
              from_f<T>(fmaxf(acc[j] + b1[co], 0.f));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
           void* out, int B, int H, int W, int c0, int c1, int c1p, cudaStream_t stream) {
  const size_t smem = smem_layout(c0, c1p, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(stem_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  dim3 block(TW, TH);
  stem_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0), static_cast<const float*>(b0),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<T*>(out), H, W,
      c0, c1, c1p);
  return int(cudaGetLastError());
}

// ----------------------------------------------------------------- bfloat16

namespace tc {

constexpr int TH = 4, TW = 64;                  // output tile
constexpr int HH = TH + 2, HW = TW + 2;         // h0 tile with its 1-pixel halo
constexpr int XH = TH + 4, XW = TW + 4;         // input tile with its 2-pixel halo
constexpr int HPIX = HH * HW;                   // 396 h0 pixels
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int K0 = 32;                          // conv0's K: 27 padded to 32
constexpr int PAD = 8;                          // bf16 elements (16 bytes) of row padding
constexpr int NG = 64;                          // output channels a group (accumulators)
constexpr int NS = 32;                          // output channels a staging round
constexpr int S_LD = TH * TW + PAD;             // staging row stride, [channel][pixel]
static_assert(TH * TW == WARPS * 32, "a warp takes 32 pixels of one row");

struct Smem {
  size_t w1, w0, b0, b1, h0, xs, st, total;
};

// c0p, c1p multiples of 16
__host__ __device__ inline Smem smem_layout(int c0p, int c1p) {
  Smem s;
  s.w1 = 0;                                                            // [9][c1p][c0p + PAD]
  s.w0 = align16(s.w1 + size_t(9) * c1p * (c0p + PAD) * 2);            // [c0p][K0 + PAD]
  s.b0 = align16(s.w0 + size_t(c0p) * (K0 + PAD) * 2);                 // [c0p] f32
  s.b1 = align16(s.b0 + size_t(c0p) * 4);                              // [c1p] f32
  s.h0 = align16(s.b1 + size_t(c1p) * 4);                              // [HPIX][c0p + PAD]
  s.xs = align16(s.h0 + size_t(HPIX) * (c0p + PAD) * 2);               // [XH][XW][3]
  s.st = align16(s.xs + size_t(XH) * XW * 3 * 2);                      // [NS][S_LD]
  s.total = align16(s.st + size_t(NS) * S_LD * 2);
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (B, H, W, 3); w0t (c0p, 32) [cout][tap * 3 + cin], zero past 27 and c0;
// w1t (9, c1p, c0p) [tap][cout][cin], zero past c0 and c1; b0 (c0,), b1 (c1,)
// f32; out (B, c1, H, W).
__global__ void __launch_bounds__(THREADS, 2)
stem_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w0t,
               const float* __restrict__ b0, const __nv_bfloat16* __restrict__ w1t,
               const float* __restrict__ b1, __nv_bfloat16* __restrict__ out, int B, int H,
               int W, int c0, int c0p, int c1, int c1p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(c0p, c1p);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1);
  __nv_bfloat16* w0s = reinterpret_cast<__nv_bfloat16*>(smem + L.w0);
  float* b0s = reinterpret_cast<float*>(smem + L.b0);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  __nv_bfloat16* h0s = reinterpret_cast<__nv_bfloat16*>(smem + L.h0);
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(smem + L.xs);
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem + L.st);
  const int H_LD = c0p + PAD, W1_LD = c0p + PAD;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;

  // the weights, once a block, in 16-byte pieces
  for (int e = tid; e < 9 * c1p * c0p / 8; e += THREADS) {
    const int row = e / (c0p / 8), ch = e % (c0p / 8);
    *reinterpret_cast<uint4*>(w1s + size_t(row) * W1_LD + ch * 8) =
        *reinterpret_cast<const uint4*>(w1t + size_t(row) * c0p + ch * 8);
  }
  for (int e = tid; e < c0p * K0 / 8; e += THREADS) {
    const int row = e / (K0 / 8), ch = e % (K0 / 8);
    *reinterpret_cast<uint4*>(w0s + row * (K0 + PAD) + ch * 8) =
        *reinterpret_cast<const uint4*>(w0t + row * K0 + ch * 8);
  }
  for (int e = tid; e < c0p; e += THREADS) b0s[e] = e < c0 ? b0[e] : 0.f;
  for (int e = tid; e < c1p; e += THREADS) b1s[e] = e < c1 ? b1[e] : 0.f;

  // conv0's A fragment columns of this thread: k = s * 16 + 2q + {0, 1, 8, 9}
  // for the k16 slices s = 0, 1; offset of tap k in the input tile from the
  // h0 pixel's corner, or -1 past the 27 real columns
  int koff[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = s * 16 + 2 * q + (j & 1) + (j >> 1) * 8;
      koff[s][j] = k < 27 ? ((k / 9) * XW + (k / 3) % 3) * 3 + k % 3 : -1;
    }

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  const bool vec_store = W % 8 == 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int y0 = (tile / tiles_x) % tiles_y * TH, x0 = tile % tiles_x * TW;
    __syncthreads();            // the last tile's readers of xs, h0s and st are done

    // input tile with a 2-pixel halo, zero outside the image
    uint16_t* xw = reinterpret_cast<uint16_t*>(smem + L.xs);
    const uint16_t* xg = reinterpret_cast<const uint16_t*>(x);
    for (int e = tid; e < XH * XW * 3; e += THREADS) {
      const int ly = e / (XW * 3), r = e % (XW * 3);
      const int gy = y0 - 2 + ly, gx = x0 - 2 + r / 3;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      xw[e] = in ? xg[((size_t(b) * H + gy) * W + gx) * 3 + r % 3] : uint16_t(0);
    }
    __syncthreads();

    // conv0 over the h0 tile: M = 396 pixels in m16 tiles, N = c0p, K = 32
    for (int mt = warp; mt * 16 < HPIX; mt += WARPS) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(mt * 16 + g + 8 * h, HPIX - 1);
        base[h] = ((m / HW) * XW + m % HW) * 3;
      }
      uint32_t af[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r) {      // a0 (g, k), a1 (g + 8, k), a2 (g, k + 8), a3 (g + 8, k + 8)
          const int h = r & 1, j0 = (r >> 1) * 2;
          const uint32_t lo = koff[s][j0] < 0 ? 0u : xs[base[h] + koff[s][j0]];
          const uint32_t hi = koff[s][j0 + 1] < 0 ? 0u : xs[base[h] + koff[s][j0 + 1]];
          af[s][r] = lo | (hi << 16);
        }
      for (int n = 0; n < c0p; n += 8) {
        uint32_t bf[4];       // k16 slice 0: bf[0], bf[1]; slice 1: bf[2], bf[3]
        ldmatrix_x4(bf, w0s + (n + (lane & 7)) * (K0 + PAD) + (lane >> 3) * 8);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, af[0], bf[0], bf[1]);
        mma_bf16(d, af[1], bf[2], bf[3]);
        const int co = n + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m >= HPIX) continue;
          const int gy = y0 - 1 + m / HW, gx = x0 - 1 + m % HW;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const float v0 = in ? fmaxf(d[2 * h] + b0s[co], 0.f) : 0.f;
          const float v1 = in ? fmaxf(d[2 * h + 1] + b0s[co + 1], 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(h0s + m * H_LD + co) = pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();

    // conv1: warp takes output row oy, columns ox0 .. ox0 + 32 (two m16 tiles)
    const int oy = warp / 2, ox0 = (warp % 2) * 32;
    for (int cg = 0; cg < c1p; cg += NG) {
      const int nvalid = min(NG, c1p - cg);
      float acc[2][8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const __nv_bfloat16* arow =
            h0s + ((oy + dy) * HW + ox0 + dx + (lane & 15)) * H_LD + (lane >> 4) * 8;
        const __nv_bfloat16* brow =
            w1s + (size_t(tap) * c1p + cg + (lane & 7) + ((lane >> 4) << 3)) * W1_LD +
            ((lane >> 3) & 1) * 8;
        for (int kc = 0; kc < c0p; kc += 16) {
          uint32_t af[2][4];
          ldmatrix_x4(af[0], arow + kc);
          ldmatrix_x4(af[1], arow + 16 * H_LD + kc);
#pragma unroll
          for (int np = 0; np < NG / 16; ++np) {
            if (np * 16 >= nvalid) break;
            uint32_t bf[4];   // n tile 2np: bf[0], bf[1]; 2np + 1: bf[2], bf[3]
            ldmatrix_x4(bf, brow + size_t(np) * 16 * W1_LD + kc);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(acc[m][2 * np], af[m], bf[0], bf[1]);
              mma_bf16(acc[m][2 * np + 1], af[m], bf[2], bf[3]);
            }
          }
        }
      }

      // epilogue: + b1, ReLU, bf16, staged NS channels at a time as
      // [channel][pixel], then 16-byte stores along W
#pragma unroll
      for (int rr = 0; rr < NG / NS; ++rr) {
        if (rr * NS >= nvalid) break;
        __syncthreads();        // the last round's readers of st are done
#pragma unroll
        for (int n = 0; n < NS / 8; ++n) {
          if (rr * NS + n * 8 >= nvalid) break;
          const int j = rr * (NS / 8) + n;
          const int cl = n * 8 + 2 * q;              // channel within the round
          const float bb0 = b1s[cg + rr * NS + cl], bb1 = b1s[cg + rr * NS + cl + 1];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int px = oy * TW + ox0 + m * 16 + g + 8 * h;
              st[cl * S_LD + px] = __float2bfloat16_rn(fmaxf(acc[m][j][2 * h] + bb0, 0.f));
              st[(cl + 1) * S_LD + px] =
                  __float2bfloat16_rn(fmaxf(acc[m][j][2 * h + 1] + bb1, 0.f));
            }
        }
        __syncthreads();
        for (int e = tid; e < NS * TH * (TW / 8); e += THREADS) {
          const int cl = e / (TH * TW / 8), r = e % (TH * TW / 8);
          const int ty = r / (TW / 8), xc = (r % (TW / 8)) * 8;
          const int co = cg + rr * NS + cl, gy = y0 + ty, gx = x0 + xc;
          if (co >= c1 || gy >= H || gx >= W) continue;
          const __nv_bfloat16* src = st + cl * S_LD + ty * TW + xc;
          __nv_bfloat16* dst = out + ((size_t(b) * c1 + co) * H + gy) * W + gx;
          if (vec_store && gx + 8 <= W) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int i = 0; i < 8 && gx + i < W; ++i) dst[i] = src[i];
          }
        }
      }
    }
  }
}

int launch(const __nv_bfloat16* x, const __nv_bfloat16* w0t, const float* b0,
           const __nv_bfloat16* w1t, const float* b1, __nv_bfloat16* out, int B, int H, int W,
           int c0, int c0p, int c1, int c1p, cudaStream_t stream) {
  if (c0p % 16 != 0 || c1p % 16 != 0 || c0p < c0 || c1p < c1) return int(cudaErrorInvalidValue);
  const size_t smem = smem_layout(c0p, c1p).total;
  cudaError_t err = cudaFuncSetAttribute(stem_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_tc_kernel, THREADS,
                                                           smem)) != cudaSuccess)
    return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const long long ntiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  const int grid = int(ntiles < (long long)sms * per_sm ? ntiles : (long long)sms * per_sm);
  stem_tc_kernel<<<grid, THREADS, smem, stream>>>(x, w0t, b0, w1t, b1, out, B, H, W, c0, c0p,
                                                  c1, c1p);
  return int(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------------------------------------ float32

namespace tf32 {

constexpr int TH = 4, TW = 64;                  // output tile: a warpgroup takes two rows
constexpr int HH = TH + 2, HW = TW + 2;         // h0 tile with its 1-pixel halo
constexpr int XH = TH + 4, XW = TW + 4;         // input tile with its 2-pixel halo
constexpr int HPIX = HH * HW;                   // 396 h0 pixels
constexpr int THREADS = 256;                    // two warpgroups
constexpr int NG = 64;                          // output channels a group: wgmma's N
constexpr int B_TILE = NG * 8;                  // floats of one B tile (64 x k8)
static_assert(TH * TW == 2 * 2 * 64, "two warpgroups of two m64 rows each");

struct Smem {
  size_t w1, w0, b0, b1, h0, xs, total;
};

constexpr int XS = 3 * XH * XW;                 // floats of one input tile
constexpr int K0 = 32;                          // conv0's K: 27 padded to 32 (4 k8 slices)

// c0p a multiple of 16, c1p of 64
__host__ __device__ inline Smem smem_layout(int c0p, int c1p) {
  Smem s;
  s.w1 = 0;                                             // 9 * c0p * c1p * 8 bytes: B tiles
  s.w0 = align16(s.w1 + size_t(9) * c0p * c1p * 8);     // [4][c0p / 8][32] x 4: B fragments
  s.b0 = align16(s.w0 + size_t(K0) * c0p * 8);          // [c0p]
  s.b1 = align16(s.b0 + size_t(c0p) * 4);               // [c1p]
  s.h0 = align16(s.b1 + size_t(c1p) * 4);               // [HPIX][c0p], 16-byte chunks swizzled
  s.xs = align16(s.h0 + size_t(HPIX) * c0p * 4);        // two of [3][XH][XW]
  s.total = align16(s.xs + size_t(2) * XS * 4);
  return s;
}

// A 4-byte asynchronous copy to shared memory, zero-filled where !in.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  const unsigned d = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}

// A descriptor of a B tile in shared memory: K-major, no swizzle, 8-row x
// 16-byte core matrices, the two of a row group (k 0-3, 4-7) 128 bytes
// apart, row groups 256 bytes apart.
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint64_t addr = (uint64_t(__cvta_generic_to_shared(tile)) & 0x3FFFF) >> 4;
  return addr | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 of the warpgroup) += a (64 x 8, TF32, registers) . b (the B
// tile at `desc`, 64 x 8 K-major, TF32); f32 accumulators
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The A operands of one K step (a tap and 16 channels of c0): [m][h][hi|lo][a0 .. a3]
using AFrag = uint32_t[2][2][2][4];

// Keeps a fragment's registers live and in place up to this point: after
// the wait that ends the wgmma reading them, nothing may have reused them.
__device__ __forceinline__ void hold(AFrag& a) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[m][h][s][r]));
}

// x (B, H, W, 3); w0k (27, c0p) [tap * 3 + cin][cout], zero past c0; w1k the
// B tiles of conv1 (see `stem_conv_f32_launch`); b0 (c0,), b1 (c1,);
// out (B, c1, H, W); all float32.
__global__ void __launch_bounds__(THREADS, 1)
stem_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w0k,
                 const float* __restrict__ b0, const float4* __restrict__ w1k,
                 const float* __restrict__ b1, float* __restrict__ out, int B, int H, int W,
                 int c0, int c0p, int c1, int c1p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(c0p, c1p);
  float* w1s = reinterpret_cast<float*>(smem + L.w1);
  float* w0s = reinterpret_cast<float*>(smem + L.w0);
  float* b0s = reinterpret_cast<float*>(smem + L.b0);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* h0s = reinterpret_cast<float*>(smem + L.h0);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  const int CB = c0p / 16, NGR = c1p / NG;     // 16-channel blocks of c0; N groups of c1
  // h0's 16-byte chunk k of pixel p lies at chunk k ^ (p odd ? swz : 0) of
  // its row, so that the A loads of two neighbouring pixels (one 16-byte
  // load a lane) fall on different banks; a row of c0p % 32 != 0 floats
  // alternates its banks by itself
  const int swz = c0p % 32 == 0 ? 4 : 0;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wg = warp / 4, wq = warp % 4;      // warpgroup; warp within it (16 rows of M)

  // the weights, once a block; B tiles then go to the tensor cores through
  // the async proxy
  for (int e = tid; e < 9 * c0p * c1p / 2; e += THREADS)
    reinterpret_cast<float4*>(w1s)[e] = w1k[e];
  for (int e = tid; e < K0 * c0p / 2; e += THREADS)
    reinterpret_cast<float4*>(w0s)[e] = reinterpret_cast<const float4*>(w0k)[e];
  for (int e = tid; e < c0p; e += THREADS) b0s[e] = e < c0 ? b0[e] : 0.f;
  for (int e = tid; e < c1p; e += THREADS) b1s[e] = e < c1 ? b1[e] : 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  // A tile's input with a 2-pixel halo, [cin][row][column], zero outside
  // the image, copied asynchronously into `xb`: the next tile's copy runs
  // while this one's conv1 does.
  auto fetch = [&](int tile, float* xb) {
    const int b = tile / (tiles_y * tiles_x);
    const int y0 = (tile / tiles_x) % tiles_y * TH, x0 = tile % tiles_x * TW;
    for (int e = tid; e < XH * XW; e += THREADS) {
      const int ly = e / XW, lx = e % XW;
      const int gy = y0 - 2 + ly, gx = x0 - 2 + lx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* px = x + ((size_t(b) * H + (in ? gy : 0)) * W + (in ? gx : 0)) * 3;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) copy4(xb + (ci * XH + ly) * XW + lx, px + ci, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // conv0's A columns of this lane, k = 8s + q (j = 0) and 8s + q + 4 (j =
  // 1) for the k8 slices s: the offset of tap k in the input tile from the
  // h0 pixel's corner, or -1 past the 27 real columns (k = (dy * 3 + dx) *
  // 3 + cin)
  int koff[4][2];
#pragma unroll
  for (int sl = 0; sl < 4; ++sl)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 8 * sl + q + 4 * j;
      koff[sl][j] = k < 27 ? ((k % 3) * XH + k / 9) * XW + (k / 3) % 3 : -1;
    }

  if (blockIdx.x < ntiles) fetch(blockIdx.x, xs);
  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int b = tile / (tiles_y * tiles_x);
    const int y0 = (tile / tiles_x) % tiles_y * TH, x0 = tile % tiles_x * TW;
    const float* xt = xs + buf * XS;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();            // the input is in; the last tile's readers of h0 are done

    // conv0 on the tensor cores in 3xTF32 (`mma.sync.m16n8k8`): M = the
    // 396 h0 pixels in m16 tiles, N = c0p, K = 27 padded to 32; the A
    // fragments are gathered from the input tile through `koff` and split
    // in registers, the B fragments (hi and lo of 8 channels a lane) come
    // in 16-byte loads.  + b0, ReLU, zero outside the image (conv1
    // zero-pads).
    for (int mt = warp; mt * 16 < HPIX; mt += THREADS / 32) {
      int base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = min(mt * 16 + g + 8 * r, HPIX - 1);
        base[r] = (m / HW) * XW + m % HW;
      }
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int sl = 0; sl < 4; ++sl)
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {   // (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
          const int off = koff[sl][reg >> 1];
          split(off < 0 ? 0.f : xt[base[reg & 1] + off], ahi[sl][reg], alo[sl][reg]);
        }
      for (int n0 = 0; n0 < c0p; n0 += 32) {
        const int ntv = min(4, (c0p - n0) / 8);
        float acc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int sl = 0; sl < 4; ++sl)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if (n >= ntv) break;
            const float4 w = reinterpret_cast<const float4*>(w0s)
                [(sl * (c0p / 8) + n0 / 8 + n) * 32 + lane];
            const uint32_t h0b = __float_as_uint(w.x), h1b = __float_as_uint(w.y);
            mma_tf32(acc[n], alo[sl], h0b, h1b);          // the small products first
            mma_tf32(acc[n], ahi[sl], __float_as_uint(w.z), __float_as_uint(w.w));
            mma_tf32(acc[n], ahi[sl], h0b, h1b);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = mt * 16 + g + 8 * r;
          if (m >= HPIX) continue;
          const int gy = y0 - 1 + m / HW, gx = x0 - 1 + m % HW;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          float2* row = reinterpret_cast<float2*>(h0s + size_t(m) * c0p);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if (n >= ntv) break;
            const int co = n0 + 8 * n + 2 * q;       // channels co, co + 1: half a chunk
            const float v0 = in ? fmaxf(acc[n][2 * r] + b0s[co], 0.f) : 0.f;
            const float v1 = in ? fmaxf(acc[n][2 * r + 1] + b0s[co + 1], 0.f) : 0.f;
            row[((co / 4) ^ ((m & 1) * swz)) * 2 + (co % 4) / 2] = make_float2(v0, v1);
          }
        }
      }
    }
    __syncthreads();
    if (tile + gridDim.x < ntiles) fetch(tile + gridDim.x, xs + (buf ^ 1) * XS);

    // conv1, an implicit GEMM on the tensor cores in 3xTF32 by `wgmma`:
    // warpgroup wg takes output rows 2wg and 2wg + 1 (two m64 blocks), N =
    // c1p in groups of 64, K = 9 taps x c0p in steps of a tap and 16
    // channels.  A lane's 16-byte load of h0 gives it 4 channels of one
    // pixel, which serve two k8 slices (channel 16cb + 4q + 2h (+1) is k = q
    // (q + 4) of slice h; the host orders B the same way); it splits them
    // into hi and lo in registers.  A step's 12 wgmmas run while the warps
    // load and split the next step's A into the other register buffer.
    for (int cg = 0; cg < NGR; ++cg) {
      float acc[2][32];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;
      const int steps = 9 * CB;
      auto load_a = [&](int step, AFrag& a) {
        const int tap = step / CB, cb = step % CB;
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = (2 * wg + m + dy) * HW + 16 * wq + g + 8 * r + dx;
            const float4 v = reinterpret_cast<const float4*>(h0s + size_t(p) * c0p)
                [(4 * cb + q) ^ ((p & 1) * swz)];
            split(v.x, a[m][0][0][r], a[m][0][1][r]);
            split(v.y, a[m][0][0][r + 2], a[m][0][1][r + 2]);
            split(v.z, a[m][1][0][r], a[m][1][1][r]);
            split(v.w, a[m][1][0][r + 2], a[m][1][1][r + 2]);
          }
      };
      // B tiles of a step: [tap][cb][h][hi|lo][N group] of B_TILE floats
      auto run_step = [&](int step, AFrag& a) {
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* tiles = w1s + (size_t(step * 2 + h) * 2 * NGR + cg) * B_TILE;
          const uint64_t hi = b_desc(tiles), lo = b_desc(tiles + size_t(NGR) * B_TILE);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            wgmma_tf32(acc[m], a[m][h][1], hi);     // the small products first
            wgmma_tf32(acc[m], a[m][h][0], lo);
            wgmma_tf32(acc[m], a[m][h][0], hi);
          }
        }
        wgmma_commit();
      };
      AFrag a0, a1;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int r = 0; r < 4; ++r) a1[m][h][s][r] = 0u;
      for (int step = 0; step < steps; step += 2) {
        load_a(step, a0);
        run_step(step, a0);
        wgmma_wait<1>();        // the last step's wgmmas, which read a1, are done
        hold(a1);
        if (step + 1 < steps) {
          load_a(step + 1, a1);
          run_step(step + 1, a1);
          wgmma_wait<1>();      // this pair's first wgmmas, which read a0, are done
          hold(a0);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(acc[m][e]));

      // epilogue: + b1, ReLU, straight to (B, c1, H, W): for each register a
      // warp writes 4 channels x 8 neighbouring pixels, four whole 32-byte
      // sectors where W is a multiple of 8
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int gy = y0 + 2 * wg + m;
        if (gy >= H) continue;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int co = cg * NG + 8 * (e / 4) + 2 * q + (e & 1);
          const int gx = x0 + 16 * wq + g + 8 * ((e / 2) & 1);
          if (co < c1 && gx < W)
            out[((size_t(b) * c1 + co) * H + gy) * W + gx] = fmaxf(acc[m][e] + b1s[co], 0.f);
        }
      }
    }
  }
}

int launch(const float* x, const float* w0k, const float* b0, const float4* w1k, const float* b1,
           float* out, int B, int H, int W, int c0, int c0p, int c1, int c1p,
           cudaStream_t stream) {
  if (c0p % 16 != 0 || c1p % NG != 0 || c0p < c0 || c1p < c1) return int(cudaErrorInvalidValue);
  const size_t smem = smem_layout(c0p, c1p).total;
  cudaError_t err = cudaFuncSetAttribute(stem_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return int(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return int(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_tf32_kernel, THREADS,
                                                           smem)) != cudaSuccess)
    return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const long long ntiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  const int grid = int(ntiles < (long long)sms * per_sm ? ntiles : (long long)sms * per_sm);
  stem_tf32_kernel<<<grid, THREADS, smem, stream>>>(x, w0k, b0, w1k, b1, out, B, H, W, c0, c0p,
                                                    c1, c1p);
  return int(cudaGetLastError());
}

}  // namespace tf32

}  // namespace

// x (B, H, W, 3); w0 (9, 3, c0) [tap, cin, cout]; w1 (9, c0, c1p) with c1p a
// multiple of 16 and zero columns past c1; b0 (c0,), b1 (c1,) float32;
// out (B, c1, H, W).  dtype 0 = float32, 1 = bfloat16 for x, w0, w1, out.
extern "C" int stem_conv_launch(const void* x, const void* w0, const void* b0,
                                const void* w1, const void* b1, void* out, int B, int H,
                                int W, int c0, int c1, int c1p, int dtype, void* stream) {
  if (c1p % CB != 0 || c1p < c1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w0, b0, w1, b1, out, B, H, W, c0, c1, c1p, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w0, b0, w1, b1, out, B, H, W, c0, c1, c1p, s);
  return int(cudaErrorInvalidValue);
}

// x (B, H, W, 3) bfloat16; w0t (c0p, 32) [cout][tap * 3 + cin] and w1t
// (9, c1p, c0p) [tap][cout][cin] bfloat16, c0p and c1p multiples of 16, zero
// past 27, c0 and c1; b0 (c0,), b1 (c1,) float32; out (B, c1, H, W) bfloat16.
extern "C" int stem_conv_bf16_launch(const void* x, const void* w0t, const void* b0,
                                     const void* w1t, const void* b1, void* out, int B, int H,
                                     int W, int c0, int c0p, int c1, int c1p, void* stream) {
  if (B < 1 || H < 1 || W < 1 || c0 < 1 || c1 < 1) return int(cudaErrorInvalidValue);
  return tc::launch(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w0t),
                    static_cast<const float*>(b0), static_cast<const __nv_bfloat16*>(w1t),
                    static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(out), B, H, W, c0,
                    c0p, c1, c1p, static_cast<cudaStream_t>(stream));
}

// x (B, H, W, 3) float32; w0k (27, c0p) [tap * 3 + cin][cout] float32, zero
// past c0; w1k (9, c0p / 16, 2, 2, c1p / 64, 8, 2, 8, 4) float32, conv1's B
// tiles split for 3xTF32: entry [tap][cb][h][s][n][nb][kh][r][j] is
// hi(w[co][ci]) for s = 0 and lo(w[co][ci]) for s = 1, co = 64n + 8nb + r,
// ci = 16cb + 4j + 2h + kh, hi the TF32 rounding (to nearest, ties away)
// and lo that of w - hi, zero past c0 and c1; c0p a multiple of 16, c1p of
// 64; b0 (c0,), b1 (c1,) float32; out (B, c1, H, W) float32.
extern "C" int stem_conv_f32_launch(const void* x, const void* w0k, const void* b0,
                                    const void* w1k, const void* b1, void* out, int B, int H,
                                    int W, int c0, int c0p, int c1, int c1p, void* stream) {
  if (B < 1 || H < 1 || W < 1 || c0 < 1 || c1 < 1) return int(cudaErrorInvalidValue);
  return tf32::launch(static_cast<const float*>(x), static_cast<const float*>(w0k),
                      static_cast<const float*>(b0), static_cast<const float4*>(w1k),
                      static_cast<const float*>(b1), static_cast<float*>(out), B, H, W, c0, c0p,
                      c1, c1p, static_cast<cudaStream_t>(stream));
}
