// Fused PanoSwin stem: h1 = relu(conv3x3(relu(conv3x3(x, w0) + b0), w1) + b1).
//
// Replaces the Pallas kernel `_stem2cm_kernel`
// (panoswintransformerobjectdetection_tpu/ops/stem_conv.py:61), the first
// two convolutions of the 3-conv patch stem with BatchNorm folded into the
// weights.  The 4x4/4 patch projection that follows stays a library
// convolution, as it does in the JAX package.
//
// What bounds it on the H100: the work is about 40 GFLOP at the flagship's
// (2, 512, 1024, 3) input with c0 = 32, c1 = 64, against 6 MB read and
// 134 MB written in bf16.  The tensor cores would make it bound by the
// bytes (about 0.04 ms at 3.35 TB/s).  This first version does the
// arithmetic on the CUDA cores in f32, so it is bound by operations
// (about 0.6 ms at the 67 TFLOP/s f32 rate) and by shared-memory issue.
//
// Design: one block per (image, 8-row x 32-column output tile), one thread
// per output pixel.  The block stages the 3-channel input tile with a
// 2-pixel halo in shared memory, computes h0 for the tile plus a 1-pixel
// halo (f32 accumulation, + b0, ReLU), zeroes h0 outside the image because
// the second convolution zero-pads its input, rounds h0 to the compute type
// as the Pallas kernel does, and keeps it in shared memory: h0 never reaches
// device memory.  Each thread then accumulates 16 output channels at a time
// in registers from h0 and from w1, which sits in shared memory with the
// output channel fastest so that one 16-byte load feeds 4 or 8 FMAs.  The
// weights are read at the same address by every thread of a warp, which
// shared memory broadcasts.  Any H and W are accepted; the ragged edge is
// masked.  Output is (B, c1, H, W) in the compute type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
