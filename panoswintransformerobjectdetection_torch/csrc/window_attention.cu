// Fused window attention: for window n and head h,
//   out[n, h] = softmax(q[n, h] k[n, h]^T * scale + bias[n mod nW, h]) v[n, h].
//
// Replaces the Pallas kernel `_packed_kernel`
// (panoswintransformerobjectdetection_tpu/ops/fused_attention.py:88, K2) and,
// behind the same entry point, `_attn_kernel` (:27, K5), which compute the
// same function.  The numerics follow `_packed_kernel`: q.k accumulated in
// f32 from the inputs' values, then times `scale`, then plus the f32 bias;
// the softmax is max, exp and e / sum in f32; p is rounded to the input type
// before the product with v, which accumulates in f32; the output is in the
// input type.  The TPU kernel packs 8 windows into one block-diagonal
// product and pads O = 49 to 56 to fill its matrix unit; here a block takes
// one window and one head as they are, and masks its ragged tile.
//
// What bounds it on the H100: at the flagship's stage 0 (1406 windows,
// 3 heads, O = 49, d = 32, bf16) it must move about 73 MB (q, k, v and out,
// and the f32 bias read once), 0.022 ms at 3.35 TB/s, against 1.3 GFLOP of
// products, 0.0013 ms on the tensor cores: bound by the bytes.  This first
// version computes both products on the CUDA cores in f32, reading both
// operands of every multiply-add from shared memory, so it is bound by
// shared-memory issue, well above the bytes.  A tensor-core version
// (`mma.sync` over several windows a block) is later work.
//
// Design: one block of 4 warps per (window, head).  The block loads q, k
// and v (O x d each) into shared memory as f32; k's rows are padded to
// d + 1 so that the 32 lanes of a warp, each on its own key, read distinct
// banks.  Each warp takes query rows in turn: lane j scores keys j and
// j + 32, the warp reduces the max and the sum with shuffles, writes the
// row's rounded probabilities to shared memory, and lane c then sums
// p[j] * v[j, c] for channels c and c + 32.  O <= 64 and d <= 64.  q, k, v
// and out are read through (window, head, token) strides with the channel
// contiguous, so the model passes views of its (n, O, 3, h, d) projection
// and gets its output in the (n, O, h, d) layout that the next projection
// reads, with no copy.  The bias also takes strides, so a planar bias
// broadcast over the windows (stride 0) is read as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr int MAX_TOKENS = 64;
constexpr int MAX_HEAD_DIM = 64;

// Element strides of (window, head, token) for each tensor; the last
// dimension (channel, or key for the bias) is contiguous.
struct Strides {
  long long q[3], k[3], v[3], bias[3], out[3];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

inline size_t smem_bytes(int O, int d) {
  return sizeof(float) * (size_t(O) * d * 2 + size_t(O) * (d + 1) + size_t(WARPS) * O);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        T* __restrict__ out, Strides st, int h, int O, int d, int nW,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = d + 1;
  float* qs = smem;               // (O, d)
  float* ks = qs + O * d;         // (O, d + 1)
  float* vs = ks + O * dp;        // (O, d)
  float* ps = vs + O * d;         // (WARPS, O): each warp's current row of p

  const int n = blockIdx.x / h;
  const int head = blockIdx.x % h;
  const T* qb = q + n * st.q[0] + head * st.q[1];
  const T* kb = k + n * st.k[0] + head * st.k[1];
  const T* vb = v + n * st.v[0] + head * st.v[1];
  const float* bb = bias + (n % nW) * st.bias[0] + head * st.bias[1];
  T* ob = out + n * st.out[0] + head * st.out[1];

  for (int i = threadIdx.x; i < O * d; i += blockDim.x) {
    const int t = i / d, c = i % d;
    qs[i] = to_f(qb[t * st.q[2] + c]);
    ks[t * dp + c] = to_f(kb[t * st.k[2] + c]);
    vs[i] = to_f(vb[t * st.v[2] + c]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = ps + warp * O;
  for (int i = warp; i < O; i += WARPS) {
    const float* qi = qs + i * d;
    const float* bi = bb + i * st.bias[2];
    float s[2], m = -INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = lane + 32 * r;
      s[r] = -INFINITY;
      if (j < O) {
        const float* kj = ks + j * dp;
        float acc = 0.f;
        for (int c = 0; c < d; ++c) acc = fmaf(qi[c], kj[c], acc);
        // no contraction: scale, then add the bias, each rounded, as the twin does
        s[r] = __fadd_rn(__fmul_rn(acc, scale), bi[j]);
        m = fmaxf(m, s[r]);
      }
    }
    m = warp_max(m);
    float e[2], sum = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      e[r] = lane + 32 * r < O ? expf(s[r] - m) : 0.f;
      sum += e[r];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = lane + 32 * r;
      if (j < O) pw[j] = to_f(from_f<T>(e[r] / sum));
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < O; ++j) acc = fmaf(pw[j], vs[j * d + c], acc);
      ob[i * st.out[2] + c] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           const Strides& st, int n, int h, int O, int d, int nW, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(O, d);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  window_attention_kernel<T><<<n * h, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), st, h, O, d, nW, scale);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (n, h, O, d) in the compute type; bias (nW, h, O, O) float32.
// strides: 15 element strides, (window, head, token) of q, k, v, bias and
// out in that order; every tensor's last dimension is contiguous.
// dtype 0 = float32, 1 = bfloat16.
extern "C" int window_attention_launch(const void* q, const void* k, const void* v,
                                       const void* bias, void* out,
                                       const long long* strides, int n, int h, int O,
                                       int d, int nW, float scale, int dtype,
                                       void* stream) {
  if (n <= 0 || h <= 0 || O <= 0 || O > MAX_TOKENS || d <= 0 || d > MAX_HEAD_DIM ||
      nW <= 0 || n % nW != 0 || (long long)n * h > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.bias[i] = strides[9 + i];
    st.out[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, bias, out, st, n, h, O, d, nW, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, out, st, n, h, O, d, nW, scale, s);
  return int(cudaErrorInvalidValue);
}
