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
// products, 0.0013 ms on the tensor cores: bound by the bytes.
//
// bfloat16 entry (`window_attention_bf16_launch`), on the tensor cores, in
// the FlashAttention-2 register pattern for one whole (O x O) tile.  One
// block of 4 warps per (window, head); blocks are ordered image fastest, so
// the B blocks of one (window, head) run together and read its bias from L2
// (as `_packed_kernel`'s grid reuses its bias block).  q, k and v are copied
// into shared memory as bf16 (`cp.async` of 16 bytes where the views allow
// it, narrower loads chosen from d, the strides and the base addresses
// otherwise), with O padded to 64 rows and d to a multiple of 16.  Padded
// rows and columns are zero-filled: a masked key's p is exactly 0, but 0
// times stale shared memory could still be NaN.  Rows are padded by 16
// bytes so that `ldmatrix` hits no bank twice.  Warp w owns query rows
// 16w .. 16w + 15 and computes S = Q K^T on
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` (A by `ldmatrix`
// from Q's rows, B by `ldmatrix` from K's rows, which is K^T's column
// layout); then, in the accumulator layout and with the first version's
// rounding places: times scale, plus the f32 bias, keys >= O set to -inf,
// row max and sum by quad shuffles, expf and IEEE e / sum.  The bias comes
// into shared memory behind q, k and v, by 16-byte `cp.async` where its
// rows lie end to end: read straight from global memory in the accumulator
// layout (32 scalar loads a thread) it cost 12% of the kernel's time at
// stage 0.  p is rounded to bf16 while it is packed from the accumulators
// into A fragments, and P V runs on the same `mma` with V's B fragments
// from `ldmatrix.trans` on V's [token][d] rows.  The output goes through
// the warp's own (dead) Q rows in shared memory and leaves in the
// (n, O, h, d) layout with the widest stores the view allows.  Tensor-core
// sums run in another order than the twin's; the bf16 tolerance allows for
// that.  What holds it at about 3x its bound is issue, not bytes: the 32
// IEEE divisions a thread and the softmax's other scalar work (a copy
// multiplying by 1 / sum instead ran 25% faster, but rounds otherwise);
// blocks that take two (window, head) items and copy the next while they
// compute the current ran slower at three of the four stage shapes.
//
// float32 entry (`window_attention_launch`), the first version, f32 and
// bf16: the wrapper calls it for float32 (the tensor cores would take f32
// only as TF32); its bf16 instantiation is there so that `chip_smoke.py`
// times the redesign against it.  It computes both products on the CUDA
// cores in f32, reading both operands of every multiply-add from shared
// memory, so it is bound by shared-memory issue, well above the bytes.
// One block of 4 warps per (window, head).  The block loads q, k and v
// (O x d each) into shared memory as f32; k's rows are padded to d + 1 so
// that the 32 lanes of a warp, each on its own key, read distinct banks.
// Each warp takes query rows in turn: lane j scores keys j and j + 32, the
// warp reduces the max and the sum with shuffles, writes the row's rounded
// probabilities to shared memory, and lane c then sums p[j] * v[j, c] for
// channels c and c + 32.
//
// Both entries take O <= 64 and d <= 64.  q, k, v and out are read through
// (window, head, token) strides with the channel contiguous, so the model
// passes views of its (n, O, 3, h, d) projection and gets its output in the
// (n, O, h, d) layout that the next projection reads, with no copy.  The
// bias also takes strides, so a planar bias broadcast over the windows
// (stride 0) is read as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ----------------------------------------------------------------- bfloat16

namespace tc {

constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 64;                  // O padded: 4 warps x m16
constexpr int MAX_KT = ROWS / 8;          // n8 tiles of keys
constexpr int MAX_DT = MAX_HEAD_DIM / 8;  // n8 tiles of d
constexpr int PAD = 8;                    // bf16 elements (16 bytes) of row padding
constexpr int MIN_BLOCKS = 4;             // blocks an SM: at most 128 registers a thread

__host__ __device__ inline int padded_d(int d) { return (d + 15) / 16 * 16; }
// Shared memory of a block, in bytes: q, k and v ([token][d], row stride
// padded_d + PAD, bf16), then the f32 bias (O x O, after up to 3 floats of
// offset that align its 16-byte copies).
__host__ __device__ inline int qkv_bytes(int d) { return 3 * ROWS * (padded_d(d) + PAD) * 2; }
inline size_t smem_bytes(int O, int d) {
  return size_t(qkv_bytes(d)) + (3 + O * O + 3) / 4 * 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// VEC bf16 elements as one access
template <int VEC> struct Chunk;
template <> struct Chunk<8> { using type = uint4; };
template <> struct Chunk<4> { using type = uint2; };
template <> struct Chunk<2> { using type = uint32_t; };
template <> struct Chunk<1> { using type = uint16_t; };

// Rows 0 .. ROWS - 1 of one (window, head)'s q, k or v into shared memory
// ([token][d], row stride ld), in chunks of VEC elements up to the padded
// d; rows >= O and columns >= d are zeros.  d % VEC == 0.
template <int VEC>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long token_stride, int O, int d, int ld) {
  const int chunks = padded_d(d) / VEC;
  for (int e = threadIdx.x; e < ROWS * chunks; e += THREADS) {
    const int t = e / chunks, c = (e % chunks) * VEC;
    const bool ok = t < O && c < d;
    const __nv_bfloat16* from = src + t * token_stride + c;
    if constexpr (VEC == 8) {
      cp_async16(dst + t * ld + c, ok ? from : src, ok);
    } else {
      using V = typename Chunk<VEC>::type;
      *reinterpret_cast<V*>(dst + t * ld + c) = ok ? *reinterpret_cast<const V*>(from) : V{};
    }
  }
}

// The warp's output rows r0 .. r0 + 15 (< O) from shared memory to global
// memory in chunks of VEC elements.
template <int VEC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long token_stride, int r0, int O, int d,
                                           int ld, int lane) {
  using V = typename Chunk<VEC>::type;
  const int chunks = d / VEC;
  for (int e = lane; e < 16 * chunks; e += 32) {
    const int t = r0 + e / chunks, c = (e % chunks) * VEC;
    if (t < O)
      *reinterpret_cast<V*>(dst + t * token_stride + c) =
          *reinterpret_cast<const V*>(src + t * ld + c);
  }
}

// One (window, head) of the batch: its image, head and window, image
// fastest, so that the B items of one (window, head) are neighbours and
// read its bias from L2.
struct Item {
  long long n;            // window of the batch, b * nW + w
  int head, w;
};

__device__ __forceinline__ Item item_of(int idx, int B, int h, int nW) {
  const int b = idx % B;
  idx /= B;
  return {(long long)b * nW + idx / h, idx % h, idx / h};
}

// Issue the copies of an item's q, k and v into `buf` ([q | k | v] rows)
// and of its bias behind them; returns the bias' offset in floats there.
// Rows of the bias that lie next to each other in memory (row stride O, as
// the model's bias has) go as one run of 16-byte copies, the ragged ends
// by 4 bytes; other strides go float by float.
template <int VIN>
__device__ __forceinline__ int fetch(unsigned char* buf, const Item& it,
                                     const __nv_bfloat16* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, const float* bias,
                                     const Strides& st, int O, int d, int ld) {
  __nv_bfloat16* qkv = reinterpret_cast<__nv_bfloat16*>(buf);
  load_rows<VIN>(qkv, q + it.n * st.q[0] + it.head * st.q[1], st.q[2], O, d, ld);
  load_rows<VIN>(qkv + ROWS * ld, k + it.n * st.k[0] + it.head * st.k[1], st.k[2], O, d, ld);
  load_rows<VIN>(qkv + 2 * ROWS * ld, v + it.n * st.v[0] + it.head * st.v[1], st.v[2], O, d,
                 ld);
  float* bs = reinterpret_cast<float*>(buf + qkv_bytes(d));
  const float* bb = bias + it.w * st.bias[0] + it.head * st.bias[1];
  const int count = O * O;
  if (st.bias[2] != O) {
    for (int j = threadIdx.x; j < count; j += THREADS)
      cp_async4(bs + j, bb + (j / O) * st.bias[2] + j % O);
    return 0;
  }
  const int lead = int(reinterpret_cast<uintptr_t>(bb) / 4 % 4);   // floats past 16 bytes
  for (int c = threadIdx.x; c < (lead + count + 3) / 4; c += THREADS) {
    const int j0 = 4 * c - lead;              // the source float of shared float 4c
    if (j0 >= 0 && j0 + 4 <= count) {
      cp_async16(bs + 4 * c, bb + j0, true);
    } else {
      for (int e = 0; e < 4; ++e)
        if (j0 + e >= 0 && j0 + e < count) cp_async4(bs + 4 * c + e, bb + j0 + e);
    }
  }
  return lead;
}

// The warp's 16 query rows r0 .. of one item, from q, k, v and the bias
// (`bs`, O x O) in shared memory.  The output leaves through the warp's own
// Q rows of `buf`, which no other warp reads.
__device__ __forceinline__ void attend(__nv_bfloat16* buf, const float* bs, __nv_bfloat16* ob,
                                       long long out_token_stride, int O, int d, int ld,
                                       float scale, int vout) {
  __nv_bfloat16* qs = buf;
  const __nv_bfloat16* ks = buf + ROWS * ld;
  const __nv_bfloat16* vs = buf + 2 * ROWS * ld;
  const int lane = threadIdx.x % 32, r0 = threadIdx.x / 32 * 16;
  const int g = lane / 4, qd = lane % 4;          // fragment row group, column pair
  const int nkt = 2 * ((O + 15) / 16);            // n8 tiles of keys, even
  const int ndt = padded_d(d) / 8;                // n8 tiles of d, even

  // S = Q K^T over the padded d
  float s[MAX_KT][4];
#pragma unroll
  for (int kt = 0; kt < MAX_KT; ++kt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[kt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MAX_HEAD_DIM; kk += 16) {
    if (kk >= ndt * 8) break;
    uint32_t a[4];
    ldmatrix_x4(a, qs + (r0 + (lane & 15)) * ld + kk + (lane >> 4) * 8);
#pragma unroll
    for (int kt = 0; kt < MAX_KT; kt += 2) {
      if (kt >= nkt) break;
      // matrices: keys kt*8 .. +7 at d kk and kk + 8, then keys (kt+1)*8 .. +7
      uint32_t bf[4];
      ldmatrix_x4(bf, ks + (kt * 8 + (lane & 7) + ((lane >> 4) << 3)) * ld + kk +
                          ((lane >> 3) & 1) * 8);
      mma_k16(s[kt], a, bf[0], bf[1]);
      mma_k16(s[kt + 1], a, bf[2], bf[3]);
    }
  }

  // softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3), the first version's
  // rounding places: scale, then bias, each rounded; expf; IEEE e / sum.
  // The accumulator layout: [key tile][row g: keys 2qd, 2qd + 1; row g + 8]
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kt = 0; kt < MAX_KT; ++kt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8, key = kt * 8 + 2 * qd + (e & 1);
      const float x = (kt < nkt && key < O && row < O)
                          ? __fadd_rn(__fmul_rn(s[kt][e], scale), bs[row * O + key])
                          : (key < O ? 0.f : -INFINITY);
      s[kt][e] = x;
      m[e >> 1] = fmaxf(m[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
#pragma unroll
  for (int kt = 0; kt < MAX_KT; ++kt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[kt][e] = expf(s[kt][e] - m[e >> 1]);
      sum[e >> 1] += s[kt][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  // O = P V: p rounded to bf16 as it is packed into A fragments; 16 keys a
  // k-step, V's B fragments by ldmatrix.trans from its [token][d] rows
  float o[MAX_DT][4];
#pragma unroll
  for (int dt = 0; dt < MAX_DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < MAX_KT; kt += 2) {
    if (kt >= nkt) break;
    uint32_t a[4];
    a[0] = pack_bf16(__fdiv_rn(s[kt][0], sum[0]), __fdiv_rn(s[kt][1], sum[0]));
    a[1] = pack_bf16(__fdiv_rn(s[kt][2], sum[1]), __fdiv_rn(s[kt][3], sum[1]));
    a[2] = pack_bf16(__fdiv_rn(s[kt + 1][0], sum[0]), __fdiv_rn(s[kt + 1][1], sum[0]));
    a[3] = pack_bf16(__fdiv_rn(s[kt + 1][2], sum[1]), __fdiv_rn(s[kt + 1][3], sum[1]));
#pragma unroll
    for (int dt = 0; dt < MAX_DT; dt += 2) {
      if (dt >= ndt) break;
      // matrices: keys kt*8 .. +7 and +8 .. +15 at d dt*8, then at d dt*8 + 8
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vs + (kt * 8 + (lane & 15)) * ld + dt * 8 + (lane >> 4) * 8);
      mma_k16(o[dt], a, bf[0], bf[1]);
      mma_k16(o[dt + 1], a, bf[2], bf[3]);
    }
  }

  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < MAX_DT; ++dt) {
    if (dt >= ndt) break;
    const int col = dt * 8 + 2 * qd;
    *reinterpret_cast<uint32_t*>(qs + (r0 + g) * ld + col) = pack_bf16(o[dt][0], o[dt][1]);
    *reinterpret_cast<uint32_t*>(qs + (r0 + g + 8) * ld + col) = pack_bf16(o[dt][2], o[dt][3]);
  }
  __syncwarp();
  switch (vout) {
    case 8: store_rows<8>(ob, qs, out_token_stride, r0, O, d, ld, lane); break;
    case 4: store_rows<4>(ob, qs, out_token_stride, r0, O, d, ld, lane); break;
    case 2: store_rows<2>(ob, qs, out_token_stride, r0, O, d, ld, lane); break;
    default: store_rows<1>(ob, qs, out_token_stride, r0, O, d, ld, lane); break;
  }
}

template <int VIN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
window_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, Strides st, int B, int h, int O,
                           int d, int nW, float scale, int vout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = padded_d(d) + PAD;
  const Item it = item_of(blockIdx.x, B, h, nW);
  const int lead = fetch<VIN>(smem_raw, it, q, k, v, bias, st, O, d, ld);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (int(threadIdx.x) / 32 * 16 < O)     // the warp has query rows
    attend(reinterpret_cast<__nv_bfloat16*>(smem_raw),
           reinterpret_cast<float*>(smem_raw + qkv_bytes(d)) + lead,
           out + it.n * st.out[0] + it.head * st.out[1], st.out[2], O, d, ld, scale, vout);
}

// The widest chunk, in bf16 elements, that divides d and every stride of
// the tensors and to whose bytes their bases are aligned.
inline int chunk_width(int d, const void* const* ptrs, const long long* const* strides, int count) {
  for (int vec = 8; vec > 1; vec /= 2) {
    bool ok = d % vec == 0;
    for (int i = 0; i < count && ok; ++i) {
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % (2 * vec) == 0;
      for (int j = 0; j < 3; ++j) ok = ok && strides[i][j] % vec == 0;
    }
    if (ok) return vec;
  }
  return 1;
}

template <int VIN>
int launch_vec(const void* q, const void* k, const void* v, const void* bias, void* out,
               const Strides& st, int n, int h, int O, int d, int nW, float scale, int vout,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(O, d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(window_attention_tc_kernel<VIN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(smem));
    if (err != cudaSuccess) return int(err);
  }
  window_attention_tc_kernel<VIN><<<n * h, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), st, n / nW, h, O, d, nW, scale, vout);
  return int(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           const Strides& st, int n, int h, int O, int d, int nW, float scale,
           cudaStream_t stream) {
  const void* in_ptrs[3] = {q, k, v};
  const long long* in_strides[3] = {st.q, st.k, st.v};
  const void* out_ptrs[1] = {out};
  const long long* out_strides[1] = {st.out};
  const int vin = chunk_width(d, in_ptrs, in_strides, 3);
  const int vout = chunk_width(d, out_ptrs, out_strides, 1);
  switch (vin) {
    case 8: return launch_vec<8>(q, k, v, bias, out, st, n, h, O, d, nW, scale, vout, stream);
    case 4: return launch_vec<4>(q, k, v, bias, out, st, n, h, O, d, nW, scale, vout, stream);
    case 2: return launch_vec<2>(q, k, v, bias, out, st, n, h, O, d, nW, scale, vout, stream);
    default: return launch_vec<1>(q, k, v, bias, out, st, n, h, O, d, nW, scale, vout, stream);
  }
}

}  // namespace tc

bool valid_sizes(int n, int h, int O, int d, int nW) {
  return n > 0 && h > 0 && O > 0 && O <= MAX_TOKENS && d > 0 && d <= MAX_HEAD_DIM && nW > 0 &&
         n % nW == 0 && (long long)n * h <= 0x7fffffffLL;
}

Strides unpack(const long long* strides) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.bias[i] = strides[9 + i];
    st.out[i] = strides[12 + i];
  }
  return st;
}

}  // namespace

// q, k, v, out: (n, h, O, d) in the compute type; bias (nW, h, O, O) float32.
// strides: 15 element strides, (window, head, token) of q, k, v, bias and
// out in that order; every tensor's last dimension is contiguous.
// dtype 0 = float32, 1 = bfloat16.  The first, CUDA-core version.
extern "C" int window_attention_launch(const void* q, const void* k, const void* v,
                                       const void* bias, void* out,
                                       const long long* strides, int n, int h, int O,
                                       int d, int nW, float scale, int dtype,
                                       void* stream) {
  if (!valid_sizes(n, h, O, d, nW)) return int(cudaErrorInvalidValue);
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, bias, out, st, n, h, O, d, nW, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, out, st, n, h, O, d, nW, scale, s);
  return int(cudaErrorInvalidValue);
}

// The tensor-core version: the same arguments, bfloat16 only (dtype 1).
extern "C" int window_attention_bf16_launch(const void* q, const void* k, const void* v,
                                            const void* bias, void* out,
                                            const long long* strides, int n, int h, int O,
                                            int d, int nW, float scale, int dtype,
                                            void* stream) {
  if (!valid_sizes(n, h, O, d, nW) || dtype != 1) return int(cudaErrorInvalidValue);
  return tc::launch(q, k, v, bias, out, unpack(strides), n, h, O, d, nW, scale,
                    static_cast<cudaStream_t>(stream));
}
