// Causal / sliding-window GQA flash-attention forward, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py:_flash_kernel (pl.pallas_call at
// flash_attention.py:111): q (B, Sq, H, D) against k/v (B, Skv, KVH, D),
// scale D**-0.5, online softmax over key tiles, causal, optional window
// and kv_len masks.  Query head h reads KV head h / G (G = H / KVH) in
// place: KV is never expanded.  Beside the output it writes the float32
// row log-sum-exp lse = m + log(max(l, 1e-30)), shape (B, H, Sq), the
// residual the backward (models/common.py) recomputes tiles from.
//
// What bounds it: operations.  At the training shapes (S = 4096) each
// (q, k) pair costs 4 * D flops against a few bytes of q/k/v, far above
// the card's flop/byte balance.  This first kernel runs the two products
// on the CUDA cores in float32 (no tensor cores), so it reaches a small
// share of the bf16 tensor-core bound; the tensor-core (mma.sync/wgmma)
// redesign is later work.  Design:
//   * one block of 128 threads per (q tile of 64 rows, head, batch); the
//     q tiles are walked in reverse so the longest causal rows start
//     first;
//   * the block loops over key tiles of 64, from the first tile the
//     window can reach to the last one the causal and kv_len limits
//     allow: tiles wholly outside them are never loaded;
//   * q and each K tile are staged in shared memory transposed ([D][64+1],
//     padded against bank conflicts), the V tile row-major, all float32;
//   * thread (rg, cg) = (tid / 8, tid % 8) owns rows 4*rg .. 4*rg+3 and
//     key columns cg + 8*j of the score tile, and output columns cg + 8*j;
//     the 8 threads of a row group reduce the row max and sum with
//     shuffles; probabilities go through shared memory to the P.V product;
//   * the online-softmax state (m, l) and the output accumulator live in
//     registers in float32; O is written in the input's type.
// Masked scores are -inf, so masked keys give p = 0 exactly and a row with
// no visible key ends with l = 0 and output 0 (not NaN).  Any Sq and Skv:
// ragged tails are zero-filled and masked.  D is a template parameter
// (16, 32, 64, 80, 128, 256); D = 256 needs 215,296 bytes of dynamic
// shared memory, opted in with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 128;         // threads: 16 row groups x 8 column groups
constexpr int RPT = 4;          // rows per thread (BQ / 16)
constexpr int CPT = 8;          // score columns per thread (BK / 8)
constexpr int QS = BQ + 1;      // stride of the transposed q tile
constexpr int KS = BK + 1;      // stride of the transposed K tile
constexpr int PS = BK + 1;      // stride of the probability tile
constexpr float NEG_INF = -1e30f;

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(D) * QS + D * KS + BK * D +
                          BQ * PS);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// reductions over the 8 lanes of a row group (lanes 8i .. 8i+7)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int Sq, int Skv, int H, int KVH, int causal, int window, int kv_lim,
    int q_offset, float scale) {
  constexpr int NJ = (D + 7) / 8;       // output columns per thread
  extern __shared__ float smem[];
  float* q_t = smem;                    // [D][QS]  q tile, transposed
  float* k_t = q_t + D * QS;            // [D][KS]  K tile, transposed
  float* v_s = k_t + D * KS;            // [BK][D]  V tile
  float* p_s = v_s + BK * D;            // [BQ][PS] probabilities

  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const T* qb = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Skv * KVH + kvh) * D;
  const T* vb = v + (static_cast<long long>(b) * Skv * KVH + kvh) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    q_t[d * QS + r] = row < Sq ? ld(qb + row * q_stride + d) : 0.0f;
  }

  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // the key range any row of this tile can see
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin -= k_begin % BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();      // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i - r * D;
      const int key = k0 + r;
      const bool in = key < Skv;
      const long long off = key * kv_stride + d;
      k_t[d * KS + r] = in ? ld(kb + off) : 0.0f;
      v_s[i] = in ? ld(vb + off) : 0.0f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RPT], kk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = q_t[d * QS + rg * RPT + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kk[j] = k_t[d * KS + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_lo + rg * RPT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int key = k0 + cg + 8 * j;
        bool ok = key < kv_lim;
        if (causal) ok = ok && key <= qpos;
        if (window > 0) ok = ok && qpos - key < window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);      // 0 where masked
        p_s[(rg * RPT + i) * PS + cg + 8 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = p_s[(rg * RPT + i) * PS + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 8 * j;
        if (c < D) {
          const float vv = v_s[t * D + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    if (row < Sq) {
      const float ls = fmaxf(l[i], 1e-30f);
      T* orow = out + (static_cast<long long>(b) * Sq + row) * q_stride +
                static_cast<long long>(h) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 8 * j;
        if (c < D) st(orow + c, acc[i][j] / ls);
      }
      if (cg == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + row] = m[i] + logf(ls);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int KVH, int causal,
           int window, int kv_lim, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, H, KVH,
      causal, window, kv_lim, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Skv, int H, int KVH, int D,
             int causal, int window, int kv_lim, int q_offset, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, B, Sq, Skv, H, KVH, causal,
                           window, kv_lim, q_offset, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, Sq, Skv, H, KVH, causal,
                           window, kv_lim, q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Sq, Skv, H, KVH, causal,
                           window, kv_lim, q_offset, scale, s);
    case 80:
      return launch<T, 80>(q, k, v, out, lse, B, Sq, Skv, H, KVH, causal,
                           window, kv_lim, q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Sq, Skv, H, KVH, causal,
                            window, kv_lim, q_offset, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, Sq, Skv, H, KVH, causal,
                            window, kv_lim, q_offset, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q and out (B, Sq, H, D), k and v
// (B, Skv, KVH, D), lse (B, H, Sq) float32, all contiguous.  window <= 0
// means none; keys at or past kv_lim are masked; q_offset is the absolute
// position of q row 0.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int dtype, int B, int Sq, int Skv, int H,
                                   int KVH, int D, int causal, int window,
                                   int kv_lim, int q_offset, float scale,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* l = static_cast<float*>(lse);
  auto* s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, l, B, Sq, Skv, H, KVH, D,
                                   causal, window, kv_lim, q_offset, scale,
                                   s);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, l, B, Sq, Skv, H, KVH, D, causal,
                           window, kv_lim, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
