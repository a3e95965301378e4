// One-token GQA decode attention (flash-decoding), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py:_decode_kernel (pl.pallas_call at
// decode_attention.py:106): q (B, H, D) against a KV cache of S tokens
// of which the first valid_len count, with an online softmax over S.
//
// What bounds it: bytes.  Each step streams K and V up to valid_len once
// (2 * B * KVH * valid_len * D elements) for ~4 flops per element, far
// below the card's flop/byte balance.  The TPU kernel walks S as the
// sequential innermost axis of a (B, KVH, n_s) grid; here the blocks run
// in parallel, and a (B, KVH) grid alone would leave most of the 132 SMs
// idle at serving batch sizes.  Design:
//   * split_kernel: one block per (split, kv_head, batch).  It takes the
//     G = H / KVH query heads that share the KV head, walks its split of
//     the cache in tiles of `tile` tokens and keeps the online-softmax
//     state (running max m, running sum l) in shared memory and the
//     unnormalised output in registers, all in float32.  Scores: each warp
//     takes whole tokens, its lanes split D and read the K row coalesced;
//     a butterfly of shuffles sums the G dot products.  The V tile is
//     staged in shared memory as float32.  It writes the partial (o, m, l)
//     of its split to float32 scratch that the wrapper allocates.
//   * merge_kernel: one block per (query head, batch) combines the splits
//     with the log-sum-exp algebra of repro/models/common.py:merge_partials
//     and writes the output in the input's type.
// Splits never start at or past valid_len (the wrapper sizes the grid from
// it) and the ragged tail of the last tile is masked, so there is no
// S % block_s requirement.  Caches are addressed through element strides of
// their (batch, kv head, token) axes, so the model's head-major
// (B, KVH, S, D) cache and the reference's (B, S, KVH, D) one are read in
// place.  Any D <= 256 and G <= 16.  wgmma, TMA and tuning are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int MAXG = 16;       // query heads per KV head
constexpr int MAXJ = 16;       // (g, d) pairs per thread: G * D <= NT * MAXJ

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ o_part,
    float* __restrict__ ml_part, int H, int KVH, int D, int valid_len,
    int split_len, int n_splits, int tile, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int GD = G * D;
  float* q_s = smem;              // [G][D]     query heads of this KV head
  float* v_s = q_s + GD;          // [tile][D]  V tile
  float* p_s = v_s + tile * D;    // [G][tile]  scores, then probabilities
  float* m_s = p_s + G * tile;    // [G]        running max
  float* l_s = m_s + G;           // [G]        running sum
  float* c_s = l_s + G;           // [G]        rescale of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + (static_cast<long long>(b) * H + kvh * G) * D;
  for (int i = tid; i < GD; i += NT) q_s[i] = ld(qb + i);
  for (int g = tid; g < G; g += NT) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }
  float acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.0f;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int s_begin = split * split_len;
  const int s_end = min(s_begin + split_len, valid_len);
  __syncthreads();

  for (int t0 = s_begin; t0 < s_end; t0 += tile) {
    const int nt = min(tile, s_end - t0);
    // scores q . k * scale: warp per token, lanes over D
    for (int t = warp; t < nt; t += NW) {
      const T* kr = kb + static_cast<long long>(t0 + t) * k_ss;
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float kd = ld(kr + d);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) part[g] = fmaf(q_s[g * D + d], kd, part[g]);
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float s = warp_sum(part[g]);
          if (lane == 0) p_s[g * tile + t] = s * scale;
        }
      }
    }
    // stage the V tile as float32
    for (int i = tid; i < nt * D; i += NT) {
      const int t = i / D, d = i - t * D;
      v_s[i] = ld(vb + static_cast<long long>(t0 + t) * v_ss + d);
    }
    __syncthreads();
    // online softmax over the tile: warp per query head
    for (int g = warp; g < G; g += NW) {
      float* pr = p_s + g * tile;
      float mx = -INFINITY;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        c_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g][d] = acc[g][d] * c[g] + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int idx = tid + j * NT;
      if (idx < GD) {
        const int g = idx / D, d = idx - g * D;
        const float* pr = p_s + g * tile;
        float a = acc[j] * c_s[g];
        for (int t = 0; t < nt; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  const long long base =
      (static_cast<long long>(b) * KVH + kvh) * n_splits + split;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int idx = tid + j * NT;
    if (idx < GD) o_part[base * GD + idx] = acc[j];
  }
  for (int g = tid; g < G; g += NT) {
    ml_part[(base * G + g) * 2] = m_s[g];
    ml_part[(base * G + g) * 2 + 1] = l_s[g];
  }
}

template <typename T>
__global__ void merge_kernel(const float* __restrict__ o_part,
                             const float* __restrict__ ml_part,
                             T* __restrict__ out, int H, int KVH, int D,
                             int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / KVH, kvh = h / G, g = h - kvh * G;
  const long long first = (static_cast<long long>(b) * KVH + kvh) * n_splits;
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    m = fmaxf(m, ml_part[((first + s) * G + g) * 2]);
  float l = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const float* ml = ml_part + ((first + s) * G + g) * 2;
    l += ml[1] * expf(ml[0] - m);
  }
  l = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.0f;
    for (int s = 0; s < n_splits; ++s) {
      const float c = expf(ml_part[((first + s) * G + g) * 2] - m);
      o += o_part[((first + s) * G + g) * D + d] * c;
    }
    st(out + (static_cast<long long>(b) * H + h) * D + d, o / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* o_part, float* ml_part, int B, int H, int KVH, int D,
           int valid_len, int split_len, int n_splits, int tile,
           long long k_sb, long long k_sh, long long k_ss, long long v_sb,
           long long v_sh, long long v_ss, float scale, cudaStream_t st) {
  const int G = H / KVH;
  const size_t smem = sizeof(float) * (G * D + tile * D + G * tile + 3 * G);
  split_kernel<T><<<dim3(n_splits, KVH, B), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o_part, ml_part, H, KVH, D, valid_len,
      split_len, n_splits, tile, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<T><<<dim3(H, B), 128, 0, st>>>(
      o_part, ml_part, static_cast<T*>(out), H, KVH, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q and out are (B, H, D) contiguous; the
// caches are addressed as base + b*sb + kvh*sh + s*ss + d.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, void* out, void* o_part,
    void* ml_part, int dtype, int B, int H, int KVH, int D, int valid_len,
    int split_len, int n_splits, int tile, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, void* stream) {
  if (H % KVH != 0 || H / KVH > MAXG || (H / KVH) * D > NT * MAXJ)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* op = static_cast<float*>(o_part);
  auto* ml = static_cast<float*>(ml_part);
  auto* s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, op, ml, B, H, KVH, D,
                                 valid_len, split_len, n_splits, tile, k_sb,
                                 k_sh, k_ss, v_sb, v_sh, v_ss, scale, s);
  if (dtype == 0)
    return launch<float>(q, k, v, out, op, ml, B, H, KVH, D, valid_len,
                         split_len, n_splits, tile, k_sb, k_sh, k_ss, v_sb,
                         v_sh, v_ss, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
