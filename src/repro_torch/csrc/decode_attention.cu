// One-token GQA decode attention (flash-decoding), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py:_decode_kernel (pl.pallas_call at
// decode_attention.py:106): q (B, H, D) against a KV cache of S tokens
// of which the first valid_len count, with an online softmax over S.
//
// What bounds it: bytes.  Each step streams K and V up to valid_len once
// (2 * B * KVH * valid_len * D elements) for about 2 G flops a byte (G =
// H / KVH query heads share each KV head), far below the card's 295, so
// tensor cores do not pay: the design keeps 16-byte loads in flight.
//   * One block of 128 threads per (split, kv head, batch).  A lane holds
//     8 consecutive dims of a K or V row (one 16-byte load in bf16, two in
//     float32); a group of LANES = D/8 lanes (rounded up to a power of two;
//     D = 80 uses 10 of 16, the idle lanes masked) covers a row, so a warp
//     reads 32 / LANES tokens per load.  Each lane loads U tokens' K and V
//     rows at once (tokens_per_load: 1 to 4, as registers allow) and the
//     next U tokens' rows before it uses these, so loads stay in flight
//     while the scores and P.V are computed.  V is used from registers as
//     it was loaded: no pass through shared memory.
//   * Each thread keeps its slice of the G query heads (HG = 1, 2, 4 or 8
//     heads; G > 8 splits the warps into two slices that each read the
//     rows) at its 8 dims in registers, pre-scaled by D**-0.5 log2 e, and
//     the float32 online-softmax state (m, l) and unnormalised output of
//     those heads and dims for the tokens it reads.  Scores reduce over the
//     lane group with shuffles.
//   * The wrapper sizes the splits so that the grid is at most one wave of
//     the blocks the SMs hold at once (decode_blocks_per_sm).  At the end
//     of its split the block merges the states of its lane groups
//     (shuffles) and warps (shared memory).  With one split it writes the
//     output; otherwise it writes its partial (o, m, l) to float32 scratch
//     and bumps an arrival counter of its (batch, kv head): the last block
//     to arrive merges the splits with the log-sum-exp algebra of
//     repro/models/common.py:merge_partials, writes the output and resets
//     the counter.  One launch either way.
// Tokens past the split's end are masked, so there is no S % tile
// requirement.  Caches are addressed through element strides of their
// (batch, kv head, token) axes, so the model's head-major (B, KVH, S, D)
// cache and the reference's (B, S, KVH, D) one are read in place.  Any
// D <= 256 and G <= 16; a D, stride or base that does not allow 16-byte
// loads takes element loads in the same kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 128;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int MAXG = 16;       // query heads per KV head
constexpr int MAXD = 256;      // head_dim
constexpr int DPL = 8;         // dims a lane holds
constexpr int MAX_SPLITS = 256;  // the merge's weights reuse red_o
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 consecutive elements of a row: one 16-byte word in bf16, two in f32
template <typename T>
struct Row8 {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load8(Row8<T>& r, const T* row, int d0,
                                      int D, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
      r.w[i] = __ldg(reinterpret_cast<const uint4*>(row + d0) + i);
  } else {
    T* e = reinterpret_cast<T*>(r.w);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      e[i] = d0 + i < D ? row[d0 + i] : static_cast<T>(0.0f);
  }
}

__device__ __forceinline__ void to_float(const Row8<__nv_bfloat16>& r,
                                         float (&x)[DPL]) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void to_float(const Row8<float>& r,
                                         float (&x)[DPL]) {
  const auto* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int i = 0; i < DPL; ++i) x[i] = f[i];
}

// tokens a lane loads at once: 32 (bf16) or 64 (float32) bytes of K and
// of V a token, double-buffered, within the registers HG heads leave
template <typename T, int HG>
__host__ __device__ constexpr int tokens_per_load() {
  return sizeof(T) == 2 ? (HG >= 8 ? 2 : 4) : (HG >= 4 ? 1 : 2);
}

template <typename T, int U>
__device__ __forceinline__ void load_tokens(Row8<T> (&kr)[U],
                                            Row8<T> (&vr)[U], const T* kb,
                                            const T* vb, long long k_ss,
                                            long long v_ss, int t0, int step,
                                            int s_end, int d0, int D,
                                            bool active, bool vec) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int tok = t0 + u * step;
    if (active && tok < s_end) {
      load8(kr[u], kb + tok * k_ss, d0, D, vec);
      load8(vr[u], vb + tok * v_ss, d0, D, vec);
    } else {
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
        kr[u].w[i] = vr[u].w[i] = make_uint4(0, 0, 0, 0);
    }
  }
}

template <typename T, int HG>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ o_part,
    float* __restrict__ ml_part, int* __restrict__ counters, int H, int KVH,
    int D, int lanes, int valid_len, int split_len, int n_splits, int vec,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale_log2) {
  constexpr int U = tokens_per_load<T, HG>();
  __shared__ float red_o[NW][HG][MAXD];     // then the merge's weights
  __shared__ float red_m[NW][HG], red_l[NW][HG];
  __shared__ int is_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int n_slices = (G + HG - 1) / HG;       // 1, or 2 when G > 8
  const int wps = NW / n_slices;                // warps a slice
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = warp / wps, wis = warp % wps;
  const int grp = lane / lanes, li = lane % lanes;
  const int tpw = 32 / lanes;                   // tokens a warp loads
  const int step = wps * tpw;                   // tokens between a lane's U
  const int d0 = li * DPL;
  const bool active = d0 < D;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int s_begin = split * split_len;
  const int s_end = min(s_begin + split_len, valid_len);
  const int lane_tok = wis * tpw + grp;         // this lane group's first
  Row8<T> kr[U], vr[U];
  load_tokens<T, U>(kr, vr, kb, vb, k_ss, v_ss, s_begin + lane_tok, step,
                    s_end, d0, D, active, vec);

  // this thread's heads at its dims, pre-scaled
  float qv[HG][DPL];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const int g = slice * HG + hh;
    Row8<T> qr;
    if (g < G && active)
      load8(qr, q + (static_cast<long long>(b) * H + kvh * G + g) * D, d0,
            D, vec);
    else
      for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i)
        qr.w[i] = make_uint4(0, 0, 0, 0);
    to_float(qr, qv[hh]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) qv[hh][i] *= scale_log2;
  }
  float m[HG], l[HG], acc[HG][DPL];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[hh][i] = 0.0f;
  }

  // the bounds are the block's, so every lane takes part in the shuffles;
  // the next tokens' rows load while these are used
  for (int base = s_begin; base < s_end; base += U * step) {
    const int t0 = base + lane_tok;
    Row8<T> kn[U], vn[U];
    load_tokens<T, U>(kn, vn, kb, vb, k_ss, v_ss, t0 + U * step, step,
                      s_end, d0, D, active, vec);
    float s[U][HG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[DPL];
      to_float(kr[u], kx);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part = fmaf(qv[hh][i], kx[i], part);
        for (int o = lanes >> 1; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[u][hh] = t0 + u * step < s_end ? part : -INFINITY;
      }
    }
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      float mx = s[0][hh];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][hh]);
      const float m_new = fmaxf(m[hh], mx);
      const float corr = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[hh][i] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[DPL];
      to_float(vr[u], vx);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const float p = exp2f(s[u][hh] - m[hh]);   // 0 where masked
        l[hh] += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[hh][i] = fmaf(p, vx[i], acc[hh][i]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // merge the lane groups of the warp (same dims, other tokens)
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[hh], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[hh], o);
      const float mm = fmaxf(m[hh], mo);
      const float a = exp2f(m[hh] - mm), c = exp2f(mo - mm);
      l[hh] = l[hh] * a + lo * c;
      m[hh] = mm;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[hh][i] = acc[hh][i] * a +
                     __shfl_xor_sync(0xffffffffu, acc[hh][i], o) * c;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (d0 + i < D) red_o[warp][hh][d0 + i] = acc[hh][i];
      if (li == 0) {
        red_m[warp][hh] = m[hh];
        red_l[warp][hh] = l[hh];
      }
    }
  }
  __syncthreads();

  // merge the warps of each slice: this split's (o, m, l) per head
  const long long bh = static_cast<long long>(b) * KVH + kvh;
  const long long part = bh * n_splits + split;
  T* out_bh = out + (static_cast<long long>(b) * H + kvh * G) * D;
  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx - g * D;
    const int w0 = (g / HG) * wps, hh = g % HG;
    float mm = NEG_INF;
    for (int w = w0; w < w0 + wps; ++w) mm = fmaxf(mm, red_m[w][hh]);
    float ll = 0.0f, oo = 0.0f;
    for (int w = w0; w < w0 + wps; ++w) {
      const float c = exp2f(red_m[w][hh] - mm);
      ll += red_l[w][hh] * c;
      oo += red_o[w][hh][d] * c;
    }
    if (n_splits == 1) {
      st(out_bh + idx, oo / ll);
    } else {
      o_part[part * G * D + idx] = oo;
      if (d == 0) {
        ml_part[(part * G + g) * 2] = mm;
        ml_part[(part * G + g) * 2 + 1] = ll;
      }
    }
  }
  if (n_splits == 1) return;

  // the last split of (b, kv head) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(counters + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // weights w[sp][g] = exp2(m - M) / L of each split and head
  float* w = &red_o[0][0][0];
  const float* ml_bh = ml_part + bh * n_splits * G * 2;
  for (int i = tid; i < n_splits * G; i += NT) w[i] = __ldcg(ml_bh + 2 * i);
  __syncthreads();
  if (tid < G) {
    float mm = NEG_INF, ll = 0.0f;
    for (int sp = 0; sp < n_splits; ++sp) mm = fmaxf(mm, w[sp * G + tid]);
#pragma unroll 8
    for (int sp = 0; sp < n_splits; ++sp)
      ll += __ldcg(ml_bh + 2 * (sp * G + tid) + 1) *
            exp2f(w[sp * G + tid] - mm);
    for (int sp = 0; sp < n_splits; ++sp)
      w[sp * G + tid] = exp2f(w[sp * G + tid] - mm) / ll;
  }
  __syncthreads();
  const float* o_bh = o_part + bh * n_splits * G * D;
  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D;
    float oo = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < n_splits; ++sp)
      oo += w[sp * G + g] * __ldcg(o_bh + static_cast<long long>(sp) * G * D +
                                   idx);
    st(out_bh + idx, oo);
  }
  if (tid == 0) counters[bh] = 0;
}

template <typename T, int HG>
int launch(const void* q, const void* k, const void* v, void* out,
           float* o_part, float* ml_part, int* counters, int B, int H,
           int KVH, int D, int lanes, int valid_len, int split_len,
           int n_splits, int vec, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           float scale, cudaStream_t stream) {
  decode_kernel<T, HG><<<dim3(n_splits, KVH, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), o_part, ml_part,
      counters, H, KVH, D, lanes, valid_len, split_len, n_splits, vec, k_sb,
      k_sh, k_ss, v_sb, v_sh, v_ss, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hg, const void* q, const void* k, const void* v, void* out,
             float* op, float* ml, int* cnt, int B, int H, int KVH, int D,
             int lanes, int valid_len, int split_len, int n_splits, int vec,
             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
             long long v_sh, long long v_ss, float scale, cudaStream_t s) {
  switch (hg) {
    case 1:
      return launch<T, 1>(q, k, v, out, op, ml, cnt, B, H, KVH, D, lanes,
                          valid_len, split_len, n_splits, vec, k_sb, k_sh,
                          k_ss, v_sb, v_sh, v_ss, scale, s);
    case 2:
      return launch<T, 2>(q, k, v, out, op, ml, cnt, B, H, KVH, D, lanes,
                          valid_len, split_len, n_splits, vec, k_sb, k_sh,
                          k_ss, v_sb, v_sh, v_ss, scale, s);
    case 4:
      return launch<T, 4>(q, k, v, out, op, ml, cnt, B, H, KVH, D, lanes,
                          valid_len, split_len, n_splits, vec, k_sb, k_sh,
                          k_ss, v_sb, v_sh, v_ss, scale, s);
    case 8:
      return launch<T, 8>(q, k, v, out, op, ml, cnt, B, H, KVH, D, lanes,
                          valid_len, split_len, n_splits, vec, k_sb, k_sh,
                          k_ss, v_sb, v_sh, v_ss, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int HG>
int occupancy(int* n) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, decode_kernel<T, HG>, NT, 0));
}

template <typename T>
int blocks_per_sm(int hg) {
  int n = 0, err = static_cast<int>(cudaErrorInvalidValue);
  if (hg == 1) err = occupancy<T, 1>(&n);
  if (hg == 2) err = occupancy<T, 2>(&n);
  if (hg == 4) err = occupancy<T, 4>(&n);
  if (hg == 8) err = occupancy<T, 8>(&n);
  return err == 0 ? n : -err;
}

}  // namespace

// Blocks of the (dtype, hg) kernel resident on one SM at a time, or minus
// a CUDA error code.
extern "C" int decode_blocks_per_sm(int dtype, int hg) {
  if (dtype == 1) return blocks_per_sm<__nv_bfloat16>(hg);
  if (dtype == 0) return blocks_per_sm<float>(hg);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 bfloat16.  q and out are (B, H, D) contiguous; the
// caches are addressed as base + b*sb + kvh*sh + s*ss + d.  hg: query
// heads a thread holds (1, 2, 4 or 8, at least min(G, 8)); lanes: a power
// of two >= D / 8; vec: 1 when every row start is 16-byte aligned and D a
// multiple of 8.  o_part (B*KVH*n_splits*G*D) and ml_part
// (B*KVH*n_splits*G*2) are float32 scratch, counters (B*KVH) int32 zeros
// that the kernel leaves zero.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, void* out, void* o_part,
    void* ml_part, void* counters, int dtype, int B, int H, int KVH, int D,
    int hg, int lanes, int valid_len, int split_len, int n_splits, int vec,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, void* stream) {
  const int G = KVH > 0 ? H / KVH : 0;
  if (KVH < 1 || H % KVH != 0 || G > MAXG || D < 1 || D > MAXD ||
      (G + hg - 1) / hg > 2 || lanes < 1 || lanes > 32 ||
      n_splits < 1 || n_splits > MAX_SPLITS ||
      (lanes & (lanes - 1)) != 0 || lanes * DPL < D)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* op = static_cast<float*>(o_part);
  auto* ml = static_cast<float*>(ml_part);
  auto* cnt = static_cast<int*>(counters);
  auto* s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hg, q, k, v, out, op, ml, cnt, B, H, KVH,
                                   D, lanes, valid_len, split_len, n_splits,
                                   vec, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                                   scale, s);
  if (dtype == 0)
    return dispatch<float>(hg, q, k, v, out, op, ml, cnt, B, H, KVH, D,
                           lanes, valid_len, split_len, n_splits, vec, k_sb,
                           k_sh, k_ss, v_sb, v_sh, v_ss, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
