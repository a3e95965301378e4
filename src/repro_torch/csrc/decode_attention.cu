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
//     DPL consecutive dims of a K or V row (8: one 16-byte load in bf16,
//     two in float32; an int8 cache below); a group of LANES = D/DPL
//     lanes (rounded up to a power of two; D = 80 in bf16 uses 10 of 16,
//     the idle lanes masked) covers a row, so a warp reads 32 / LANES
//     tokens per load.  Each lane loads U tokens' K and V
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
//     the counter.  One launch either way.  The merged (m, l) of each row
//     also give its log-sum-exp (an optional output, for a
//     sequence-sharded cache whose shards merge across ranks).
// The int8 cache (the model's `kv_quant`) under a float32 q (a bf16 q
// takes decode_attention_int8.cu): payloads int8 in the same layout and
// strides, with float32 scales of each (batch, kv head, token) in
// contiguous (B, KVH, S) arrays; q and out stay float32.
// A lane then holds 16 dims of a row (one 16-byte load) while its heads'
// q and accumulators leave the registers (HG <= 4), else 8 (an 8-byte
// load).  Rows are widened to float32 in registers; the score is
// (q . k) * D**-0.5 * k_scale[t], and the probability that weighs V row
// t is multiplied by v_scale[t] before the V accumulation (the
// reference's einsum, repro/models/attention.py:146-166); the split merge
// is the float kernel's.
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
constexpr int DPL = 8;         // dims a lane holds (bf16, f32; int8 at HG 8)
constexpr int DPL_INT8 = 16;   // dims a lane holds of an int8 cache, HG <= 4
constexpr int MAX_SPLITS = 256;  // the merge's weights reuse red_o
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One launch's arguments (the C entry point's, typed by the kernel).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;             // (B, H) float32 row log-sum-exp, or null
  float* o_part;
  float* ml_part;
  int* counters;
  const float* k_scale;   // int8 cache only: (B, KVH, scale_len)
  const float* v_scale;
  int H, KVH, D, lanes, valid_len, split_len, n_splits, vec, scale_len;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale_log2;
};

__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// dims a lane holds of a cache of element type C: 16 int8 fill a 16-byte
// load, but 16 dims of 8 heads' q and accumulators would not fit the
// registers
template <typename C, int HG>
__host__ __device__ constexpr int dims_per_lane() {
  return sizeof(C) == 1 && HG <= 4 ? DPL_INT8 : DPL;
}

// tokens a lane loads at once: K and V rows of a token (32 bytes in bf16,
// 64 in float32, 32 or 16 in int8), double-buffered, within the registers
// HG heads leave
template <typename C, int HG>
__host__ __device__ constexpr int tokens_per_load() {
  if (sizeof(C) == 1) return HG == 4 ? 2 : 4;
  return sizeof(C) == 2 ? (HG >= 8 ? 2 : 4) : (HG >= 4 ? 1 : 2);
}

// N consecutive elements of a row, in 16-byte words (8 int8: half a word)
template <typename E, int N>
struct Row {
  uint4 w[(N * static_cast<int>(sizeof(E)) + 15) / 16];
};

template <typename E, int N>
__device__ __forceinline__ void zero_row(Row<E, N>& r) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(r.w) / 16); ++i)
    r.w[i] = make_uint4(0, 0, 0, 0);
}

template <typename E, int N>
__device__ __forceinline__ void load_row(Row<E, N>& r, const E* row, int d0,
                                         int D, bool vec) {
  constexpr int BYTES = N * static_cast<int>(sizeof(E));
  if (vec) {
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i)
        r.w[i] = __ldg(reinterpret_cast<const uint4*>(row + d0) + i);
    } else {
      const uint2 h = __ldg(reinterpret_cast<const uint2*>(row + d0));
      r.w[0] = make_uint4(h.x, h.y, 0, 0);
    }
  } else {
    zero_row(r);
    E* e = reinterpret_cast<E*>(r.w);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (d0 + i < D) e[i] = row[d0 + i];
  }
}

template <int N>
__device__ __forceinline__ void to_float(const Row<__nv_bfloat16, N>& r,
                                         float (&x)[N]) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void to_float(const Row<float, N>& r,
                                         float (&x)[N]) {
  const auto* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = f[i];
}
template <int N>
__device__ __forceinline__ void to_float(const Row<int8_t, N>& r,
                                         float (&x)[N]) {
  const auto* u = reinterpret_cast<const uint32_t*>(r.w);
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = static_cast<float>(
        static_cast<int8_t>((u[i / 4] >> (8 * (i % 4))) & 0xffu));
}

// U tokens' K and V rows at this lane's dims, and with an int8 cache
// their scales (every lane of a group reads the same two words)
template <typename C, int N, int U, bool QUANT>
__device__ __forceinline__ void load_tokens(
    Row<C, N> (&kr)[U], Row<C, N> (&vr)[U], float (&ks)[U], float (&vs)[U],
    const C* kb, const C* vb, const float* ksb, const float* vsb,
    long long k_ss, long long v_ss, int t0, int step, int s_end, int d0,
    int D, bool active, bool vec) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int tok = t0 + u * step;
    if (active && tok < s_end) {
      load_row(kr[u], kb + tok * k_ss, d0, D, vec);
      load_row(vr[u], vb + tok * v_ss, d0, D, vec);
    } else {
      zero_row(kr[u]);
      zero_row(vr[u]);
    }
    if constexpr (QUANT) {
      ks[u] = tok < s_end ? __ldg(ksb + tok) : 0.0f;
      vs[u] = tok < s_end ? __ldg(vsb + tok) : 0.0f;
    }
  }
}

// T: q and out (float or bf16); C: the caches (T, or int8 with scales)
template <typename T, typename C, int HG>
__global__ void __launch_bounds__(NT) decode_kernel(const Args a) {
  constexpr int N = dims_per_lane<C, HG>();
  constexpr int U = tokens_per_load<C, HG>();
  constexpr bool QUANT = sizeof(C) == 1;
  __shared__ float red_o[NW][HG][MAXD];     // then the merge's weights
  __shared__ float red_m[NW][HG], red_l[NW][HG];
  __shared__ int is_last;

  const int H = a.H, KVH = a.KVH, D = a.D, lanes = a.lanes;
  const int n_splits = a.n_splits;
  const bool vec = a.vec != 0;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int n_slices = (G + HG - 1) / HG;       // 1, or 2 when G > 8
  const int wps = NW / n_slices;                // warps a slice
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = warp / wps, wis = warp % wps;
  const int grp = lane / lanes, li = lane % lanes;
  const int tpw = 32 / lanes;                   // tokens a warp loads
  const int step = wps * tpw;                   // tokens between a lane's U
  const int d0 = li * N;
  const bool active = d0 < D;

  const long long bh = static_cast<long long>(b) * KVH + kvh;
  const C* kb = static_cast<const C*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const C* vb = static_cast<const C*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float* ksb = a.k_scale + (QUANT ? bh * a.scale_len : 0);
  const float* vsb = a.v_scale + (QUANT ? bh * a.scale_len : 0);
  const int s_begin = split * a.split_len;
  const int s_end = min(s_begin + a.split_len, a.valid_len);
  const int lane_tok = wis * tpw + grp;         // this lane group's first
  Row<C, N> kr[U], vr[U];
  float ks[U], vs[U];
  load_tokens<C, N, U, QUANT>(kr, vr, ks, vs, kb, vb, ksb, vsb, a.k_ss,
                              a.v_ss, s_begin + lane_tok, step, s_end, d0,
                              D, active, vec);

  // this thread's heads at its dims, pre-scaled
  float qv[HG][N];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const int g = slice * HG + hh;
    Row<T, N> qr;
    if (g < G && active)
      load_row(qr,
               static_cast<const T*>(a.q) +
                   (static_cast<long long>(b) * H + kvh * G + g) * D,
               d0, D, vec);
    else
      zero_row(qr);
    to_float(qr, qv[hh]);
#pragma unroll
    for (int i = 0; i < N; ++i) qv[hh][i] *= a.scale_log2;
  }
  float m[HG], l[HG], acc[HG][N];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[hh][i] = 0.0f;
  }

  // the bounds are the block's, so every lane takes part in the shuffles;
  // the next tokens' rows load while these are used
  for (int base = s_begin; base < s_end; base += U * step) {
    const int t0 = base + lane_tok;
    Row<C, N> kn[U], vn[U];
    float ksn[U], vsn[U];
    load_tokens<C, N, U, QUANT>(kn, vn, ksn, vsn, kb, vb, ksb, vsb, a.k_ss,
                                a.v_ss, t0 + U * step, step, s_end, d0, D,
                                active, vec);
    float s[U][HG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[N];
      to_float(kr[u], kx);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < N; ++i) part = fmaf(qv[hh][i], kx[i], part);
        for (int o = lanes >> 1; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if constexpr (QUANT) part *= ks[u];
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
      for (int i = 0; i < N; ++i) acc[hh][i] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[N];
      to_float(vr[u], vx);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const float p = exp2f(s[u][hh] - m[hh]);   // 0 where masked
        l[hh] += p;
        const float pv = QUANT ? p * vs[u] : p;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[hh][i] = fmaf(pv, vx[i], acc[hh][i]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
      ks[u] = ksn[u];
      vs[u] = vsn[u];
    }
  }

  // merge the lane groups of the warp (same dims, other tokens)
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[hh], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[hh], o);
      const float mm = fmaxf(m[hh], mo);
      const float ea = exp2f(m[hh] - mm), c = exp2f(mo - mm);
      l[hh] = l[hh] * ea + lo * c;
      m[hh] = mm;
#pragma unroll
      for (int i = 0; i < N; ++i)
        acc[hh][i] = acc[hh][i] * ea +
                     __shfl_xor_sync(0xffffffffu, acc[hh][i], o) * c;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (d0 + i < D) red_o[warp][hh][d0 + i] = acc[hh][i];
      if (li == 0) {
        red_m[warp][hh] = m[hh];
        red_l[warp][hh] = l[hh];
      }
    }
  }
  __syncthreads();

  // merge the warps of each slice: this split's (o, m, l) per head
  const long long part = bh * n_splits + split;
  T* out_bh = static_cast<T*>(a.out) + (static_cast<long long>(b) * H +
                                        kvh * G) * D;
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
      // an empty shard (valid_len 0) has ll 0: output 0, lse -inf
      st(out_bh + idx, ll > 0.0f ? oo / ll : 0.0f);
      if (d == 0 && a.lse)
        a.lse[b * H + kvh * G + g] =
            ll > 0.0f ? (mm + log2f(ll)) * LN2 : -INFINITY;
    } else {
      a.o_part[part * G * D + idx] = oo;
      if (d == 0) {
        a.ml_part[(part * G + g) * 2] = mm;
        a.ml_part[(part * G + g) * 2 + 1] = ll;
      }
    }
  }
  if (n_splits == 1) return;

  // the last split of (b, kv head) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(a.counters + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // weights w[sp][g] = exp2(m - M) / L of each split and head
  float* w = &red_o[0][0][0];
  const float* ml_bh = a.ml_part + bh * n_splits * G * 2;
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
    if (a.lse) a.lse[b * H + kvh * G + tid] = (mm + log2f(ll)) * LN2;
  }
  __syncthreads();
  const float* o_bh = a.o_part + bh * n_splits * G * D;
  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D;
    float oo = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < n_splits; ++sp)
      oo += w[sp * G + g] * __ldcg(o_bh + static_cast<long long>(sp) * G * D +
                                   idx);
    st(out_bh + idx, oo);
  }
  if (tid == 0) a.counters[bh] = 0;
}

template <typename T, typename C, int HG>
int launch(const Args& a, int B, cudaStream_t stream) {
  decode_kernel<T, C, HG><<<dim3(a.n_splits, a.KVH, B), NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C>
int dispatch(int hg, const Args& a, int B, cudaStream_t s) {
  switch (hg) {
    case 1: return launch<T, C, 1>(a, B, s);
    case 2: return launch<T, C, 2>(a, B, s);
    case 4: return launch<T, C, 4>(a, B, s);
    case 8: return launch<T, C, 8>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename C, int HG>
int occupancy(int* n) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, decode_kernel<T, C, HG>, NT, 0));
}

template <typename T, typename C>
int blocks_per_sm(int hg) {
  int n = 0, err = static_cast<int>(cudaErrorInvalidValue);
  if (hg == 1) err = occupancy<T, C, 1>(&n);
  if (hg == 2) err = occupancy<T, C, 2>(&n);
  if (hg == 4) err = occupancy<T, C, 4>(&n);
  if (hg == 8) err = occupancy<T, C, 8>(&n);
  return err == 0 ? n : -err;
}

// f(T{}, C{}) for the (q dtype, cache dtype) codes, or an error code
template <typename F>
int with_types(int dtype, int cache_dtype, F&& f) {
  if (dtype == 1 && cache_dtype == 1) return f(__nv_bfloat16{}, __nv_bfloat16{});
  if (dtype == 0 && cache_dtype == 0) return f(float{}, float{});
  if (dtype == 0 && cache_dtype == 2) return f(float{}, int8_t{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Blocks of the (dtype, cache_dtype, hg) kernel resident on one SM at a
// time, or minus a CUDA error code.
extern "C" int decode_blocks_per_sm(int dtype, int cache_dtype, int hg) {
  int n = -static_cast<int>(cudaErrorInvalidValue);
  with_types(dtype, cache_dtype, [&](auto t, auto c) {
    n = blocks_per_sm<decltype(t), decltype(c)>(hg);
    return 0;
  });
  return n;
}

// dtype (q and out): 0 float32, 1 bfloat16; cache_dtype: dtype's code, or
// (float32 q only) 2 for int8 with float32 k_scale / v_scale of shape
// (B, KVH, scale_len), contiguous (null otherwise).  q and out are (B, H, D) contiguous; the
// caches are addressed as base + b*sb + kvh*sh + s*ss + d.  hg: query
// heads a thread holds (1, 2, 4 or 8, at least min(G, 8)); lanes: a power
// of two >= D / (dims a lane holds: 16 for int8 at hg <= 4, else 8); vec:
// 1 when every row start is 16-byte aligned and D a multiple of those
// dims.  o_part (B*KVH*n_splits*G*D) and ml_part (B*KVH*n_splits*G*2) are
// float32 scratch, counters (B*KVH) int32 zeros that the kernel leaves
// zero.  lse: null, or float32 (B, H) that takes each row's log-sum-exp of
// the scaled scores (natural log; the split merge's m + log l).
// valid_len 0 (an empty shard of a sequence-sharded cache; one split)
// writes output 0 and lse -inf.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* o_part,
    void* ml_part, void* counters, const void* k_scale, const void* v_scale,
    int dtype, int cache_dtype, int B, int H, int KVH, int D, int hg,
    int lanes, int valid_len, int split_len, int n_splits, int vec,
    int scale_len, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale,
    void* stream) {
  const int G = KVH > 0 ? H / KVH : 0;
  const bool quant = cache_dtype == 2;
  const int dpl = quant && hg <= 4 ? DPL_INT8 : DPL;
  if (KVH < 1 || H % KVH != 0 || G > MAXG || D < 1 || D > MAXD ||
      (G + hg - 1) / hg > 2 || lanes < 1 || lanes > 32 ||
      n_splits < 1 || n_splits > MAX_SPLITS ||
      (lanes & (lanes - 1)) != 0 || lanes * dpl < D || valid_len < 0 ||
      (n_splits > 1 && valid_len < 1) ||
      quant != (k_scale != nullptr) || quant != (v_scale != nullptr) ||
      (quant && scale_len < valid_len))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, static_cast<float*>(lse), static_cast<float*>(o_part),
         static_cast<float*>(ml_part), static_cast<int*>(counters),
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         H, KVH, D, lanes, valid_len, split_len, n_splits, vec, scale_len,
         k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale * LOG2E};
  auto* s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, cache_dtype, [&](auto t, auto c) {
    return dispatch<decltype(t), decltype(c)>(hg, a, B, s);
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
