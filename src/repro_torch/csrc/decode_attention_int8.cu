// One-token GQA decode attention over the int8 KV cache (the model's
// `kv_quant`), bf16 q, hand-written for Hopper (sm_90a), with the new
// token's quantize-and-append in the same launch.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py:_decode_kernel (pl.pallas_call at
// decode_attention.py:106) for the cache that the reference quantizes and
// then attends over in einsum (repro/models/attention.py:123-166): int8
// K/V of shape (B, KVH, S, D) with float32 per-(token, head) scales
// (B, KVH, S).  score = (q . k_int8) * D**-0.5 * k_scale[t], masked past
// valid_len; softmax over the valid tokens; p * v_scale[t] weighs the int8
// V row; l sums the unscaled p; the output is in q's dtype (bf16).
//
// What bounds it: bytes.  A step reads each valid token's K and V rows
// once (2 * D bytes and two scales a token and kv head), half the bf16
// cache's bytes, for 4 G flops a byte.  Widening int8 to float and one
// FMA a head on the CUDA cores costs about as many instructions as the
// bytes allow time for, so the design keeps both off the CUDA cores:
//   * Bytes in flight without registers.  One block per (split, kv head,
//     batch): a producer warp keeps a ring of STAGES shared-memory stages
//     full, each TILE tokens of K, V and their two scales, tracked by
//     mbarriers.  In the head-major cache a tile of one (b, kv head) is
//     one contiguous TILE * D-byte run and its scales a 4 * TILE-byte run,
//     so a stage is four cp.async.bulk copies; a ragged last tile copies
//     only its rows.  A D or cache length that breaks 16-byte alignment
//     takes 4-byte cp.async copies that arrive on the same barrier.  The
//     wrapper sizes the ring so that min_blocks blocks fit an SM (three at
//     D 64 and 128, one at D 256), 100 to 150 KB of loads in flight an SM.
//   * Each element widened once, the products on the tensor cores
//     (mma.sync m16n8k16, bf16 operands, float32 accumulators).  Four
//     consumer warps take 16 tokens of each tile apiece and keep their own
//     online softmax, so they never wait on each other.  S = Q K^T has the
//     G <= 16 query heads on the 16 rows: a lane reads 16 bytes of a key
//     row (one 64-dim group of 4 lanes) and widens it in registers into
//     the B fragments, with the dims of each k-step permuted so that four
//     bytes of a lane are one fragment (Q's fragments carry the same
//     permutation, built once per block); lanes of odd tokens read the
//     other 64-dim group first, so no two rows of a load share banks.
//     int8 is exact in bf16, so the products are the reference's up to
//     the order of the float32 sums.  k_scale multiplies S's columns after
//     the product.  O += P V reuses S's accumulators as P's A fragments
//     (as the flash kernel does); v_scale multiplies P's columns, l sums P
//     before that, and P goes in as a bf16 high part and the bf16 rest
//     (two products), so P V keeps about 16 bits of P, near the
//     reference's float32 product.  V is widened once into a padded bf16
//     tile of the warp and read by ldmatrix.trans.
//     Widening is a byte permute that builds 2**23 + 128 + x as a float,
//     one subtraction and a permute that packs two upper halves: exact.
//   * The append: with slot >= 0, the block whose split holds `slot`
//     quantizes the new token's k and v (bf16 (B, KVH, D), after RoPE) in
//     the reference's order (the row max of |x| in bf16, the floor in
//     bf16, then float32 / 127; rint(x / scale) with IEEE division (a
//     double quotient rounded once: no slow-path call), clamped to
//     +-127), writes payload and scales at `slot`, and patches
//     its staged copy of that row, so it attends over what it wrote.
// The wrapper sizes the splits so that the grid is at most one wave of
// resident blocks.  The warps' states merge in shared memory; with more
// than one split the last block of a (batch, kv head) to arrive merges
// the splits' partials, as the float kernel does (decode_attention.cu),
// on the same per-stream arrival counters.  One launch either way.  The
// merge's (m, l) of each row also give its log-sum-exp (an optional
// output, for a sequence-sharded cache whose shards merge across ranks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NCW = 4;                  // consumer warps
constexpr int NT = (NCW + 1) * 32;      // and one producer warp
constexpr int WT = 16;                  // tokens a consumer warp takes
constexpr int TILE = NCW * WT;          // tokens a stage holds
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 4;
constexpr int MAXG = 16;                // query heads per KV head
constexpr int MAXD = 256;               // head_dim
constexpr int MAX_SPLITS = 256;
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Byte offsets of one block's dynamic shared memory.  The ring of stages
// (K tile, V tile, k scales, v scales; rows `pd` bytes apart) doubles as
// the scratch of the warps' merge and of the split merge's weights.
struct Layout {
  int pd, stage, ring, vpitch, vbuf, qfrag, newrow, bars, flag, total;
};

__host__ __device__ inline int groups(int D) { return (D + 63) / 64; }

__host__ __device__ inline Layout layout(int D, int G, int stages) {
  Layout L;
  L.pd = (D + 15) / 16 * 16;
  L.stage = 2 * TILE * L.pd + 2 * TILE * 4;
  const int merge = NCW * G * L.pd * 4 + 2 * NCW * G * 4;
  const int weights = MAX_SPLITS * G * 4;
  L.ring = stages * L.stage;
  if (L.ring < merge) L.ring = merge;
  if (L.ring < weights) L.ring = weights;
  L.vpitch = 2 * L.pd + 16;     // 16 bytes of padding: ldmatrix rows
  L.vbuf = L.ring;              // spread over the banks
  L.qfrag = L.vbuf + NCW * WT * L.vpitch;
  L.newrow = L.qfrag + groups(D) * 4 * 32 * 16;
  L.bars = L.newrow + 2 * L.pd + 16;
  L.flag = L.bars + 2 * stages * 8;
  L.total = L.flag + 16;
  return L;
}

struct Args {
  const __nv_bfloat16* q;
  int8_t* k;
  int8_t* v;
  float* k_scale;
  float* v_scale;
  __nv_bfloat16* out;
  float* lse;                   // (B, H) row log-sum-exp, or null
  float* o_part;
  float* ml_part;
  int* counters;
  const __nv_bfloat16* k_new;   // the appended token (slot >= 0)
  const __nv_bfloat16* v_new;
  int H, KVH, D, S, valid_len, split_len, n_splits, stages, bulk, slot;
  float floor_, scale_log2;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(saddr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}
// A wait that spins for seconds traps: a lost copy or arrival fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    if (spins == (1 << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(saddr(bar)), "r"(parity) : "memory");
  }
}
// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(saddr(dst)),
               "l"(src) : "memory");
}
// arrives on `bar` once this thread's cp.async copies have landed
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   saddr(bar)) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NCW * 32) : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p))
      : "memory");
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d float32
__device__ __forceinline__ void mma(float (&d)[4], const uint4& a,
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// (a, b) as a bf16 pair (hi) and the bf16 pair of what it leaves out (lo):
// hi + lo carries about 16 bits of each
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(a - f.x, b - f.y);
}
// a / b rounded to float as IEEE division rounds it, without the slow-path
// call of div.rn.f32: the quotient to within a double ulp (a reciprocal
// refined by Newton steps, one remainder correction), then rounded to
// float.  A quotient of two floats lies at least 2**-49 (relative) from
// every midpoint of floats, so the double's error cannot change that
// rounding.  Finite b with 1e-30 < |b| < 1e30, as the quantizer's scales.
__device__ __forceinline__ float div_rn(float a, float b) {
  const double ad = a, bd = b;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(bd));
  y = fma(fma(-bd, y, 1.0), y, y);
  y = fma(fma(-bd, y, 1.0), y, y);
  const double q = ad * y;
  return __double2float_rn(fma(fma(-bd, q, ad), y, q));
}
// four int8 (one word) -> two bf16 pairs, exactly: 2**23 + (x + 128) as a
// float by a byte permute, minus 2**23 + 128, then the upper halves
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  w ^= 0x80808080u;
  const float magic = 8388736.0f;
  const uint32_t f0 = __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) - magic);
  const uint32_t f1 = __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) - magic);
  const uint32_t f2 = __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7442)) - magic);
  const uint32_t f3 = __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7443)) - magic);
  return make_uint2(__byte_perm(f0, f1, 0x7632), __byte_perm(f2, f3, 0x7632));
}
__device__ __forceinline__ uint32_t word(const uint4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}
// q[row][d], q[row][d + 1] as a bf16 pair; zero past G rows or D dims
// (D % 4 == 0, d even)
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* q, int row,
                                           int d, int G, int D) {
  if (row >= G || d >= D) return 0u;
  return *reinterpret_cast<const uint32_t*>(q + row * D + d);
}

// The appended token's k or v row of one (batch, kv head), quantized as
// attention.quantize_kv does, into the cache at its slot and into `row`
// and `scale` in shared memory (one warp).
__device__ __forceinline__ void quantize_row(const __nv_bfloat16* x, int8_t* cache_row,
                             float* cache_scale, int8_t* row, float* scale,
                             int D, float floor_, int lane) {
  float mx = 0.0f;
  for (int d = lane; d < D; d += 32)
    mx = fmaxf(mx, fabsf(__bfloat162float(x[d])));
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float s = div_rn(fmaxf(mx, floor_), 127.0f);
  for (int d = lane; d < D; d += 32) {
    const float r = rintf(div_rn(__bfloat162float(x[d]), s));
    const int8_t p = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    cache_row[d] = p;
    row[d] = p;
  }
  if (lane == 0) {
    *cache_scale = s;
    *scale = s;
  }
}

// blocks an SM the registers of the head_dim class DC are bounded for
// (the wrapper sizes the ring for as many): three at D 64 and 128, whose
// layout is known at compile time; two for the other D up to 128, whose
// index arithmetic three would spill; one above, for D 256's 128
// accumulators a lane
__host__ __device__ constexpr int min_blocks(int DC, bool exact) {
  return DC > 128 ? 1 : exact ? 3 : 2;
}

// DC: the head_dim class (64, 128 or 256) that sizes the fragments;
// EXACT: D == DC, so that the row layout is known at compile time (every
// configuration's head_dim), else any D of the class
template <int DC, bool EXACT>
__global__ void __launch_bounds__(NT, min_blocks(DC, EXACT))
    decode_int8_kernel(const Args a) {
  constexpr int NGR = DC / 64;          // 64-dim groups, at most
  constexpr int NJ = DC / 8;            // n-tiles of O, at most
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = a.H / a.KVH, D = EXACT ? DC : a.D, NS = a.stages;
  const Layout L = layout(D, G, NS);
  const int pd = L.pd, ngr = groups(D), nch = pd / 16;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.KVH + kvh;
  const int s_begin = split * a.split_len;
  const int s_end = min(s_begin + a.split_len, a.valid_len);
  const int n_tiles = (s_end - s_begin + TILE - 1) / TILE;
  const bool has_slot = a.slot >= s_begin && a.slot < s_end;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + NS;
  int8_t* new_k = reinterpret_cast<int8_t*>(smem + L.newrow);
  int8_t* new_v = new_k + pd;
  float* new_s = reinterpret_cast<float*>(new_v + pd);   // k, v scales
  const long long row0 = bh * a.S;      // (b, kv head)'s first cache row

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], a.bulk ? 1 : 32);
      mbar_init(&empty[s], NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warps' (o, m, l) per head, written into the ring's scratch once
  // every consumer is done with the ring
  float* red_o = reinterpret_cast<float*>(smem);       // [NCW][G][pd]
  float* red_m = red_o + NCW * G * pd;                 // [NCW][G]
  float* red_l = red_m + NCW * G;
  if (warp == NCW) {
    // producer: keeps the ring full
    const int8_t* kg = a.k + row0 * D;
    const int8_t* vg = a.v + row0 * D;
    const float* ksg = a.k_scale + row0;
    const float* vsg = a.v_scale + row0;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS;
      mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
      const int t0 = s_begin + i * TILE, n = min(TILE, s_end - t0);
      unsigned char* st = smem + s * L.stage;
      unsigned char* ks = st + 2 * TILE * pd;
      if (a.bulk) {                     // D % 16 == 0, S % 4 == 0
        if (lane == 0) {
          const int nb = n * D, nsb = (n + 3) / 4 * 16;
          mbar_expect_tx(&full[s], 2 * nb + 2 * nsb);
          bulk_copy(st, kg + static_cast<long long>(t0) * D, nb, &full[s]);
          bulk_copy(st + TILE * pd, vg + static_cast<long long>(t0) * D, nb,
                    &full[s]);
          bulk_copy(ks, ksg + t0, nsb, &full[s]);
          bulk_copy(ks + 4 * TILE, vsg + t0, nsb, &full[s]);
        }
      } else {                          // D % 4 == 0
        const int wpr = D / 4;
        for (int e = lane; e < n * wpr; e += 32) {
          const int row = e / wpr, c = e - row * wpr;
          const long long g = static_cast<long long>(t0 + row) * D + 4 * c;
          copy4(st + row * pd + 4 * c, kg + g);
          copy4(st + TILE * pd + row * pd + 4 * c, vg + g);
        }
        for (int row = lane; row < n; row += 32) {
          copy4(ks + 4 * row, ksg + t0 + row);
          copy4(ks + 4 * TILE + 4 * row, vsg + t0 + row);
        }
        copies_arrive(&full[s]);
      }
    }
  } else {
    const int r = lane >> 2, t4 = lane & 3;
    // Q's A fragments, dims permuted as the key rows are read: k-step
    // (group, c) takes dims 64 group + 16 t + 4 c + {0, 1} into a0a1 (row
    // r) and a2a3 (row r + 8), + {2, 3} into a4a5 and a6a7
    uint4* qf = reinterpret_cast<uint4*>(smem + L.qfrag);
    const __nv_bfloat16* qb =
        a.q + (static_cast<long long>(b) * a.H + kvh * G) * D;
    for (int e = tid; e < ngr * 4 * 32; e += NCW * 32) {
      const int ks = e >> 5, ln = e & 31, row = ln >> 2;
      const int d0 = 64 * (ks >> 2) + 16 * (ln & 3) + 4 * (ks & 3);
      qf[e] = make_uint4(q_pair(qb, row, d0, G, D),
                         q_pair(qb, row + 8, d0, G, D),
                         q_pair(qb, row, d0 + 2, G, D),
                         q_pair(qb, row + 8, d0 + 2, G, D));
    }
    if (has_slot && warp == 0) {
      const long long at = row0 + a.slot;
      quantize_row(a.k_new + bh * D, a.k + at * D, a.k_scale + at, new_k,
                   new_s, D, a.floor_, lane);
      quantize_row(a.v_new + bh * D, a.v + at * D, a.v_scale + at, new_v,
                   new_s + 1, D, a.floor_, lane);
    }
    consumers_sync();

    float o[NJ][4];
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    // 64-dim groups read in swapped order by lanes of odd tokens
    const int odd = pd % 128 == 0 ? r & 1 : 0;
    unsigned char* vt = smem + L.vbuf + warp * WT * L.vpitch;
    // a lane's 8-byte chunk of the V rows it widens: rows vr0, vr0 + vrs..
    const int cpr = pd / 8, vrs = 32 / cpr;
    const int vr0 = lane / cpr, vc = lane - vr0 * cpr;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS;
      mbar_wait(&full[s], (i / NS) & 1);
      const int tw = s_begin + i * TILE + warp * WT;   // the warp's first
      unsigned char* st = smem + s * L.stage;
      if (tw < s_end) {
        int8_t* kt = reinterpret_cast<int8_t*>(st) + warp * WT * pd;
        int8_t* vr = kt + TILE * pd;
        float* kss = reinterpret_cast<float*>(st + 2 * TILE * pd) + warp * WT;
        float* vss = kss + TILE;
        if (has_slot && a.slot >= tw && a.slot < tw + WT) {
          // the appended token: this block's own quantized row
          const int row = a.slot - tw;
          for (int d = lane; d < D; d += 32) {
            kt[row * pd + d] = new_k[d];
            vr[row * pd + d] = new_v[d];
          }
          if (lane == 0) {
            kss[row] = new_s[0];
            vss[row] = new_s[1];
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
        }
        // the warp's 16 V rows widened to bf16, 8 bytes a lane at a time
        if (vr0 < vrs) {
          for (int row = vr0; row < WT; row += vrs) {
            const uint2 w =
                *reinterpret_cast<const uint2*>(vr + row * pd + 8 * vc);
            const uint2 lo = widen4(w.x), hi = widen4(w.y);
            *reinterpret_cast<uint4*>(vt + row * L.vpitch + 16 * vc) =
                make_uint4(lo.x, lo.y, hi.x, hi.y);
          }
        }
        // S = Q K^T for the warp's two 8-token n-tiles
        float sc[2][4] = {};
#pragma unroll
        for (int g2 = 0; g2 < (NGR + 1) / 2; ++g2) {
          const int ga = 2 * g2, gb = ga + 1;
          if (ga >= ngr) break;
          uint4 xa[2], xb[2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int8_t* row = kt + (8 * nt + r) * pd;
            const int ca = 4 * (ga + odd) + t4, cb = 4 * (gb - odd) + t4;
            xa[nt] = ca < nch ? *reinterpret_cast<const uint4*>(row + 16 * ca)
                              : make_uint4(0, 0, 0, 0);
            xb[nt] = NGR > 1 && cb < nch
                         ? *reinterpret_cast<const uint4*>(row + 16 * cb)
                         : make_uint4(0, 0, 0, 0);
            if (odd) {
              const uint4 t = xa[nt];
              xa[nt] = xb[nt];
              xb[nt] = t;
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint4 qa = qf[(ga * 4 + c) * 32 + lane];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const uint2 kb = widen4(word(xa[nt], c));
              mma(sc[nt], qa, kb.x, kb.y);
            }
            if (NGR > 1 && gb < ngr) {
              const uint4 qb2 = qf[(gb * 4 + c) * 32 + lane];
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const uint2 kb = widen4(word(xb[nt], c));
                mma(sc[nt], qb2, kb.x, kb.y);
              }
            }
          }
        }
        // scores in log2 units: k_scale on the columns, masked past s_end
        bool valid[2][2];
        float vsc[2][2];
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 8 * nt + 2 * t4;
          const float2 ks = *reinterpret_cast<const float2*>(kss + j);
          const float2 vs = *reinterpret_cast<const float2*>(vss + j);
          vsc[nt][0] = vs.x;
          vsc[nt][1] = vs.y;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            valid[nt][e] = tw + j + e < s_end;
            const float f = (e ? ks.y : ks.x) * a.scale_log2;
            sc[nt][e] = valid[nt][e] ? sc[nt][e] * f : NEG_INF;
            sc[nt][2 + e] = valid[nt][e] ? sc[nt][2 + e] * f : NEG_INF;
            mx0 = fmaxf(mx0, sc[nt][e]);
            mx1 = fmaxf(mx1, sc[nt][2 + e]);
          }
        }
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        // rescale only when a row's max grew (rare after the first tiles)
        if (__any_sync(0xffffffffu, mn0 > m0 || mn1 > m1)) {
          const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
          l0 *= c0;
          l1 *= c1;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            o[j][0] *= c0;
            o[j][1] *= c0;
            o[j][2] *= c1;
            o[j][3] *= c1;
          }
        }
        m0 = mn0;
        m1 = mn1;
        // P (rows r, r + 8) times v_scale as the A fragments of P V, a
        // bf16 high part and the bf16 rest: P V to about 16 bits, as the
        // reference's float32 product
        uint32_t pa[4], pl[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = valid[nt][e] ? ex2(sc[nt][e] - m0) : 0.0f;
            p[2 + e] = valid[nt][e] ? ex2(sc[nt][2 + e] - m1) : 0.0f;
            l0 += p[e];
            l1 += p[2 + e];
            const float vs = valid[nt][e] ? vsc[nt][e] : 0.0f;
            p[e] *= vs;
            p[2 + e] *= vs;
          }
          split_bf16(p[0], p[1], pa[2 * nt], pl[2 * nt]);
          split_bf16(p[2], p[3], pa[2 * nt + 1], pl[2 * nt + 1]);
        }
        const uint4 phi = make_uint4(pa[0], pa[1], pa[2], pa[3]);
        const uint4 plo = make_uint4(pl[0], pl[1], pl[2], pl[3]);
        __syncwarp();                     // the V tile is widened
        const unsigned char* vrow =
            vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.vpitch +
            16 * (lane >> 4);
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          if (16 * jj >= pd) break;
          uint32_t v4[4];
          ldsm_t(v4, vrow + 32 * jj);
          mma(o[2 * jj], phi, v4[0], v4[1]);
          mma(o[2 * jj], plo, v4[0], v4[1]);
          mma(o[2 * jj + 1], phi, v4[2], v4[3]);
          mma(o[2 * jj + 1], plo, v4[2], v4[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    consumers_sync();       // every consumer is done with the ring
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = r + 8 * h;
      if (g < G) {
        float* dst = red_o + (warp * G + g) * pd + 2 * t4;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (8 * j < pd)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(o[j][2 * h], o[j][2 * h + 1]);
        if (t4 == 0) {
          red_m[warp * G + g] = h ? m1 : m0;
          red_l[warp * G + g] = h ? l1 : l0;
        }
      }
    }
  }
  __syncthreads();

  // merge the warps: this split's (o, m, l) per head
  const int n_splits = a.n_splits;
  const long long part = bh * n_splits + split;
  __nv_bfloat16* out_bh =
      a.out + (static_cast<long long>(b) * a.H + kvh * G) * D;
  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx - g * D;
    float mm = NEG_INF;
    for (int w = 0; w < NCW; ++w) mm = fmaxf(mm, red_m[w * G + g]);
    float ll = 0.0f, oo = 0.0f;
    for (int w = 0; w < NCW; ++w) {
      const float c = ex2(red_m[w * G + g] - mm);
      ll += red_l[w * G + g] * c;
      oo += red_o[(w * G + g) * pd + d] * c;
    }
    if (n_splits == 1) {
      // an empty shard (valid_len 0) has ll 0: output 0, lse -inf
      out_bh[idx] = __float2bfloat16(ll > 0.0f ? __fdividef(oo, ll) : 0.0f);
      if (d == 0 && a.lse)
        a.lse[b * a.H + kvh * G + g] =
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
  int* is_last = reinterpret_cast<int*>(smem + L.flag);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *is_last = atomicAdd(a.counters + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  // weights w[sp][g] = exp2(m - M) / L of each split and head
  float* w = reinterpret_cast<float*>(smem);
  const float* ml_bh = a.ml_part + bh * n_splits * G * 2;
  for (int i = tid; i < n_splits * G; i += NT) w[i] = __ldcg(ml_bh + 2 * i);
  __syncthreads();
  if (tid < G) {
    float mm = NEG_INF, ll = 0.0f;
    for (int sp = 0; sp < n_splits; ++sp) mm = fmaxf(mm, w[sp * G + tid]);
#pragma unroll 8
    for (int sp = 0; sp < n_splits; ++sp)
      ll += __ldcg(ml_bh + 2 * (sp * G + tid) + 1) *
            ex2(w[sp * G + tid] - mm);
    for (int sp = 0; sp < n_splits; ++sp)
      w[sp * G + tid] = __fdividef(ex2(w[sp * G + tid] - mm), ll);
    if (a.lse) a.lse[b * a.H + kvh * G + tid] = (mm + log2f(ll)) * LN2;
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
    out_bh[idx] = __float2bfloat16(oo);
  }
  if (tid == 0) a.counters[bh] = 0;
}

// f(kernel) for D (exact at 64, 128 and 256, else its class), or an
// error code
template <typename F>
int with_kernel(int D, F&& f) {
  const int pd = (D + 15) / 16 * 16;
  if (D == 64) return f(decode_int8_kernel<64, true>);
  if (D == 128) return f(decode_int8_kernel<128, true>);
  if (D == 256) return f(decode_int8_kernel<256, true>);
  if (pd <= 64) return f(decode_int8_kernel<64, false>);
  if (pd <= 128) return f(decode_int8_kernel<128, false>);
  if (pd <= MAXD) return f(decode_int8_kernel<256, false>);
  return static_cast<int>(cudaErrorInvalidValue);
}

int allow_smem(void (*kernel)(Args), int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace


// Blocks of the kernel for head_dim D resident on one SM at a time with
// `smem` bytes of dynamic shared memory each, or minus a CUDA error code.
extern "C" int decode_int8_blocks_per_sm(int D, int smem) {
  int n = 0;
  const int err = with_kernel(D, [&](auto kernel) {
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem));
  });
  return err == 0 ? n : -err;
}

// q and out: (B, H, D) bf16, contiguous; k, v: (B, KVH, S, D) int8 and
// k_scale, v_scale: (B, KVH, S) float32, contiguous.  bulk: 1 when D % 16
// == 0, S % 4 == 0 and every cache and scale base is 16-byte aligned
// (cp.async.bulk stages), else 0 (4-byte copies: D % 4 == 0 and 4-byte
// aligned bases).  slot: -1, or the cache row in [0, valid_len) where the
// block that holds it writes the quantized k_new / v_new ((B, KVH, D)
// bf16, contiguous) and their scales (floor: the quantizer's 1e-8 in
// bf16, as a float).  split_len: a multiple of TILE; o_part
// (B*KVH*n_splits*G*D) and ml_part (B*KVH*n_splits*G*2) float32 scratch,
// counters (B*KVH) int32 zeros that the kernel leaves zero.  lse: null,
// or float32 (B, H) that takes each row's log-sum-exp of the scaled
// scores (natural log).  valid_len 0 (an empty shard of a
// sequence-sharded cache; one split, no slot) writes output 0 and lse
// -inf.
extern "C" int decode_attention_int8(
    const void* q, void* k, void* v, void* k_scale, void* v_scale, void* out,
    void* lse, void* o_part, void* ml_part, void* counters, const void* k_new,
    const void* v_new, int B, int H, int KVH, int D, int S, int valid_len,
    int split_len, int n_splits, int stages, int bulk, int slot,
    float floor_, float scale, void* stream) {
  const int G = KVH > 0 ? H / KVH : 0;
  if (B < 1 || KVH < 1 || H % KVH != 0 || G > MAXG || D < 4 || D > MAXD ||
      D % 4 != 0 || valid_len < 0 || valid_len > S ||
      (n_splits > 1 && valid_len < 1) ||
      stages < MIN_STAGES || stages > MAX_STAGES || n_splits < 1 ||
      n_splits > MAX_SPLITS || split_len % TILE != 0 ||
      static_cast<long long>(split_len) * n_splits < valid_len ||
      (bulk && (D % 16 != 0 || S % 4 != 0)) ||
      (slot >= 0 && (slot >= valid_len || !k_new || !v_new)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = layout(D, G, stages).total;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<int8_t*>(k),
         static_cast<int8_t*>(v), static_cast<float*>(k_scale),
         static_cast<float*>(v_scale), static_cast<__nv_bfloat16*>(out),
         static_cast<float*>(lse), static_cast<float*>(o_part), static_cast<float*>(ml_part),
         static_cast<int*>(counters),
         static_cast<const __nv_bfloat16*>(k_new),
         static_cast<const __nv_bfloat16*>(v_new), H, KVH, D, S, valid_len,
         split_len, n_splits, stages, bulk, slot, floor_, scale * LOG2E};
  auto* s = static_cast<cudaStream_t>(stream);
  return with_kernel(D, [&](auto kernel) {
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<dim3(n_splits, KVH, B), NT, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
