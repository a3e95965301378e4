// Mamba2 SSD chunked scan (train / prefill), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:_ssd_kernel
// (pl.pallas_call at ssd_scan.py:89).  x (B, nC, Q, nh, hp), B and C
// (B, nC, Q, ns) shared by the heads (ngroups 1), dt (B, nC, Q, nh)
// float32, one negative decay rate A per head, h0 = 0.  For each (batch,
// head) the chunks run in order, carrying the state h (ns x hp, float32):
//
//   La = cumsum(dt * A)                                 (within the chunk)
//   y  = (C B^T o causal exp(La_i - La_j) o dt_j) x  +  (C o exp(La)) h
//   h <- h exp(La_last) + (B o exp(La_last - La) dt)^T x
//
// y is written in float32 (the mixer's form) or in x's type (the op's
// form); the final state in float32, (B, nh, ns, hp).  At the prefill
// shape (Q 256, ns 128, hp 64) the least work is about 17.5 GFLOP
// against about 106 MB, so on the tensor cores the bytes bound it.
//
// bfloat16 inputs: ssd_scan_bf16, four launches that are parallel over
// chunks (the SSD algorithm of arXiv:2405.21060, section 6); every
// product on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// accumulators: at these sizes the products take microseconds even well
// below wgmma's rate, and the register fragments let the kernel scale and
// round an operand between its load and the product).  Tiles are 64 rows,
// staged by cp.async (16 bytes a thread; x, B, C and C B^T tiles in a
// two-stage ring where a loop walks key tiles) into shared-memory rows
// padded by 16 bytes, so that ldmatrix reads them without bank conflicts.
//   1. ssd_cb_kernel, one block per (64 x 64 tile at or below the
//      diagonal, chunk): C B^T once per chunk for every head, into a
//      (B, nC, Qt, Qt) float32 scratch (Qt = Q rounded up to 64); rows
//      and columns past Q are 0.  Bytes bound it (C and B once, 4 MB out
//      at the prefill shape, which stays in L2 for pass 4).
//   2. ssd_state_kernel, one block per (chunk, head), ns / 16 warps of
//      16 state rows each: La by a warp scan, written to a
//      (B, nC, nh, Qt) float32 buffer, and the chunk state
//      S_c = (B o u)^T x, u_j = exp(La_last - La_j) dt_j, written in
//      float32 to (B, nC, nh, ns, hp).  B o u is formed in the A
//      fragments and split into a bf16 high and low part (two products):
//      one bf16 rounding there moved h_final past its 5e-3 tolerance
//      under large decay.  Bound by the products and L2 reads of x and B
//      (B is shared by the heads).
//   3. ssd_pass_kernel, one thread per 4 state elements: the only serial
//      part, elementwise in float32 over the chunks,
//      h_in[c] = h; h = h exp(La_last[c]) + S_c; it writes h_in rounded
//      to bf16 (the operand of pass 4's C h product) to its own
//      (B, nC, nh, ns, hp) buffer, and h_final.  Bound by bytes.
//   4. ssd_out_kernel, one block per (64 query rows, head, chunk):
//      exp(La_i) C h_in[c] on the tensor cores, then per key tile at or
//      below the diagonal W = C B^T o exp(La_i - La_j) o dt_j, masked
//      (j <= i) BEFORE the exp, as the float32 kernel does, since above
//      the diagonal La_i - La_j > 0 may overflow and inf * 0 is NaN;
//      W is built in registers straight in the A-fragment layout (exp2f
//      of (La_i - La_j) log2 e) and split into a bf16 high and low part,
//      and y += W x (two products): rounded once, W took the large-decay
//      case to 0.89 of y's 5e-2 tolerance on the card.  Once the
//      C h product has read C and h_in, the ring's second stage takes
//      their place, which keeps 3 blocks on an SM.  Bound by L2 reads of
//      the C B^T and x tiles (C B^T is read once per head).
// Shared memory per block at the prefill shape: pass 1 34,816 bytes,
// pass 2 56,320, pass 4 65,536; pass 3 none.

// float32 inputs: ssd_scan_fwd, the first kernel, kept as it was.  Every
// product on the CUDA cores in float32 from shared memory, so
// shared-memory loads bound it, far above the byte bound.  Design:
//   * the Pallas grid's sequential chunk axis becomes a loop inside the
//     block; the state h stays in shared memory across chunks;
//   * one block of 256 threads per (32 columns of hp, head, batch): the
//     columns of y and h are independent, so splitting hp fills the SMs
//     at batch 1 (128 blocks at nh 64, hp 64); each block recomputes
//     C B^T and the decays for its columns;
//   * the Q x Q term is tiled by 64 query rows x 64 key rows: per tile
//     pair the C and B tiles are staged transposed in shared memory
//     ([ns][64+1], padded against bank conflicts), each thread forms a
//     4 x 4 patch of C B^T, masks it (j <= i) BEFORE the exp, so that
//     above the diagonal, where La_i - La_j > 0 may overflow, no inf is
//     formed, and writes the weights W to shared memory; then
//     y += W x with thread (r, p) owning 8 query rows of column p;
//   * the last query tile of a chunk visits every key tile, so the state
//     update rides on its loop: the owner of h[n][p] scales it by
//     exp(La_last) and adds B^T (u o x) for the tile, u_j =
//     exp(La_last - La_j) dt_j;
//   * the chunk's cumulative sum La is one warp's shuffle scan.
// All arithmetic is float32.  Shared memory is
// 4 (ns (2 * 65 + 32) + 64 * 32 + 64 * 65 + 3 Q') bytes, Q' = Q rounded
// up to 64: 110,848 at Q 256, ns 128, opted in above 48 KB with
// cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;          // query rows per tile
constexpr int TK = 64;          // key rows per tile
constexpr int P = 32;           // columns of hp per block
constexpr int NT = 256;         // threads
constexpr int NS_MAX = 256;     // largest state size
constexpr int CS = TQ + 1;      // stride of the transposed C tile
constexpr int KS = TK + 1;      // stride of the transposed B tile
constexpr int WS = TK + 1;      // stride of the weight tile
constexpr int RPT = TQ / (NT / P);   // y rows per thread (8)
constexpr int NPT = NS_MAX / (NT / P);  // state rows per thread, at most
constexpr unsigned FULL = 0xffffffffu;

size_t smem_bytes(int Q, int ns) {
  const int qp = (Q + TK - 1) / TK * TK;
  return sizeof(float) * (static_cast<size_t>(ns) * (CS + KS + P) +
                          TK * P + TQ * WS + 3 * qp);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

template <typename T, typename TO>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ A, TO* __restrict__ y,
    float* __restrict__ hfin, int nC, int Q, int nh, int hp, int ns) {
  const int n_tiles = (Q + TK - 1) / TK;
  const int qp = n_tiles * TK;
  extern __shared__ float smem[];
  float* c_t = smem;                // [ns][CS]  C tile, transposed
  float* b_t = c_t + ns * CS;       // [ns][KS]  B tile, transposed
  float* x_s = b_t + ns * KS;       // [TK][P]   x tile
  float* w_s = x_s + TK * P;        // [TQ][WS]  weights of the tile pair
  float* h_s = w_s + TQ * WS;       // [ns][P]   carried state
  float* la = h_s + ns * P;         // [qp]      cumsum(dt * A)
  float* dts = la + qp;             // [qp]      dt
  float* u = dts + qp;              // [qp]      exp(La_last - La) * dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * P, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h];
  const int ty = tid >> 4, tx = tid & 15;   // C B^T patch: rows ty + 16 r
  const int rg = warp, pc = lane;           // y rows rg * RPT + r, state
                                            // rows rg + 8 k; column pc

  for (int e = tid; e < ns * P; e += NT) h_s[e] = 0.0f;

  for (int c = 0; c < nC; ++c) {
    const long long pos0 = (static_cast<long long>(b) * nC + c) * Q;
    __syncthreads();                // the last chunk is done with dts, u
    for (int i = tid; i < qp; i += NT)
      dts[i] = i < Q ? dt[(pos0 + i) * nh + h] : 0.0f;
    __syncthreads();
    if (warp == 0) {                // inclusive scan of dt * A
      float carry = 0.0f;
      for (int base = 0; base < qp; base += 32) {
        const int i = base + lane;
        float v = i < Q ? dts[i] * a : 0.0f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(FULL, v, o);
          if (lane >= o) v += t;
        }
        v += carry;
        la[i] = i < Q ? v : 0.0f;
        carry = __shfl_sync(FULL, v, 31);
      }
    }
    __syncthreads();
    const float la_last = la[Q - 1];
    for (int i = tid; i < qp; i += NT)
      u[i] = i < Q ? expf(la_last - la[i]) * dts[i] : 0.0f;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int i0 = qt * TQ;
      const bool last = qt == n_tiles - 1;
      __syncthreads();              // c_t is free; u is written
      for (int e = tid; e < TQ * ns; e += NT) {
        const int r = e / ns, n = e - r * ns;
        const int row = i0 + r;
        c_t[n * CS + r] = row < Q ? ld(cm + (pos0 + row) * ns + n) : 0.0f;
      }
      __syncthreads();
      // the carried state's term, exp(La_i) * C_i . h[:, p]
      float acc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;
      for (int n = 0; n < ns; ++n) {
        const float hv = h_s[n * P + pc];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          acc[r] += c_t[n * CS + rg * RPT + r] * hv;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = i0 + rg * RPT + r;
        acc[r] *= row < Q ? expf(la[row]) : 0.0f;
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * TK;
        __syncthreads();            // b_t, x_s, w_s are free; every read
                                    // of h_s for the state's term is done
        for (int e = tid; e < TK * ns; e += NT) {
          const int r = e / ns, n = e - r * ns;
          const int row = j0 + r;
          b_t[n * KS + r] = row < Q ? ld(bm + (pos0 + row) * ns + n) : 0.0f;
        }
        for (int e = tid; e < TK * P; e += NT) {
          const int r = e / P, p = e - r * P;
          const int row = j0 + r;
          x_s[e] = row < Q
                       ? ld(x + ((pos0 + row) * nh + h) * hp + p0 + p)
                       : 0.0f;
        }
        __syncthreads();
        // W = C B^T o causal exp(La_i - La_j) o dt_j, masked before exp
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[r][k] = 0.0f;
        for (int n = 0; n < ns; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = c_t[n * CS + ty + 16 * r];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = b_t[n * KS + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) s[r][k] += cv[r] * bv[k];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + tx + 16 * k;
            float wv = 0.0f;
            if (j <= i && i < Q) wv = s[r][k] * expf(la[i] - la[j]) * dts[j];
            w_s[(ty + 16 * r) * WS + tx + 16 * k] = wv;
          }
        }
        __syncthreads();
        // y += W x
        for (int j = 0; j < TK; ++j) {
          const float xv = x_s[j * P + pc];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            acc[r] += w_s[(rg * RPT + r) * WS + j] * xv;
        }
        if (last) {
          // h[n][p] <- h[n][p] exp(La_last) + sum_j B[j][n] u_j x[j][p]
          float hacc[NPT];
#pragma unroll
          for (int k = 0; k < NPT; ++k) hacc[k] = 0.0f;
          for (int j = 0; j < TK; ++j) {
            const float xu = x_s[j * P + pc] * u[j0 + j];
#pragma unroll
            for (int k = 0; k < NPT; ++k)
              if (rg + 8 * k < ns) hacc[k] += b_t[(rg + 8 * k) * KS + j] * xu;
          }
          const float dec = kt == 0 ? expf(la_last) : 1.0f;
#pragma unroll
          for (int k = 0; k < NPT; ++k) {
            const int n = rg + 8 * k;
            if (n < ns) h_s[n * P + pc] = h_s[n * P + pc] * dec + hacc[k];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = i0 + rg * RPT + r;
        if (row < Q) st(y + ((pos0 + row) * nh + h) * hp + p0 + pc, acc[r]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < ns * P; e += NT) {
    const int n = e / P, p = e - n * P;
    hfin[((static_cast<long long>(b) * nh + h) * ns + n) * hp + p0 + p] =
        h_s[e];
  }
}

template <typename T, typename TO>
int launch(const void* x, const void* bm, const void* cm, const float* dt,
           const float* A, void* y, float* hfin, int B, int nC, int Q,
           int nh, int hp, int ns, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, ns);
  auto kern = ssd_scan_kernel<T, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hp / P, nh, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), dt, A, static_cast<TO*>(y), hfin, nC, Q,
      nh, hp, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// bfloat16: four passes, parallel over chunks, products on the tensor cores
// ---------------------------------------------------------------------------
namespace {

using bf16 = __nv_bfloat16;

constexpr int MT = 64;          // rows of every tile: queries, keys, states
constexpr int MPAD = 8;         // bf16 of padding per shared-memory row
constexpr int CBS = MT + 8;     // stride (floats) of a staged C B^T tile
constexpr int MW = 4;           // warps of passes 1, 2 and 4, 16 rows each
constexpr int MNT = MW * 32;    // their threads
constexpr int ST_NT = 256;      // threads of pass 3
constexpr int HP_MAX = 128;     // largest head_dim

constexpr float LOG2E = 1.4426950408889634f;

size_t cb_smem(int ns) { return sizeof(bf16) * 2 * MT * (ns + MPAD); }
size_t state_smem(int Qt, int ns, int hp) {
  return sizeof(bf16) * 2 * MT * ((ns + MPAD) + (hp + MPAD)) +
         sizeof(float) * 3 * Qt;
}
// pass 4: a ring stage (x tile, C B^T tile); C and h_in, which stage 1
// replaces once the first product has read them
__host__ __device__ constexpr int out_stage_bytes(int hp) {
  return 2 * MT * (hp + MPAD) + 4 * MT * CBS;
}
__host__ __device__ constexpr int out_region_bytes(int ns, int hp) {
  return 2 * (MT * (ns + MPAD) + ns * (hp + MPAD)) > out_stage_bytes(hp)
             ? 2 * (MT * (ns + MPAD) + ns * (hp + MPAD))
             : out_stage_bytes(hp);
}
size_t out_smem(int Qt, int ns, int hp) {
  return out_region_bytes(ns, hp) + out_stage_bytes(hp) +
         sizeof(float) * 2 * Qt;
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero fill where !valid (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d float32
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// (a, b) as a bf16 pair high part and the bf16 pair of what it leaves out
__device__ __forceinline__ void split(float a, float b, unsigned& hi,
                                      unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack(a - hf.x, b - hf.y);
}
// a bf16 pair times (s.x, s.y), split into a high and a low part
__device__ __forceinline__ void scale_split(unsigned v, float2 s,
                                            unsigned& hi, unsigned& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split(f.x * s.x, f.y * s.y, hi, lo);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Pass 1: C B^T of one 64 x 64 tile (ti >= tj) of one chunk.
// grid (qn (qn + 1) / 2, B nC), MNT threads.
__global__ void __launch_bounds__(MNT) ssd_cb_kernel(
    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
    float* __restrict__ cb, int Q, int ns, int qn) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int ls = ns + MPAD;
  bf16* c_s = reinterpret_cast<bf16*>(mma_smem);   // [MT][ls] C rows i
  bf16* b_s = c_s + MT * ls;                        // [MT][ls] B rows j
  int ti = 0;
  const int e0 = blockIdx.x;
  while ((ti + 1) * (ti + 2) / 2 <= e0) ++ti;
  const int tj = e0 - ti * (ti + 1) / 2;
  const long long chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pieces = ns / 8;
  for (int e = tid; e < MT * pieces; e += MNT) {
    const int r = e / pieces, k = (e - r * pieces) * 8;
    const int i = ti * MT + r, j = tj * MT + r;
    cp16(c_s + r * ls + k, cm + (chunk * Q + min(i, Q - 1)) * ns + k, i < Q);
    cp16(b_s + r * ls + k, bm + (chunk * Q + min(j, Q - 1)) * ns + k, j < Q);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  float acc[MT / 8][4];
#pragma unroll
  for (int n = 0; n < MT / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.0f;
  for (int k0 = 0; k0 < ns; k0 += 16) {
    unsigned a[4];
    ldsm(a, c_s + (warp * 16 + (lane & 15)) * ls + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < MT / 8; n += 2) {
      unsigned b[4];
      ldsm(b, b_s + (n * 8 + (lane & 7) + (lane >> 4) * 8) * ls + k0 +
                  ((lane >> 3) & 1) * 8);
      mma(acc[n], a, b[0], b[1]);
      mma(acc[n + 1], a, b[2], b[3]);
    }
  }
  const int Qt = qn * MT, g = lane >> 2, t = lane & 3;
  float* out = cb + (chunk * Qt + ti * MT + warp * 16 + g) * Qt + tj * MT;
#pragma unroll
  for (int n = 0; n < MT / 8; ++n) {
    st2(out + n * 8 + 2 * t, acc[n][0], acc[n][1]);
    st2(out + 8 * Qt + n * 8 + 2 * t, acc[n][2], acc[n][3]);
  }
}

// Pass 2: La and the chunk state S_c = (B o u)^T x of one chunk and head.
// grid (nh, B nC), 2 ns threads: ns / 16 warps, 16 state rows each.
template <int HP>
__global__ void __launch_bounds__(2 * NS_MAX) ssd_state_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ bm,
    const float* __restrict__ dt, const float* __restrict__ A,
    float* __restrict__ la_out, float* __restrict__ states, int Q, int nh,
    int ns, int qn) {
  constexpr int XS = HP + MPAD;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int Qt = qn * MT, bs = ns + MPAD, nthr = blockDim.x;
  bf16* b_s = reinterpret_cast<bf16*>(mma_smem);   // [2][MT][bs] B rows j
  bf16* x_s = b_s + 2 * MT * bs;                    // [2][MT][XS] x rows j
  float* dts = reinterpret_cast<float*>(x_s + 2 * MT * XS);   // [Qt]
  float* la = dts + Qt;                                        // [Qt]
  float* u = la + Qt;                                          // [Qt]
  const int h = blockIdx.x;
  const long long chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto stage = [&](int kt, int s) {
    const int j0 = kt * MT, pieces = ns / 8;
    for (int e = tid; e < MT * pieces; e += nthr) {
      const int r = e / pieces, k = (e - r * pieces) * 8;
      const int j = j0 + r;
      cp16(b_s + (s * MT + r) * bs + k,
           bm + (chunk * Q + min(j, Q - 1)) * ns + k, j < Q);
    }
    for (int e = tid; e < MT * (HP / 8); e += nthr) {
      const int r = e / (HP / 8), p = (e - r * (HP / 8)) * 8;
      const int j = j0 + r;
      cp16(x_s + (s * MT + r) * XS + p,
           x + ((chunk * Q + min(j, Q - 1)) * nh + h) * HP + p, j < Q);
    }
  };
  stage(0, 0);
  cp_commit();

  for (int j = tid; j < Qt; j += nthr)
    dts[j] = j < Q ? dt[(chunk * Q + j) * nh + h] : 0.0f;
  __syncthreads();
  if (warp == 0) {              // inclusive scan of dt * A
    const float a = A[h];
    float carry = 0.0f;
    for (int base = 0; base < Qt; base += 32) {
      const int i = base + lane;
      float v = dts[i] * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += t;
      }
      v += carry;
      la[i] = i < Q ? v : 0.0f;
      carry = __shfl_sync(FULL, v, 31);
    }
  }
  __syncthreads();
  const float la_last = la[Q - 1];
  for (int j = tid; j < Qt; j += nthr) {
    u[j] = j < Q ? expf(la_last - la[j]) * dts[j] : 0.0f;
    la_out[(chunk * nh + h) * Qt + j] = la[j];
  }

  const int g = lane >> 2, t = lane & 3;
  float acc[HP / 8][4];
#pragma unroll
  for (int n = 0; n < HP / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.0f;
  for (int kt = 0; kt < qn; ++kt) {
    if (kt + 1 < qn) stage(kt + 1, (kt + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();            // this tile has landed; u is written
    const bf16* bt = b_s + (kt & 1) * MT * bs;
    const bf16* xt = x_s + (kt & 1) * MT * XS;
#pragma unroll
    for (int k0 = 0; k0 < MT; k0 += 16) {
      // A = (B o u)^T: rows are states, columns keys j; the B tile is
      // stored [j][state], so ldmatrix transposes it
      unsigned a[4], hi[4], lo[4];
      ldsm_t(a, bt + (k0 + (lane & 7) + (lane >> 4) * 8) * bs + warp * 16 +
                    ((lane >> 3) & 1) * 8);
      const int j = kt * MT + k0 + 2 * t;
      const float2 u0 = *reinterpret_cast<const float2*>(u + j);
      const float2 u8 = *reinterpret_cast<const float2*>(u + j + 8);
      scale_split(a[0], u0, hi[0], lo[0]);
      scale_split(a[1], u0, hi[1], lo[1]);
      scale_split(a[2], u8, hi[2], lo[2]);
      scale_split(a[3], u8, hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < HP / 8; n += 2) {
        unsigned b[4];
        ldsm_t(b, xt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                      n * 8 + (lane >> 4) * 8);
        mma(acc[n], hi, b[0], b[1]);
        mma(acc[n], lo, b[0], b[1]);
        mma(acc[n + 1], hi, b[2], b[3]);
        mma(acc[n + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();            // the stage is free for tile kt + 2
  }
  float* out = states + ((chunk * nh + h) * ns + warp * 16 + g) * HP;
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    st2(out + n * 8 + 2 * t, acc[n][0], acc[n][1]);
    st2(out + 8 * HP + n * 8 + 2 * t, acc[n][2], acc[n][3]);
  }
}

// Pass 3: the state entering each chunk, in float32, in chunk order.
// grid (ceil(nh ns hp / 4 / ST_NT), B), ST_NT threads, 4 elements each.
__global__ void __launch_bounds__(ST_NT) ssd_pass_kernel(
    const float* __restrict__ states, const float* __restrict__ la,
    bf16* __restrict__ hin, float* __restrict__ hfin, int nC, int Q, int nh,
    int nshp, int Qt) {
  const long long per = static_cast<long long>(nh) * nshp;
  const long long e =
      (static_cast<long long>(blockIdx.x) * ST_NT + threadIdx.x) * 4;
  if (e >= per) return;
  const int b = blockIdx.y, h = static_cast<int>(e / nshp);
  float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < nC; ++c) {
    const long long chunk = static_cast<long long>(b) * nC + c;
    const float4 s = *reinterpret_cast<const float4*>(states + chunk * per + e);
    const float d = expf(la[(chunk * nh + h) * Qt + Q - 1]);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(hin + chunk * per + e);
    o[0] = __floats2bfloat162_rn(st.x, st.y);
    o[1] = __floats2bfloat162_rn(st.z, st.w);
    st = make_float4(st.x * d + s.x, st.y * d + s.y, st.z * d + s.z,
                     st.w * d + s.w);
  }
  *reinterpret_cast<float4*>(hfin + b * per + e) = st;
}

// W[i][j] and W[i][j + 1] of query row i, masked (j <= i) before the exp,
// split into a high and a low part; kd = {La_j, dt_j, La_j+1, dt_j+1}
__device__ __forceinline__ void w_pair(const float* cbp, float4 kd, int j,
                                       int i, float la_i, bool row_ok,
                                       unsigned& hi, unsigned& lo) {
  const float2 c = *reinterpret_cast<const float2*>(cbp);
  const float w0 =
      row_ok && j <= i ? c.x * exp2f((la_i - kd.x) * LOG2E) * kd.y : 0.0f;
  const float w1 =
      row_ok && j < i ? c.y * exp2f((la_i - kd.z) * LOG2E) * kd.w : 0.0f;
  split(w0, w1, hi, lo);
}

// Pass 4: y for 64 query rows of one chunk and head.
// grid (qn, nh, B nC), MNT threads.
template <int HP, typename TO>
__global__ void __launch_bounds__(MNT) ssd_out_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ cm,
    const float* __restrict__ dt, const float* __restrict__ cb,
    const float* __restrict__ la_g, const bf16* __restrict__ hin,
    TO* __restrict__ y, int Q, int nh, int ns, int qn) {
  constexpr int XS = HP + MPAD;
  constexpr int STAGE = out_stage_bytes(HP);
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int Qt = qn * MT, ls = ns + MPAD;
  const int region = out_region_bytes(ns, HP);
  // C and h_in for the first product; then stage 1 of the ring in their
  // place, stage 0 after them, {La, dt} of each key last
  bf16* c_s = reinterpret_cast<bf16*>(mma_smem);          // [MT][ls]
  bf16* h_s = c_s + MT * ls;                               // [ns][XS]
  float* kd = reinterpret_cast<float*>(mma_smem + region + STAGE);  // [2 Qt]
  const int qt = blockIdx.x, h = blockIdx.y;
  const long long chunk = blockIdx.z;
  const int i0 = qt * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto stage_x = [&](int s) {
    return reinterpret_cast<bf16*>(mma_smem + (s ? 0 : region));
  };
  auto stage_cb = [&](int s) {
    return reinterpret_cast<float*>(mma_smem + (s ? 0 : region) +
                                    2 * MT * XS);
  };
  auto stage = [&](int kt, int s) {
    const int j0 = kt * MT;
    bf16* xs = stage_x(s);
    float* cbs = stage_cb(s);
    for (int e = tid; e < MT * (HP / 8); e += MNT) {
      const int r = e / (HP / 8), p = (e - r * (HP / 8)) * 8;
      const int j = j0 + r;
      cp16(xs + r * XS + p,
           x + ((chunk * Q + min(j, Q - 1)) * nh + h) * HP + p, j < Q);
    }
    for (int e = tid; e < MT * (MT / 4); e += MNT) {
      const int r = e >> 4, k = (e & 15) * 4;
      cp16(cbs + r * CBS + k, cb + (chunk * Qt + i0 + r) * Qt + j0 + k, true);
    }
  };
  const int pieces = ns / 8;
  for (int e = tid; e < MT * pieces; e += MNT) {
    const int r = e / pieces, k = (e - r * pieces) * 8;
    const int i = i0 + r;
    cp16(c_s + r * ls + k, cm + (chunk * Q + min(i, Q - 1)) * ns + k, i < Q);
  }
  const bf16* hsrc = hin + (chunk * nh + h) * ns * HP;
  for (int e = tid; e < ns * (HP / 8); e += MNT) {
    const int r = e / (HP / 8), p = (e - r * (HP / 8)) * 8;
    cp16(h_s + r * XS + p, hsrc + r * HP + p, true);
  }
  stage(0, 0);
  cp_commit();
  for (int j = tid; j < i0 + MT; j += MNT) {
    kd[2 * j] = j < Q ? la_g[(chunk * nh + h) * Qt + j] : 0.0f;
    kd[2 * j + 1] = j < Q ? dt[(chunk * Q + j) * nh + h] : 0.0f;
  }

  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;        // rows of the tile
  const int ia = i0 + r0, ib = i0 + r1;
  const bool oka = ia < Q, okb = ib < Q;
  float acc[HP / 8][4];
#pragma unroll
  for (int n = 0; n < HP / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.0f;
  cp_wait<0>();
  __syncthreads();              // C, h_in, tile 0, La and dt are in place
  // the carried state's term, exp(La_i) (C h_in)[i][p]
  for (int k0 = 0; k0 < ns; k0 += 16) {
    unsigned a[4];
    ldsm(a, c_s + (warp * 16 + (lane & 15)) * ls + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < HP / 8; n += 2) {
      unsigned b[4];
      ldsm_t(b, h_s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                    n * 8 + (lane >> 4) * 8);
      mma(acc[n], a, b[0], b[1]);
      mma(acc[n + 1], a, b[2], b[3]);
    }
  }
  const float laa = oka ? kd[2 * ia] : 0.0f, lab = okb ? kd[2 * ib] : 0.0f;
  const float ea = oka ? expf(laa) : 0.0f, eb = okb ? expf(lab) : 0.0f;
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    acc[n][0] *= ea;
    acc[n][1] *= ea;
    acc[n][2] *= eb;
    acc[n][3] *= eb;
  }
  __syncthreads();              // C and h_in are read: stage 1 takes over

  for (int kt = 0; kt <= qt; ++kt) {
    if (kt < qt) stage(kt + 1, (kt + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();            // tile kt has landed
    const int j0 = kt * MT;
    const float* cba = stage_cb(kt & 1) + r0 * CBS;
    const float* cbb = cba + 8 * CBS;
    const bf16* xt = stage_x(kt & 1);
#pragma unroll
    for (int k0 = 0; k0 < MT; k0 += 16) {
      const int jl = k0 + 2 * t, j = j0 + jl;
      const float4 kd0 = *reinterpret_cast<const float4*>(kd + 2 * j);
      const float4 kd8 = *reinterpret_cast<const float4*>(kd + 2 * j + 16);
      unsigned hi[4], lo[4];
      w_pair(cba + jl, kd0, j, ia, laa, oka, hi[0], lo[0]);
      w_pair(cbb + jl, kd0, j, ib, lab, okb, hi[1], lo[1]);
      w_pair(cba + jl + 8, kd8, j + 8, ia, laa, oka, hi[2], lo[2]);
      w_pair(cbb + jl + 8, kd8, j + 8, ib, lab, okb, hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < HP / 8; n += 2) {
        unsigned b[4];
        ldsm_t(b, xt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                      n * 8 + (lane >> 4) * 8);
        mma(acc[n], hi, b[0], b[1]);
        mma(acc[n], lo, b[0], b[1]);
        mma(acc[n + 1], hi, b[2], b[3]);
        mma(acc[n + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();            // the stage is free for tile kt + 2
  }
  TO* ya = y + ((chunk * Q + ia) * nh + h) * HP + 2 * t;
  TO* yb = y + ((chunk * Q + ib) * nh + h) * HP + 2 * t;
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    if (oka) st2(ya + n * 8, acc[n][0], acc[n][1]);
    if (okb) st2(yb + n * 8, acc[n][2], acc[n][3]);
  }
}

template <typename K>
cudaError_t opt_in(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int HP, typename TO>
int launch_bf16(const bf16* x, const bf16* bm, const bf16* cm,
                const float* dt, const float* A, TO* y, float* hfin,
                float* cb, float* la, float* states, bf16* hin, int B,
                int nC, int Q, int nh, int ns, cudaStream_t stream) {
  const int qn = (Q + MT - 1) / MT, Qt = qn * MT, chunks = B * nC;
  cudaError_t err;
  const size_t s1 = cb_smem(ns);
  if ((err = opt_in(ssd_cb_kernel, s1)) != cudaSuccess) return err;
  ssd_cb_kernel<<<dim3(qn * (qn + 1) / 2, chunks), MNT, s1, stream>>>(
      bm, cm, cb, Q, ns, qn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t s2 = state_smem(Qt, ns, HP);
  if ((err = opt_in(ssd_state_kernel<HP>, s2)) != cudaSuccess) return err;
  ssd_state_kernel<HP><<<dim3(nh, chunks), 2 * ns, s2, stream>>>(
      x, bm, dt, A, la, states, Q, nh, ns, qn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long quads = static_cast<long long>(nh) * ns * HP / 4;
  ssd_pass_kernel<<<dim3(static_cast<unsigned>((quads + ST_NT - 1) / ST_NT),
                         B),
                    ST_NT, 0, stream>>>(states, la, hin, hfin, nC, Q, nh,
                                        ns * HP, Qt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t s4 = out_smem(Qt, ns, HP);
  if ((err = opt_in(ssd_out_kernel<HP, TO>, s4)) != cudaSuccess) return err;
  ssd_out_kernel<HP, TO><<<dim3(qn, nh, chunks), MNT, s4, stream>>>(
      x, cm, dt, cb, la, hin, y, Q, nh, ns, qn);
  return cudaGetLastError();
}

template <typename TO>
int dispatch_hp(const bf16* x, const bf16* bm, const bf16* cm,
                const float* dt, const float* A, TO* y, float* hfin,
                float* cb, float* la, float* states, bf16* hin, int B,
                int nC, int Q, int nh, int hp, int ns, cudaStream_t s) {
  switch (hp) {
    case 32:
      return launch_bf16<32>(x, bm, cm, dt, A, y, hfin, cb, la, states, hin,
                             B, nC, Q, nh, ns, s);
    case 64:
      return launch_bf16<64>(x, bm, cm, dt, A, y, hfin, cb, la, states, hin,
                             B, nC, Q, nh, ns, s);
    case 128:
      return launch_bf16<128>(x, bm, cm, dt, A, y, hfin, cb, la, states,
                              hin, B, nC, Q, nh, ns, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// float32 x, B, C and y.  x and y (B, nC, Q, nh, hp), B and C
// (B, nC, Q, ns), dt (B, nC, Q, nh), A (nh,), h_final (B, nh, ns, hp),
// all float32 and contiguous.  hp must be a multiple of 32, ns at most
// 256.
extern "C" int ssd_scan_fwd(const void* x, const void* bm, const void* cm,
                            const void* dt, const void* A, void* y,
                            void* hfin, int B, int nC, int Q, int nh,
                            int hp, int ns, void* stream) {
  if (B < 1 || nC < 1 || Q < 1 || nh < 1 || hp < P || hp % P != 0 ||
      ns < 1 || ns > NS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const float*>(dt);
  const auto* a = static_cast<const float*>(A);
  auto* hf = static_cast<float*>(hfin);
  auto* s = static_cast<cudaStream_t>(stream);
  return launch<float, float>(x, bm, cm, d, a, y, hf, B, nC, Q, nh, hp, ns,
                              s);
}

// bfloat16 x, B and C; y float32 (out_dtype 0) or bfloat16 (1).  x and y
// (B, nC, Q, nh, hp), B and C (B, nC, Q, ns), dt (B, nC, Q, nh) float32,
// A (nh,) float32, h_final (B, nh, ns, hp) float32, all contiguous, x, B
// and C 16-byte aligned.  Scratch from the caller, Qt = Q rounded up to
// 64: cb (B, nC, Qt, Qt) float32, la (B, nC, nh, Qt) float32, states
// (B, nC, nh, ns, hp) float32 and hin (B, nC, nh, ns, hp) bfloat16.  hp
// 32, 64 or 128; ns a multiple of 16, at most 256.  Four launches.
extern "C" int ssd_scan_bf16(const void* x, const void* bm, const void* cm,
                             const void* dt, const void* A, void* y,
                             void* hfin, void* cb, void* la, void* states,
                             void* hin, int out_dtype, int B, int nC, int Q,
                             int nh, int hp, int ns, void* stream) {
  if (B < 1 || nC < 1 || Q < 1 || nh < 1 || hp > HP_MAX || ns < 16 ||
      ns % 16 != 0 || ns > NS_MAX || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* bb = static_cast<const bf16*>(bm);
  const auto* cc = static_cast<const bf16*>(cm);
  const auto* d = static_cast<const float*>(dt);
  const auto* a = static_cast<const float*>(A);
  auto* hf = static_cast<float*>(hfin);
  auto* cbp = static_cast<float*>(cb);
  auto* lap = static_cast<float*>(la);
  auto* sp = static_cast<float*>(states);
  auto* hp_in = static_cast<bf16*>(hin);
  auto* s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return dispatch_hp(xb, bb, cc, d, a, static_cast<float*>(y), hf, cbp,
                       lap, sp, hp_in, B, nC, Q, nh, hp, ns, s);
  return dispatch_hp(xb, bb, cc, d, a, static_cast<bf16*>(y), hf, cbp, lap,
                     sp, hp_in, B, nC, Q, nh, hp, ns, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
