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
// form); the final state in float32, (B, nh, ns, hp).
//
// What bounds it: at the prefill shape (Q 256, ns 128, hp 64) the least
// work is about 17.5 GFLOP against about 106 MB, so on tensor cores the
// bytes would bound it.  This first kernel runs every product on the CUDA
// cores in float32 from shared memory, so shared-memory loads bound it,
// far above that.  Design:
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
// Inputs are read in their own type (float32 or bfloat16, no copy) and
// widened on load; all arithmetic is float32.  Shared memory is
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
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// dtype: type of x, B and C; out_dtype: type of y; 0 float32, 1 bfloat16
// (a float32 x takes a float32 y).  x and y (B, nC, Q, nh, hp), B and C
// (B, nC, Q, ns), dt (B, nC, Q, nh) float32, A (nh,) float32, h_final
// (B, nh, ns, hp) float32, all contiguous.  hp must be a multiple of 32,
// ns at most 256.
extern "C" int ssd_scan_fwd(const void* x, const void* bm, const void* cm,
                            const void* dt, const void* A, void* y,
                            void* hfin, int dtype, int out_dtype, int B,
                            int nC, int Q, int nh, int hp, int ns,
                            void* stream) {
  if (B < 1 || nC < 1 || Q < 1 || nh < 1 || hp < P || hp % P != 0 ||
      ns < 1 || ns > NS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const float*>(dt);
  const auto* a = static_cast<const float*>(A);
  auto* hf = static_cast<float*>(hfin);
  auto* s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, bm, cm, d, a, y, hf, B, nC, Q, nh, hp, ns,
                                s);
  if (dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, bm, cm, d, a, y, hf, B, nC, Q, nh,
                                        hp, ns, s);
  if (dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, bm, cm, d, a, y, hf, B,
                                                nC, Q, nh, hp, ns, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
