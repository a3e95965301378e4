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
// Masked scores are -inf, so masked keys give p = 0 exactly and a row
// with no visible key ends with l = 0, output 0 and a finite lse (not
// NaN).  Any Sq, Skv, q_offset, window and kv_len.
//
// What bounds it: operations.  At the training shapes (S = 4096) each
// visible (q, k) pair costs 4 * D flops against a few bytes of q/k/v,
// far above the card's flop/byte balance, so the products belong on the
// tensor cores.  Two kernels:
//
// bf16: flash_fwd_wgmma, both products on wgmma, K/V by TMA.
//   * A block of 288 threads owns 128 query rows of one (head, batch):
//     two consumer warpgroups of 64 rows each and one producer warp, so
//     that no consumer stalls on a free stage.  ptxas gives a thread of
//     this block at most 168 registers; D = 128 needs a few more (its
//     64 x 128 scores and output beside the P fragment), so ptxas
//     spills and serialises its products.  D = 256 keeps the 64 x 256
//     float32 output accumulator (128 registers a thread) beside the
//     scores only with one consumer warpgroup: 64 rows a block, 64-key
//     tiles, 160 threads.
//   * The producer's elected lane loads the q tile once and the K and V
//     tiles of 128 keys (64 at D = 256) into a ring of STAGES stages by
//     TMA (cp.async.bulk.tensor, 4-d maps of the (B, S, heads, D) tensors
//     encoded on the host per call and passed __grid_constant__), with
//     mbarrier completion; a stage is refilled once both consumer
//     warpgroups have arrived on its "empty" barrier, so the next tile
//     loads while the current one is computed.  Rows past Sq and keys
//     past Skv arrive as TMA's out-of-bounds zeros.
//   * S = Q.K^T: wgmma m64nKk16, bf16 in, float32 accumulate, Q (A) and K
//     (B) both K-major from shared memory: the (keys, D) tile with D
//     contiguous is what the (B, Skv, KVH, D) layout gives, no transpose.
//   * O += P.V: P is the S accumulator rounded to bf16 in registers (the
//     accumulator's fragment of 8 columns per k16 step is the A operand's
//     register fragment, so the conversion moves no data between
//     threads); V is the B operand read MN-major (the transpose bit of
//     16-bit wgmma).  P is rounded to bf16 before P.V, as the reference's
//     model scan (repro/models/common.py:97) and the plain version here
//     do; the Pallas kernel keeps P in float32.  Both lie well inside the
//     2e-2 bf16 tolerance.  The row sum l uses the unrounded P.
//   * D is cut into 64-column chunks with 128-byte swizzle, then at most
//     one 32-column chunk with 64-byte swizzle and one 16-column chunk
//     with 32-byte swizzle (a TMA box's inner extent may not exceed its
//     swizzle span, and the wgmma descriptor knows only these three
//     spans).  D = 80 (stablelm) is 64 + 16; D = 112 (zamba2) is
//     64 + 32 + 16, with three maps per tensor.  No padding: Q.K^T does
//     D columns of work, and P.V is one n64 (n32, n16) wgmma per chunk
//     and k step; the narrow ones run the tensor cores at a half or a
//     quarter of their width.  The other cut of 112, two 64-column boxes
//     with TMA's out-of-bounds zeros in columns 112-127, was not taken:
//     it costs 14 % more Q.K^T work and 20 KB more shared memory a block
//     and must drop 16 output columns at the store, while the three-chunk
//     cut reuses the 32- and 16-column paths that D = 32 and D = 80
//     already run.
//   * Only tiles that straddle the causal diagonal, the window edge or
//     kv_len evaluate the mask; interior tiles skip it.  The key range of
//     a block runs from the first tile the window reaches to the last one
//     the causal and kv_len limits allow; a warpgroup whose 64 rows see
//     no key of a tile skips its products.  Q tiles run in reverse, so
//     the longest causal rows start first.
//   * Softmax in float32 with exp2 (scores pre-scaled by D**-0.5 log2 e);
//     the row max and sum reduce over the 4 lanes that share a row.
//
// float32: flash_fwd_f32 keeps the CUDA-core kernel.  On the tensor cores
//   float32 inputs would run in TF32 (about 3 decimal digits), losing
//   what the 2e-5 float32 tolerance and the float32 prefill-vs-decode
//   gates rely on.  One block of 128 threads per (q tile of 64 rows,
//   head, batch) loops over 64-key tiles; q and each K tile are staged in
//   shared memory transposed and padded, V row-major; thread (rg, cg)
//   owns 4 rows and 8 key columns of the score tile and the matching
//   output columns; the 8 threads of a row group reduce with shuffles.
//
// Both opt in to more than 48 KB of dynamic shared memory with
// cudaFuncSetAttribute.  The TMA maps need the driver's
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint, so the
// library links no libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;

// ----------------------------------------------------------------------
// bf16: wgmma + TMA
// ----------------------------------------------------------------------
constexpr int STAGES = 2;       // K/V ring depth
constexpr int WG = 128;         // threads of a warpgroup
constexpr int WG_ROWS = 64;     // query rows of a consumer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int rows_per_block(int D) {
  return D > 128 ? 64 : 128;
}
__host__ __device__ constexpr int keys_per_tile(int D) {
  return D > 128 ? 64 : 128;
}
constexpr size_t wgmma_smem_bytes(int D) {
  // alignment slack, q tile, STAGES x (K, V) tiles, 2 * STAGES + 1 barriers
  return 1024 + 2 * static_cast<size_t>(D) *
                    (rows_per_block(D) + 2 * STAGES * keys_per_tile(D)) +
         8 * (2 * STAGES + 1);
}

// the columns of D past its 64-column chunks: a 32-column chunk, then a
// 16-column one (D a multiple of 16)
__host__ __device__ constexpr int cols32(int D) {
  return D % 64 >= 32 ? 32 : 0;
}
__host__ __device__ constexpr int cols16(int D) { return D % 32; }
// byte offsets of the 32- and 16-column chunks in a tile of n rows (each
// chunk is n rows of its width, the 64-column chunks first)
__host__ __device__ constexpr int off32(int n, int D) {
  return n * 128 * (D / 64);
}
__host__ __device__ constexpr int off16(int n, int D) {
  return off32(n, D) + n * 2 * cols32(D);
}

struct Maps {   // TMA maps: the 64-, 32- and 16-column chunks
  CUtensorMap q, k, v, q32, k32, v32, q16, k16, v16;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// A wait that spins for seconds traps: a lost copy or arrival fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    if (spins == (1 << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// one box of a 4-d map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a tile whose rows are `width` bf16
// (16, 32 or 64: 32-, 64- or 128-byte swizzle), 8-row groups 8 rows apart
__device__ __forceinline__ uint64_t desc(uint32_t addr, int width,
                                         uint32_t lbo) {
  const uint64_t layout = width == 64 ? 1 : width == 32 ? 2 : 3;
  const uint32_t sbo = 16 * width;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from touching accumulators across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N> struct Wgmma;
template <> struct Wgmma<16> {
  // D[64 x 16] (+)= A[64 x 16] * B[16 x 16], A and B in shared memory
  __device__ static __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
  // D[64 x 16] += A[64 x 16] * B[16 x 16], A in registers, B MN-major
  __device__ static __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

template <> struct Wgmma<32> {
  // D[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B in shared memory
  __device__ static __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
  // D[64 x 32] += A[64 x 16] * B[16 x 32], A in registers, B MN-major
  __device__ static __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

template <> struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory
  __device__ static __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B MN-major
  __device__ static __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

template <> struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B in shared memory
  __device__ static __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
  // D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers, B MN-major
  __device__ static __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};


template <int D>
__global__ void __launch_bounds__(rows_per_block(D) / WG_ROWS * WG + 32, 1)
    flash_fwd_wgmma(const __grid_constant__ Maps maps,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Sq, int H, int KVH, int causal, int window,
                    int kv_lim, int q_offset, float scale_log2) {
  constexpr int ROWS = rows_per_block(D), KEYS = keys_per_tile(D);
  constexpr int NWG = ROWS / WG_ROWS;          // consumer warpgroups
  static_assert(D % 16 == 0, "D is cut into 64-, 32- and 16-col chunks");
  constexpr int FULL = D / 64, T32 = cols32(D), T16 = cols16(D);
  constexpr int NS = KEYS / 2, NO = D / 2;     // accumulator registers
  constexpr int Q_BYTES = ROWS * D * 2, KV_BYTES = KEYS * D * 2;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles must start on 1024 bytes
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_addr(base);
  const uint32_t bars = q_s + Q_BYTES + STAGES * 2 * KV_BYTES;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (STAGES + st), q last
  const uint32_t q_bar = bars + 16 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  // the key range any row of this block can see
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + ROWS, Sq) - 1;
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin -= k_begin % KEYS;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KEYS - 1) / KEYS
                                      : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (STAGES + st), NWG * WG);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (warp == NWG * 4) {  // producer warp: one lane issues every copy
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_bar, Q_BYTES);
#pragma unroll
      for (int c = 0; c < FULL; ++c)
        tma_load(q_s + ROWS * 128 * c, &maps.q, q_bar, 64 * c, h, q0, b);
      if (T32)
        tma_load(q_s + off32(ROWS, D), &maps.q32, q_bar, 64 * FULL, h, q0,
                 b);
      if (T16)
        tma_load(q_s + off16(ROWS, D), &maps.q16, q_bar, 64 * FULL + T32, h,
                 q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        const uint32_t full = bars + 8 * st;
        if (i >= STAGES)  // both warpgroups are done with the stage
          mbar_wait(bars + 8 * (STAGES + st), ((i / STAGES) + 1) & 1);
        mbar_expect_tx(full, 2 * KV_BYTES);
        const int k0 = k_begin + i * KEYS;
        const uint32_t k_s = q_s + Q_BYTES + st * 2 * KV_BYTES;
        const uint32_t v_s = k_s + KV_BYTES;
#pragma unroll
        for (int c = 0; c < FULL; ++c) {
          tma_load(k_s + KEYS * 128 * c, &maps.k, full, 64 * c, kvh, k0, b);
          tma_load(v_s + KEYS * 128 * c, &maps.v, full, 64 * c, kvh, k0, b);
        }
        if (T32) {
          tma_load(k_s + off32(KEYS, D), &maps.k32, full, 64 * FULL, kvh, k0,
                   b);
          tma_load(v_s + off32(KEYS, D), &maps.v32, full, 64 * FULL, kvh, k0,
                   b);
        }
        if (T16) {
          tma_load(k_s + off16(KEYS, D), &maps.k16, full, 64 * FULL + T32,
                   kvh, k0, b);
          tma_load(v_s + off16(KEYS, D), &maps.v16, full, 64 * FULL + T32,
                   kvh, k0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows r0 .. r0 + 63; this thread holds rows
  // row0 and row0 + 8, columns 8j + 2t and 8j + 2t + 1 of each 8-block
  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * WG_ROWS;
  const int wq_lo = q_offset + r0;
  const int wq_hi = q_offset + min(r0 + WG_ROWS, Sq) - 1;
  const int row0 = r0 + (warp % 4) * 16 + g;
  const uint32_t q_wg = q_s + wg * WG_ROWS * 128;       // in a 64-col chunk
  const uint32_t q_wg32 = q_s + off32(ROWS, D) + wg * WG_ROWS * T32 * 2;
  const uint32_t q_wg16 = q_s + off16(ROWS, D) + wg * WG_ROWS * T16 * 2;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  if (n_tiles > 0) mbar_wait(q_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const int k0 = k_begin + i * KEYS;
    const uint32_t k_s = q_s + Q_BYTES + st * 2 * KV_BYTES;
    const uint32_t v_s = k_s + KV_BYTES;
    mbar_wait(bars + 8 * st, (i / STAGES) & 1);
    const bool live = wq_lo <= wq_hi && k0 < kv_lim &&
                      !(causal && k0 > wq_hi) &&
                      !(window > 0 && wq_lo - (k0 + KEYS - 1) >= window);
    if (live) {
      float s[NS];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < FULL; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<KEYS>::ss(s, desc(q_wg + ROWS * 128 * c + 32 * kk, 64, 16),
                          desc(k_s + KEYS * 128 * c + 32 * kk, 64, 16),
                          c > 0 || kk > 0);
      if constexpr (T32 > 0) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          Wgmma<KEYS>::ss(s, desc(q_wg32 + 32 * kk, 32, 16),
                          desc(k_s + off32(KEYS, D) + 32 * kk, 32, 16),
                          FULL > 0 || kk > 0);
      }
      if constexpr (T16 > 0)
        Wgmma<KEYS>::ss(s, desc(q_wg16, 16, 16),
                        desc(k_s + off16(KEYS, D), 16, 16),
                        FULL > 0 || T32 > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs<NS>(s);

      // the mask, only on tiles that straddle an edge of it
      if (k0 + KEYS > kv_lim || (causal && k0 + KEYS - 1 > wq_lo) ||
          (window > 0 && wq_hi - k0 >= window)) {
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * j + 2 * t + e;
              const int pos = q_offset + row0 + 8 * r;
              bool ok = key < kv_lim;
              if (causal) ok = ok && key <= pos;
              if (window > 0) ok = ok && pos - key < window;
              if (!ok) s[4 * j + 2 * r + e] = -INFINITY;
            }
      }

      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * r + e];
            x = exp2f(fmaf(x, scale_log2, -m_new));   // 0 where masked
            sum += x;
          }
        l[r] = l[r] * corr[r] + sum;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * j + 2 * r] *= corr[r];
          o[4 * j + 2 * r + 1] *= corr[r];
        }
      // P in bf16: k step kk's A fragment is s[8 kk .. 8 kk + 7]
      uint32_t pa[KEYS / 16][4];
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < FULL; ++c)
          Wgmma<64>::rs(o + 32 * c, pa[kk],
                        desc(v_s + KEYS * 128 * c + 16 * 128 * kk, 64,
                             KEYS * 128));
        if constexpr (T32 > 0)
          Wgmma<32>::rs(o + 32 * FULL, pa[kk],
                        desc(v_s + off32(KEYS, D) + 16 * 64 * kk, 32,
                             KEYS * 64));
        if constexpr (T16 > 0)
          Wgmma<16>::rs(o + 32 * FULL + T32 / 2, pa[kk],
                        desc(v_s + off16(KEYS, D) + 16 * 32 * kk, 16,
                             KEYS * 32));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<NO>(o);
    }
    mbar_arrive(bars + 8 * (STAGES + st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + 8 * r;
    if (row < Sq) {
      const float ls = fmaxf(sum, 1e-30f);
      const float inv = 1.0f / ls;
      __nv_bfloat16* orow =
          out + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
      if (t == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + row] =
            m[r] <= NEG_INF ? NEG_INF : m[r] * LN2 + logf(ls);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a contiguous bf16 (B, S, heads, D) tensor whose box is `cols`
// columns of D (16, 32 or 64, swizzled by as many x 2 bytes) by `rows`
// positions of S, for one head and batch.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, int cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads,
                                 2ull * D * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Sq, int Skv, int H, int KVH,
                 int causal, int window, int kv_lim, int q_offset,
                 float scale, cudaStream_t stream) {
  constexpr int ROWS = rows_per_block(D), KEYS = keys_per_tile(D);
  Maps maps = {};
  bool ok = true;
  if (D >= 64) {
    ok = ok && make_map(&maps.q, q, B, Sq, H, D, 64, ROWS);
    ok = ok && make_map(&maps.k, k, B, Skv, KVH, D, 64, KEYS);
    ok = ok && make_map(&maps.v, v, B, Skv, KVH, D, 64, KEYS);
  }
  if (cols32(D) > 0) {
    ok = ok && make_map(&maps.q32, q, B, Sq, H, D, 32, ROWS);
    ok = ok && make_map(&maps.k32, k, B, Skv, KVH, D, 32, KEYS);
    ok = ok && make_map(&maps.v32, v, B, Skv, KVH, D, 32, KEYS);
  }
  if (cols16(D) > 0) {
    ok = ok && make_map(&maps.q16, q, B, Sq, H, D, 16, ROWS);
    ok = ok && make_map(&maps.k16, k, B, Skv, KVH, D, 16, KEYS);
    ok = ok && make_map(&maps.v16, v, B, Skv, KVH, D, 16, KEYS);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wgmma_smem_bytes(D);
  auto kern = flash_fwd_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
  kern<<<grid, ROWS / WG_ROWS * WG + 32, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(out), lse, Sq, H, KVH, causal,
      window, kv_lim, q_offset, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------------
// float32: the CUDA-core kernel
// ----------------------------------------------------------------------
constexpr int F32_BQ = 64;      // query rows per block
constexpr int F32_BK = 64;      // keys per tile
constexpr int NT = 128;         // threads: 16 row groups x 8 column groups
constexpr int RPT = 4;          // rows per thread (F32_BQ / 16)
constexpr int CPT = 8;          // score columns per thread (F32_BK / 8)
constexpr int QS = F32_BQ + 1;  // stride of the transposed q tile
constexpr int KS = F32_BK + 1;  // stride of the transposed K tile
constexpr int PS = F32_BK + 1;  // stride of the probability tile

constexpr size_t f32_smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(D) * QS + D * KS +
                          F32_BK * D + F32_BQ * PS);
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

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int Sq, int Skv, int H, int KVH, int causal,
    int window, int kv_lim, int q_offset, float scale) {
  constexpr int NJ = (D + 7) / 8;       // output columns per thread
  extern __shared__ float smem[];
  float* q_t = smem;                    // [D][QS]  q tile, transposed
  float* k_t = q_t + D * QS;            // [D][KS]  K tile, transposed
  float* v_s = k_t + D * KS;            // [F32_BK][D]  V tile
  float* p_s = v_s + F32_BK * D;        // [F32_BQ][PS] probabilities

  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F32_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;
  const float* qb = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<long long>(b) * Skv * KVH + kvh) * D;
  const float* vb = v + (static_cast<long long>(b) * Skv * KVH + kvh) * D;

  for (int i = tid; i < F32_BQ * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    q_t[d * QS + r] = row < Sq ? qb[row * q_stride + d] : 0.0f;
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
  const int q_hi = q_offset + min(q0 + F32_BQ, Sq) - 1;
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin -= k_begin % F32_BK;

  for (int k0 = k_begin; k0 < k_end; k0 += F32_BK) {
    __syncthreads();      // the previous tile's readers are done
    for (int i = tid; i < F32_BK * D; i += NT) {
      const int r = i / D, d = i - r * D;
      const int key = k0 + r;
      const bool in = key < Skv;
      const long long off = key * kv_stride + d;
      k_t[d * KS + r] = in ? kb[off] : 0.0f;
      v_s[i] = in ? vb[off] : 0.0f;
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
    for (int t = 0; t < F32_BK; ++t) {
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
      float* orow = out + (static_cast<long long>(b) * Sq + row) * q_stride +
                    static_cast<long long>(h) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 8 * j;
        if (c < D) orow[c] = acc[i][j] / ls;
      }
      if (cg == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + row] = m[i] + logf(ls);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Sq, int Skv, int H, int KVH,
               int causal, int window, int kv_lim, int q_offset, float scale,
               cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(D);
  auto kern = flash_fwd_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + F32_BQ - 1) / F32_BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv,
      H, KVH, causal, window, kv_lim, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           void* out, float* lse, int B, int Sq, int Skv, int H, int KVH,
           int causal, int window, int kv_lim, int q_offset, float scale,
           cudaStream_t s) {
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, out, lse, B, Sq, Skv, H, KVH, causal,
                           window, kv_lim, q_offset, scale, s);
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, lse, B, Sq, Skv, H, KVH, causal,
                         window, kv_lim, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q and out (B, Sq, H, D), k and v
// (B, Skv, KVH, D), lse (B, H, Sq) float32, all contiguous and, for
// bfloat16, 16-byte aligned (TMA).  window <= 0 means none; keys at or
// past kv_lim are masked; q_offset is the absolute position of q row 0.
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
  switch (D) {
    case 16:
      return launch<16>(dtype, q, k, v, out, l, B, Sq, Skv, H, KVH, causal,
                        window, kv_lim, q_offset, scale, s);
    case 32:
      return launch<32>(dtype, q, k, v, out, l, B, Sq, Skv, H, KVH, causal,
                        window, kv_lim, q_offset, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, out, l, B, Sq, Skv, H, KVH, causal,
                        window, kv_lim, q_offset, scale, s);
    case 80:
      return launch<80>(dtype, q, k, v, out, l, B, Sq, Skv, H, KVH, causal,
                        window, kv_lim, q_offset, scale, s);
    case 112:
      return launch<112>(dtype, q, k, v, out, l, B, Sq, Skv, H, KVH, causal,
                         window, kv_lim, q_offset, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, out, l, B, Sq, Skv, H, KVH, causal,
                         window, kv_lim, q_offset, scale, s);
    case 256:
      return launch<256>(dtype, q, k, v, out, l, B, Sq, Skv, H, KVH, causal,
                         window, kv_lim, q_offset, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
