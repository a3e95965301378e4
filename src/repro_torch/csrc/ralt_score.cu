// RALT exponential-smoothing score update, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ralt_score.py:_ralt_kernel
// (pl.pallas_call at ralt_score.py:78), which the reference's tracker
// reaches from repro/tiering/hotness.py:81 through kernels/ops.py.
// For every tracked unit i:
//   score'[i] = exp(ln(alpha) * (now - tick[i])) * score[i] + hit[i]
//   tick'[i]  = now
//   hot[i]    = score'[i] >= threshold
//
// What bounds it: bytes.  A unit reads 9 B (tick, score, hit) and writes
// 9 B (tick', score', hot); its ~20 flops are far below the ~20 flop/B
// (float32, outside the tensor cores) at which the card would stop being
// memory bound.  Design: one flat grid-stride pass over N.  When every
// pointer is aligned, a thread takes four units at a time with 16-byte
// loads and stores of ticks and scores and 4-byte ones of the hit and hot
// bytes; a scalar loop takes the tail.  The TPU's (rows, 128)-lane layout
// and its block_rows search are gone.  `now` and `threshold` are read from
// device memory (the analogue of scalar prefetch), so the caller never
// waits for the host.
//
// exp is the Cephes single-precision polynomial with fused multiply-adds
// and flush-to-zero of the result, and score * decay + hit is one fused
// multiply-add: the sequence the reference's XLA CPU backend evaluates.
// Every other product and sum is rounded on its own (__fmul_rn /
// __fadd_rn), so the compiler cannot contract differently.  Kernel, plain
// PyTorch version (kernels/ralt_score.py) and reference then agree bit for
// bit.
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;
}

__device__ __forceinline__ float exp_cephes(float x) {
  x = fminf(fmaxf(x, -87.8f), 88.8f);
  float n = floorf(fmaf(x, 1.44269504088896341f, 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float r = fmaf(n, -0.693359375f, x);
  r = fmaf(n, 2.12194440e-4f, r);
  const float z = __fmul_rn(r, r);
  float y = fmaf(r, 1.9875691500e-4f, 1.3981999507e-3f);
  y = fmaf(y, r, 8.3334519073e-3f);
  y = fmaf(y, r, 4.1665795894e-2f);
  y = fmaf(y, r, 1.6666665459e-1f);
  y = fmaf(y, r, 5.0000001201e-1f);
  y = fmaf(y, z, r);
  y = __fadd_rn(1.0f, y);
  return ftz(ldexpf(y, static_cast<int>(n)));
}

struct Unit {
  int now;
  float thr;
  float log_alpha;

  __device__ __forceinline__ void operator()(int tick, float score,
                                             signed char hit, int& o_tick,
                                             float& o_score,
                                             signed char& o_hot) const {
    const float dt = static_cast<float>(now - tick);
    const float decay = exp_cephes(__fmul_rn(log_alpha, dt));
    const float s = ftz(fmaf(score, decay, static_cast<float>(hit)));
    o_tick = now;
    o_score = s;
    o_hot = s >= thr ? 1 : 0;
  }
};

__global__ void __launch_bounds__(kThreads) ralt_kernel(
    const int* __restrict__ ticks, const float* __restrict__ scores,
    const signed char* __restrict__ hits, const int* __restrict__ now_p,
    const float* __restrict__ thr_p, int* __restrict__ o_ticks,
    float* __restrict__ o_scores, signed char* __restrict__ o_hot,
    long long n, float log_alpha, int vec) {
  const Unit unit{*now_p, *thr_p, log_alpha};
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const int4 t = reinterpret_cast<const int4*>(ticks)[i];
    const float4 s = reinterpret_cast<const float4*>(scores)[i];
    const char4 h = reinterpret_cast<const char4*>(hits)[i];
    int4 ot;
    float4 os;
    char4 oh;
    unit(t.x, s.x, h.x, ot.x, os.x, oh.x);
    unit(t.y, s.y, h.y, ot.y, os.y, oh.y);
    unit(t.z, s.z, h.z, ot.z, os.z, oh.z);
    unit(t.w, s.w, h.w, ot.w, os.w, oh.w);
    reinterpret_cast<int4*>(o_ticks)[i] = ot;
    reinterpret_cast<float4*>(o_scores)[i] = os;
    reinterpret_cast<char4*>(o_hot)[i] = oh;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    unit(ticks[i], scores[i], hits[i], o_ticks[i], o_scores[i], o_hot[i]);
  }
}

}  // namespace

extern "C" int ralt_update(const void* ticks, const void* scores,
                           const void* hits, const void* now,
                           const void* thr, void* o_ticks, void* o_scores,
                           void* o_hot, long long n, float log_alpha,
                           int vec, void* stream) {
  if (n > 0) {
    const long long work = vec ? (n + 3) / 4 : n;
    long long blocks = (work + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
    ralt_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ticks), static_cast<const float*>(scores),
        static_cast<const signed char*>(hits), static_cast<const int*>(now),
        static_cast<const float*>(thr), static_cast<int*>(o_ticks),
        static_cast<float*>(o_scores), static_cast<signed char*>(o_hot), n,
        log_alpha, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
