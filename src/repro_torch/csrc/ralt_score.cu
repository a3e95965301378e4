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
// Two entry points:
//
// ralt_update: the TPU kernel's function as it stands (fresh outputs, a
// dense hit array).  What bounds it: bytes.  A unit reads 9 B (tick,
// score, hit) and writes 9 B (tick', score', hot); its ~20 flops are far
// below the ~20 flop/B (float32, outside the tensor cores) at which the
// card would stop being memory bound.  Design: one flat grid-stride pass
// over N.  When every pointer is aligned, a thread takes four units at a
// time with 16-byte loads and stores of ticks and scores and 4-byte ones
// of the hit and hot bytes; a scalar loop takes the tail.  The TPU's
// (rows, 128)-lane layout and its block_rows search are gone.  `now` and
// `threshold` are read from device memory (the analogue of scalar
// prefetch), so the caller never waits for the host.
//
// ralt_record: one whole tracker record (repro/tiering/hotness.py:71-102,
// which XLA compiles into one program around the Pallas call) in one
// launch, in place.  The step's scalars (time-slice clock and R-byte
// remainder) come from a two-slot clock buffer: every block reads slot
// `cur` and recomputes them from the number of distinct units hit, and
// block 0 writes the new values to the other slot, so no block ever reads
// a scalar another block has already overwritten.  Per unit: the RALT
// update, then Algorithm 1's counter c, tag t and seen bit, with no hot
// output (the tracker has no use for it).  Hits arrive as sorted distinct
// unit ids, by value in the launch's parameters when they are few (the
// tiered KV cache records one page a read: no copy, no allocation) or in
// device memory; each block stages them in shared memory and a group of
// four units finds its first candidate by binary search.  What bounds
// it: bytes, 28 a unit (tick, score, c, t, seen, read and written); at
// the KV cache's 65,536 pages that is 1.8 MB, less than one wave, so the
// launch itself is most of its cost.
//
// exp is the Cephes single-precision polynomial with fused multiply-adds
// and flush-to-zero of the result, and score * decay + hit is one fused
// multiply-add: the sequence the reference's XLA CPU backend evaluates.
// Every other product and sum is rounded on its own (__fmul_rn /
// __fadd_rn), so the compiler cannot contract differently; the R-byte
// remainder accr - dec * R is the one other fused multiply-add, as XLA
// contracts it.  Kernel, plain PyTorch version (kernels/ralt_score.py,
// tiering/hotness.py) and reference then agree bit for bit.
#include <cfloat>
#include <cstring>
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

// ---------------------------------------------------------------------
// ralt_record
// ---------------------------------------------------------------------
constexpr int kParamIds = 896;   // ids passed by value (3.5 KB of params)
constexpr int kSmemIds = 4096;   // ids staged in shared memory (16 KB)

struct RecordParams {
  int* tick;
  float* score;
  float* c;
  unsigned char* t;
  unsigned char* seen;
  float* clock;          // (2, 4): now (int bits), acc, acc_r, unused
  const int* dev_ids;    // device ids, or null: the ids below
  long long n;
  int cur;               // the clock slot to read; 1 - cur is written
  int n_ids;             // distinct units hit
  int vec;
  float unit_bytes, every, r_bytes, delta_c, c_max, log_alpha;
  int ids[kParamIds];
};

// PyTorch's c10::div_floor_floating (torch.floor_divide on float32):
// fmod, then subtract, divide, floor and round by half.  floorf(a / b)
// differs at exact multiples, which byte counts hit.
__device__ __forceinline__ float div_floor(float a, float b) {
  if (b == 0.0f) return __fdiv_rn(a, b);
  const float mod = fmodf(a, b);
  float div = __fdiv_rn(__fsub_rn(a, mod), b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div = __fsub_rn(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, __fdiv_rn(a, b));
  float fd = floorf(div);
  if (__fsub_rn(div, fd) > 0.5f) fd = __fadd_rn(fd, 1.0f);
  return fd;
}

// One record's scalars (tiering/hotness.py:record_accesses).
struct Step {
  int now;
  float acc, accr, dec;

  __device__ Step(const RecordParams& p) {
    const float* old = p.clock + 4 * p.cur;
    const float batch = __fmul_rn(static_cast<float>(p.n_ids), p.unit_bytes);
    acc = __fadd_rn(old[1], batch);
    const int adv = static_cast<int>(div_floor(acc, p.every));
    now = static_cast<int>(static_cast<unsigned>(__float_as_int(old[0])) +
                           static_cast<unsigned>(adv));
    acc = __fsub_rn(acc, __fmul_rn(static_cast<float>(adv), p.every));
    accr = __fadd_rn(old[2], batch);
    dec = div_floor(accr, p.r_bytes);
    accr = fmaf(-dec, p.r_bytes, accr);
  }
};

struct Counters {
  float dec, delta_c, c_max;

  // Algorithm 1: c += delta_c on a hit (capped), the tag on a repeat
  // hit, then the R-byte decrement and the tag cleared where c is 0.
  __device__ __forceinline__ void operator()(signed char hit, float& c,
                                             unsigned char& t,
                                             unsigned char& seen) const {
    float cc = hit ? fminf(__fadd_rn(c, delta_c), c_max) : c;
    unsigned char tt = t | (hit & seen);
    seen = seen | hit;
    cc = fmaxf(__fsub_rn(cc, dec), 0.0f);
    c = cc;
    t = tt & (cc > 0.0f ? 1 : 0);
  }
};

__device__ __forceinline__ int lower_bound(const int* ids, int n,
                                           long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) ralt_record_kernel(
    const __grid_constant__ RecordParams p) {
  __shared__ int s_ids[kSmemIds];
  const int n_ids = p.n_ids;
  const int* ids = p.dev_ids;
  if (n_ids <= kSmemIds) {
    const int* src = p.dev_ids ? p.dev_ids : p.ids;
    for (int i = threadIdx.x; i < n_ids; i += blockDim.x) s_ids[i] = src[i];
    __syncthreads();
    ids = s_ids;
  }
  const Step st(p);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float* nxt = p.clock + 4 * (1 - p.cur);
    nxt[0] = __int_as_float(st.now);
    nxt[1] = st.acc;
    nxt[2] = st.accr;
  }
  const Unit unit{st.now, 0.0f, p.log_alpha};
  const Counters count{st.dec, p.delta_c, p.c_max};
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n = p.n;
  const long long n4 = p.vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const long long u = 4 * i;
    int pos = lower_bound(ids, n_ids, u);
    signed char h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = (pos < n_ids && ids[pos] == u + j) ? 1 : 0;
      pos += h[j];
    }
    int4 tk = reinterpret_cast<const int4*>(p.tick)[i];
    float4 sc = reinterpret_cast<const float4*>(p.score)[i];
    float4 cc = reinterpret_cast<const float4*>(p.c)[i];
    uchar4 tt = reinterpret_cast<const uchar4*>(p.t)[i];
    uchar4 sn = reinterpret_cast<const uchar4*>(p.seen)[i];
    signed char hot;
    unit(tk.x, sc.x, h[0], tk.x, sc.x, hot);
    unit(tk.y, sc.y, h[1], tk.y, sc.y, hot);
    unit(tk.z, sc.z, h[2], tk.z, sc.z, hot);
    unit(tk.w, sc.w, h[3], tk.w, sc.w, hot);
    count(h[0], cc.x, tt.x, sn.x);
    count(h[1], cc.y, tt.y, sn.y);
    count(h[2], cc.z, tt.z, sn.z);
    count(h[3], cc.w, tt.w, sn.w);
    reinterpret_cast<int4*>(p.tick)[i] = tk;
    reinterpret_cast<float4*>(p.score)[i] = sc;
    reinterpret_cast<float4*>(p.c)[i] = cc;
    reinterpret_cast<uchar4*>(p.t)[i] = tt;
    reinterpret_cast<uchar4*>(p.seen)[i] = sn;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    const int pos = lower_bound(ids, n_ids, i);
    const signed char hit = (pos < n_ids && ids[pos] == i) ? 1 : 0;
    int tk = p.tick[i];
    float sc = p.score[i];
    signed char hot;
    unit(tk, sc, hit, tk, sc, hot);
    p.tick[i] = tk;
    p.score[i] = sc;
    count(hit, p.c[i], p.t[i], p.seen[i]);
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

extern "C" int ralt_record_param_ids() { return kParamIds; }

// One tracker record in place.  `host_ids` (n_ids <= kParamIds) are
// copied into the launch's parameters unless `dev_ids` is given; either
// holds the sorted distinct ids of the units hit.
extern "C" int ralt_record(void* tick, void* score, void* c, void* t,
                           void* seen, void* clock, int cur, long long n,
                           const int* host_ids, const void* dev_ids,
                           int n_ids, float unit_bytes, float every,
                           float r_bytes, float delta_c, float c_max,
                           float log_alpha, int vec, void* stream) {
  if (n_ids < 0 || (dev_ids == nullptr && n_ids > kParamIds) ||
      (cur != 0 && cur != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RecordParams p;
  p.tick = static_cast<int*>(tick);
  p.score = static_cast<float*>(score);
  p.c = static_cast<float*>(c);
  p.t = static_cast<unsigned char*>(t);
  p.seen = static_cast<unsigned char*>(seen);
  p.clock = static_cast<float*>(clock);
  p.dev_ids = static_cast<const int*>(dev_ids);
  p.n = n;
  p.cur = cur;
  p.n_ids = n_ids;
  p.vec = vec;
  p.unit_bytes = unit_bytes;
  p.every = every;
  p.r_bytes = r_bytes;
  p.delta_c = delta_c;
  p.c_max = c_max;
  p.log_alpha = log_alpha;
  if (dev_ids == nullptr && n_ids > 0) {
    memcpy(p.ids, host_ids, sizeof(int) * n_ids);
  }
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;                // block 0 writes the clock
  ralt_record_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
