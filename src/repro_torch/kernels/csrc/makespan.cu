// Population makespan: the BW-allocator event simulation (Algorithm 1 of
// the MAGMA paper) for every individual of a population.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/makespan.py::_makespan_kernel (wrapper makespan_pallas).
// Its plain PyTorch version is repro_torch.core.bw_allocator.simulate_tables.
//
// Layout: qlat, qbw are (P, A, G) f32 per-queue-slot tables (row-major),
// count is (P, A) i32, bw_sys is one f32 in device memory (so that a
// caller holding it on the card never syncs), out is (P,) f32.  A group of
// W lanes (W = the power of two >= A, A <= 32 checked by the wrapper)
// simulates one individual, 32 / W individuals a warp, one warp a block;
// lane a holds sub-accelerator a's remaining bytes, queue pointer and
// count.  Each of the G events:
//   1. sums the live BW requests over the group (xor-butterfly shuffle);
//   2. throttles them by min(1, bw_sys / total);
//   3. takes dt = min(rem / alloc) over the group, the ties going to the
//      lower lane (jnp.argmin's first-index rule): a butterfly min of the
//      values' bits (every value is >= 0, so the bit order is the numeric
//      order; the sign bit is dropped so that -0 ties +0) and a ballot for
//      the lowest lane holding it;
//   4. drains rem by dt * alloc and advances the finishing lane's queue.
// Lanes >= A, and queues past their count, are inactive: they request 0 BW
// and report runtime _INF.  When no lane is active dt is 0 and no queue
// advances, as in the Pallas kernel.
//
// What bounds it on this card: a chain of G dependent events per
// individual, each two reductions over the group and two IEEE divisions
// long, far above its bytes bound (the 2*P*G*4 bytes of the queue slots it
// reads, an individual's counts summing to G, plus the counts).  So the
// design shortens the chain:
// - the group is as wide as A needs, not a warp: log2(W) butterfly levels
//   (3 at A = 8, not 5), and the argmin is a butterfly of one shuffle a
//   level and one ballot, in place of a 5-level butterfly of two shuffles
//   each.  Every shuffle and vote names the whole warp (the groups of a
//   warp run the same G events in step; a group past P idles with empty
//   queues): a mask per group would have the warp run its groups one
//   after another;
// - an individual's live queue slots (its counts' worth, 2*G floats when
//   they sum to G) are staged in shared memory by cp.async before the
//   first event, packed queue after queue, and every lane reads its next
//   slot one event ahead into registers: no memory access lies on the
//   chain.  Shared memory is sized by G (32 / W individuals a block; the
//   group is widened until they fit in 48 KB, G = 1000 at A = 8 takes
//   32 KB); a queue that does not fit is read from device memory through
//   the same read-ahead.
//
// Bitwise: lanes beyond A add exactly +0 to the butterfly, and the argmin
// with the lowest-index tie rule has one answer, so the result does not
// depend on W: it is the one warp-wide kernel's bit for bit.  An
// individual reads only its own rows and its group's lanes, so its
// makespan does not depend on P or on where it sits in the launch.  The
// products and differences use __fmul_rn / __fsub_rn so that nvcc does not
// contract them into FMAs: the elementwise arithmetic then rounds exactly
// as the plain PyTorch version does; only the order of the A-way sum
// differs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTiny = 1e-30f;   // _TINY in makespan.py
constexpr float kInf = 3e38f;     // _INF in makespan.py
constexpr int kSmemBudget = 48 * 1024;   // bytes of staged slots a block

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src));
}

template <int W>
__global__ void __launch_bounds__(32)
makespan_kernel(const float* __restrict__ qlat, const float* __restrict__ qbw,
                const int32_t* __restrict__ count,
                const float* __restrict__ bw_sys_ptr,
                float* __restrict__ out, int P, int A, int G, int cap) {
  extern __shared__ float staged_slots[];
  constexpr int kPerWarp = 32 / W;
  const int lane = threadIdx.x & 31;
  const int grp = lane / W;      // the individual's place in the warp
  const int gl = lane % W;       // the sub-accelerator
  const int p = blockIdx.x * kPerWarp + grp;
  constexpr unsigned kAll = 0xffffffffu;
  const int shift = grp * W;     // the group's bits in a ballot
  const unsigned own = W == 32 ? kAll : (1u << W) - 1u;

  const bool lane_ok = p < P && gl < A;
  const int cnt = lane_ok ? count[static_cast<size_t>(p) * A + gl] : 0;
  // the queues' places in the staged slots: an exclusive prefix sum
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, o, W);
    if (gl >= o) incl += v;
  }
  const int off = incl - cnt;
  float* s_lat = staged_slots + grp * 2 * cap;
  float* s_bw = s_lat + cap;
  for (int a = 0; a < A; ++a) {
    const int ca = __shfl_sync(kAll, cnt, a, W);
    const int oa = __shfl_sync(kAll, off, a, W);
    if (oa + ca > cap) continue;
    const size_t row = (static_cast<size_t>(p) * A + a) * G;
    for (int j = gl; j < ca; j += W) {
      cp_async4(s_lat + oa + j, qlat + row + j);
      cp_async4(s_bw + oa + j, qbw + row + j);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  const bool staged = off + cnt <= cap;
  const size_t row = (static_cast<size_t>(p) * A + (lane_ok ? gl : 0)) * G;
  const float* lat = staged ? s_lat + off : qlat + row;
  const float* bw = staged ? s_bw + off : qbw + row;
  const float bw_sys = *bw_sys_ptr;

  // this slot's request and bytes, and the next slot's latency and
  // request, read ahead (by loads that nothing in the event waits for:
  // the next advance uses them)
  int ptr = 0;
  float req = cnt > 0 ? bw[0] : 0.0f;
  float rem = cnt > 0 ? __fmul_rn(lat[0], bw[0]) : 0.0f;
  float next_lat = 0.0f, next_bw = 0.0f;
  if (cnt > 1) {
    next_lat = lat[1];
    next_bw = bw[1];
  }
  float t = 0.0f;

  for (int step = 0; step < G; ++step) {
    const bool active = ptr < cnt;
    const bool any_active = ((__ballot_sync(kAll, active) >> shift) & own)
                            != 0;
    float total = req;
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      total += __shfl_xor_sync(kAll, total, o, W);
    }
    const float scale = fminf(1.0f, __fdiv_rn(bw_sys, fmaxf(total, kTiny)));
    const float alloc = __fmul_rn(req, scale);
    const float low = active ? __fdiv_rn(rem, fmaxf(alloc, kTiny)) : kInf;
    const unsigned key = __float_as_uint(low) & 0x7fffffffu;
    unsigned least = key;
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
      least = min(least, __shfl_xor_sync(kAll, least, o, W));
    }
    const unsigned holders = (__ballot_sync(kAll, key == least) >> shift)
                             & own;
    const int fin = __ffs(holders) - 1;
    const float dt = any_active ? __uint_as_float(least) : 0.0f;
    rem = fmaxf(__fsub_rn(rem, __fmul_rn(dt, alloc)), 0.0f);
    if (any_active && gl == fin) {
      ++ptr;
      const bool live = ptr < cnt;
      rem = live ? __fmul_rn(next_lat, next_bw) : 0.0f;
      req = live ? next_bw : 0.0f;
      if (ptr + 1 < cnt) {
        next_lat = lat[ptr + 1];
        next_bw = bw[ptr + 1];
      }
    }
    t = __fadd_rn(t, dt);
  }
  if (gl == 0 && p < P) out[p] = t;
}

template <int W>
cudaError_t launch(const float* qlat, const float* qbw, const int32_t* count,
                   const float* bw_sys, float* out, int P, int A, int G,
                   cudaStream_t stream) {
  constexpr int kPerWarp = 32 / W;
  const int cap = G < kSmemBudget / (kPerWarp * 8)
                      ? G : kSmemBudget / (kPerWarp * 8);
  const size_t smem = sizeof(float) * 2 * cap * kPerWarp;
  const int blocks = (P + kPerWarp - 1) / kPerWarp;
  makespan_kernel<W><<<blocks, 32, smem, stream>>>(qlat, qbw, count, bw_sys,
                                                   out, P, A, G, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int makespan_launch(const float* qlat, const float* qbw,
                               const int32_t* count, const float* bw_sys,
                               float* out,
                               int P, int A, int G, void* stream) {
  if (A < 1 || A > 32 || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the narrowest group that holds A lanes, widened until a block's
  // staged slots fit in the budget
  int w = 1;
  while (w < A) w <<= 1;
  while (w < 32 && (32 / w) * 8 * static_cast<long long>(G) > kSmemBudget) {
    w <<= 1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: return launch<1>(qlat, qbw, count, bw_sys, out, P, A, G, s);
    case 2: return launch<2>(qlat, qbw, count, bw_sys, out, P, A, G, s);
    case 4: return launch<4>(qlat, qbw, count, bw_sys, out, P, A, G, s);
    case 8: return launch<8>(qlat, qbw, count, bw_sys, out, P, A, G, s);
    case 16: return launch<16>(qlat, qbw, count, bw_sys, out, P, A, G, s);
    default: return launch<32>(qlat, qbw, count, bw_sys, out, P, A, G, s);
  }
}

extern "C" const char* makespan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
