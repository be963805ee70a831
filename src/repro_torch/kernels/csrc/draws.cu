// Counter-based random draws: every random tensor of a MAGMA generation,
// for every row, in one launch.
//
// Replaces no TPU kernel: the reference draws a generation's twelve
// tensors with jax.random inside its one compiled program
// (src/repro/core/magma.py::_next_generation_body), where XLA fuses them.
// The port drew them row by row from torch.Generators, one launch a row
// and draw (576 CUDA-graph nodes a generation at 48 rows), and node
// latency, not the numbers, took most of a sweep's time.  Its plain
// PyTorch version is repro_torch.kernels.draws.draws_plain.
//
// The stream: Philox4x32-10 (Salmon et al., SC'11).  Element e of slot s
// of row r is word e % 4 of the block at counter (e / 4, s, ctr[r] low
// 32 bits, ctr[r] high 32 bits) under key (key[r][0], key[r][1]), so a
// row's draws do not depend on R or on the other rows.  A word u becomes
// a float (u >> 8) * 2^-24 in [0, 1), an int lo + umulhi(u, hi - lo) in
// [lo, hi) (multiply-shift: a value's share is off by less than
// (hi - lo) / 2^32), or a bool u < 2^31.
//
// Layout: `slots` lists up to kMaxSlots outputs, each R rows of `numel`
// values, row-major: a float32, int32 or bool (one byte) tensor.  A row's
// Philox blocks are numbered across its slots (slot s's first is
// first_block), so thread t draws block t % blocks_per_row of row
// t / blocks_per_row: one thread a block, the four words stored together
// (one 16-byte store for a float or int slot, one 4-byte store for a
// bool slot, where the address is aligned and the block is whole;
// neighbouring threads on neighbouring blocks, so the stores coalesce).
// key (R, 2) and ctr (R,) are int64 in device memory: a CUDA graph that
// captured the launch draws whatever counter its replay finds.  The
// thread of a row's first block also writes the row's next counter,
// ctr[r] + 1, into ctr_next (its own buffer: no thread reads it), so the
// generation's counter advance is no launch of its own.
//
// What bounds it on this card: bytes.  The work is 10 rounds of two
// 32-bit multiplies a block, far below what the SMs issue in the time the
// outputs take to write: at R = 48, n = 90 children, G = 100 it writes
// 7.04 MB (four (R, n, G) 4-byte slots and eight (R, n) ones), 2.1 us at
// 3.35 TB/s.  One launch replaces 12 R launches of torch.rand /
// torch.randint of at most 9,000 values each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 16;   // draws.MAX_SLOTS
constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

}  // namespace

// the table the wrapper fills (draws._SlotC / draws._SlotsC)
struct DrawSlot {
  void* out;
  long long numel;         // values a row
  long long first_block;   // the row's first Philox block of this slot
  int kind;                // 0 float32, 1 int32, 2 bool
  int lo;                  // int: the range's low end
  unsigned span;           // int: hi - lo
};

struct DrawSlots {
  DrawSlot slot[kMaxSlots];
  int count;
  long long blocks_per_row;
};

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_float(uint32_t u) {
  return static_cast<float>(u >> 8) * 5.9604644775390625e-08f;   // 2^-24
}

__device__ __forceinline__ int to_int(uint32_t u, int lo, unsigned span) {
  return lo + static_cast<int>(__umulhi(u, span));
}

__global__ void __launch_bounds__(kThreads)
draws_kernel(const long long* __restrict__ key,
             const long long* __restrict__ ctr,
             long long* __restrict__ ctr_next, const DrawSlots slots,
             int R) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (t >= static_cast<long long>(R) * slots.blocks_per_row) return;
  const int r = static_cast<int>(t / slots.blocks_per_row);
  const long long j = t - static_cast<long long>(r) * slots.blocks_per_row;
  // the slot holding block j: constant indices only, so the table is read
  // from the parameter bank and never copied to local memory
  int s = 0;
  DrawSlot sl = slots.slot[0];
#pragma unroll
  for (int i = 1; i < kMaxSlots; ++i) {
    if (i < slots.count && j >= slots.slot[i].first_block) {
      s = i;
      sl = slots.slot[i];
    }
  }
  const long long b = j - sl.first_block;
  const long long now = ctr[r];
  if (j == 0) ctr_next[r] = now + 1;
  const unsigned long long g = static_cast<unsigned long long>(now);
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(b), static_cast<uint32_t>(s),
                 static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32)),
      static_cast<uint32_t>(key[2 * r]),
      static_cast<uint32_t>(key[2 * r + 1]));
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  const long long e = 4 * b;                            // first element
  const long long at = static_cast<long long>(r) * sl.numel + e;
  const bool whole = e + 4 <= sl.numel;
  if (sl.kind == 0) {
    float* out = static_cast<float*>(sl.out) + at;
    if (whole && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      *reinterpret_cast<float4*>(out) = make_float4(
          to_float(u[0]), to_float(u[1]), to_float(u[2]), to_float(u[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e + q < sl.numel) out[q] = to_float(u[q]);
      }
    }
  } else if (sl.kind == 1) {
    int* out = static_cast<int*>(sl.out) + at;
    if (whole && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      *reinterpret_cast<int4*>(out) = make_int4(
          to_int(u[0], sl.lo, sl.span), to_int(u[1], sl.lo, sl.span),
          to_int(u[2], sl.lo, sl.span), to_int(u[3], sl.lo, sl.span));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e + q < sl.numel) out[q] = to_int(u[q], sl.lo, sl.span);
      }
    }
  } else {
    unsigned char* out = static_cast<unsigned char*>(sl.out) + at;
    if (whole && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
      *reinterpret_cast<uchar4*>(out) = make_uchar4(
          u[0] < 0x80000000u, u[1] < 0x80000000u, u[2] < 0x80000000u,
          u[3] < 0x80000000u);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e + q < sl.numel) out[q] = u[q] < 0x80000000u;
      }
    }
  }
}

}  // namespace

extern "C" int draws_launch(const long long* key, const long long* ctr,
                            long long* ctr_next, const DrawSlots* slots,
                            int R, void* stream) {
  if (R < 1 || slots->count < 1 || slots->count > kMaxSlots
      || slots->blocks_per_row < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads =
      static_cast<long long>(R) * slots->blocks_per_row;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  draws_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(key, ctr, ctr_next,
                                                      *slots, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* draws_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
