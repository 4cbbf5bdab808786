// The resident image's epilogue for Hopper (sm_90a): one launch over a
// table's [P, B] image after its static mask.
//
// Replaces the JAX package's XLA program
// pegasus_tpu/parallel/mesh_resident.py:119 `_mesh_step`, whose first half
// (the static keep mask over the flattened [P * B] image with a per-row
// pidx and the resident hash_lo) is one launch of the scan kernel's static
// contract (csrc/scan_predicate.cu); this kernel is the rest. Per slot p
// (one partition) and row b, all uint32 arithmetic:
//   static     = bit b of the packed static mask & allowed[p]
//   alive      = !(0 < expire_ts <= now)
//   considered = static && alive        (survivors before the value filter)
//   live       = considered && extra    (extra: the value-filter mask)
// It writes the gated static mask, packed as jnp.packbits packs it
// (big-endian within each byte, B / 8 bytes a slot), and per slot
//   counts[p]    = (sum live, sum considered, sum present && !alive)
//   lane_sums[p] = sum over live rows of lanes[p, b, 0..3], uint32,
//                  wrapping mod 2^32 as XLA's uint32 sum does
// (lane_sums only with kWithSum; zero otherwise). The counts are
// per-block sums added with integer atomics, so the result does not
// depend on the blocks' order.
//
// Bound on an H100 SXM (3.35 TB/s HBM): memory. A row reads 1/8 B of
// static mask, 4 B of expire_ts, 1 B of present and 1 B of extra, and
// writes 1/8 B: 6.25 B a row, 22.25 B with the four 4-byte value lanes.
// At P = 64, B = 16384 (2^20 rows) that is about 2.0 us, 7.0 us with
// lanes. The counts and sums are P * 28 B.
//
// Design: a thread takes one packed byte, i.e. 8 consecutive rows: its
// expire_ts as two 16-byte loads, present and extra as one 8-byte load
// each, and (with lanes) 8 16-byte loads, so a warp reads whole
// contiguous lines. Each thread sums its rows in registers; the block
// reduces by warp shuffles and one shared-memory pass, and one thread
// adds the block's sums to its slot with atomics. The grid is
// (tiles of a slot's bytes, P): a block never straddles two slots. The
// output counts are zeroed on the stream before the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  }
  return v;
}

template <bool kWithSum>
__global__ void __launch_bounds__(kThreads)
    mesh_step_kernel(const uint8_t* __restrict__ packed,
                     const uint8_t* __restrict__ allowed,
                     const uint32_t* __restrict__ expire_ts,
                     const uint8_t* __restrict__ present,
                     const uint8_t* __restrict__ extra,
                     const uint4* __restrict__ lanes, uint32_t now,
                     int64_t slot_bytes, uint8_t* __restrict__ out,
                     int32_t* __restrict__ counts,
                     uint32_t* __restrict__ lane_sums) {
  const int p = blockIdx.y;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // per thread: live, considered, present-and-expired, four lane sums
  int c_live = 0, c_cons = 0, c_exp = 0;
  uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  if (j < slot_bytes) {
    const int64_t byte = static_cast<int64_t>(p) * slot_bytes + j;
    const int64_t row0 = byte * 8;
    const uint8_t st = allowed[p] ? packed[byte] : 0;
    out[byte] = st;
    const uint4 e0 = reinterpret_cast<const uint4*>(expire_ts + row0)[0];
    const uint4 e1 = reinterpret_cast<const uint4*>(expire_ts + row0)[1];
    const uint2 pr = *reinterpret_cast<const uint2*>(present + row0);
    const uint2 ex = *reinterpret_cast<const uint2*>(extra + row0);
    const uint32_t ets[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const uint32_t word_pr = m < 4 ? pr.x : pr.y;
      const uint32_t word_ex = m < 4 ? ex.x : ex.y;
      const int shift = 8 * (m & 3);
      const bool is_present = (word_pr >> shift) & 0xFF;
      const bool is_extra = (word_ex >> shift) & 0xFF;
      const bool is_static = (st >> (7 - m)) & 1;
      const bool alive = !(ets[m] > 0 && ets[m] <= now);
      const bool cons = is_static && alive;
      const bool live = cons && is_extra;
      c_cons += cons;
      c_live += live;
      c_exp += is_present && !alive;
      if (kWithSum) {
        const uint4 l = lanes[row0 + m];
        const uint32_t w = live ? 0xFFFFFFFFu : 0u;
        s0 += l.x & w;
        s1 += l.y & w;
        s2 += l.z & w;
        s3 += l.w & w;
      }
    }
  }
  c_live = warp_sum(c_live);
  c_cons = warp_sum(c_cons);
  c_exp = warp_sum(c_exp);
  if (kWithSum) {
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    s3 = warp_sum(s3);
  }
  __shared__ uint32_t part[kWarps][7];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[warp][0] = c_live;
    part[warp][1] = c_cons;
    part[warp][2] = c_exp;
    part[warp][3] = s0;
    part[warp][4] = s1;
    part[warp][5] = s2;
    part[warp][6] = s3;
  }
  __syncthreads();
  if (threadIdx.x < 7 && (kWithSum || threadIdx.x < 3)) {
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[w][threadIdx.x];
    if (total != 0) {
      if (threadIdx.x < 3) {
        atomicAdd(counts + 3 * p + threadIdx.x, static_cast<int32_t>(total));
      } else {
        atomicAdd(lane_sums + 4 * p + (threadIdx.x - 3), total);
      }
    }
  }
}

}  // namespace

// Launches the epilogue over a [p, b] image on `stream` and returns
// cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take. Device
// pointers: packed uint8[p, b / 8] (the static mask), allowed uint8[p],
// expire_ts uint32[p, b] (16-byte aligned), present and extra
// uint8[p, b] (8-byte aligned), lanes uint32[p, b, 4] (16-byte aligned;
// read only with with_sum), out uint8[p, b / 8], counts int32[p, 3],
// lane_sums uint32[p, 4]. b is a multiple of 8; counts and lane_sums are
// zeroed on the stream first.
extern "C" int pegasus_mesh_step(const uint8_t* packed, const uint8_t* allowed,
                                 const uint32_t* expire_ts,
                                 const uint8_t* present, const uint8_t* extra,
                                 const uint32_t* lanes, uint32_t now, int p,
                                 int64_t b, int with_sum, uint8_t* out,
                                 int32_t* counts, uint32_t* lane_sums,
                                 void* stream) {
  if (p < 0 || p > 65535 || b < 8 || (b & 7) || (with_sum && !lanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (p == 0) return 0;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * 3 * p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(lane_sums, 0, sizeof(uint32_t) * 4 * p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slot_bytes = b / 8;
  const int64_t tiles = (slot_bytes + kThreads - 1) / kThreads;
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(p));
  const auto* l4 = reinterpret_cast<const uint4*>(lanes);
  if (with_sum) {
    mesh_step_kernel<true><<<grid, kThreads, 0, s>>>(
        packed, allowed, expire_ts, present, extra, l4, now, slot_bytes, out,
        counts, lane_sums);
  } else {
    mesh_step_kernel<false><<<grid, kThreads, 0, s>>>(
        packed, allowed, expire_ts, present, extra, l4, now, slot_bytes, out,
        counts, lane_sums);
  }
  return static_cast<int>(cudaGetLastError());
}
