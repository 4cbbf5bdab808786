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
//   live       = considered && extra    (extra: the value-filter mask; all
//                                        ones in the kExtra-less instance)
// It writes the gated static mask, packed as jnp.packbits packs it
// (big-endian within each byte, B / 8 bytes a slot), and per slot
//   counts[p]    = (sum live, sum considered, sum present && !alive)
//   lane_sums[p] = sum over live rows of lanes[p, b, 0..3], uint32,
//                  wrapping mod 2^32 as XLA's uint32 sum does
// (lane_sums only with kWithSum; zero otherwise). All three go into one
// result buffer that the wrapper allocates (ops/fused_mesh.py), so a round
// brings its results home in one copy; the kernel writes every byte of it,
// so nothing is zeroed before the launch.
//
// Bound on an H100 SXM (3.35 TB/s HBM): memory. A row reads 1/8 B of
// static mask, 4 B of expire_ts, 1 B of present, 1 B of extra (not in the
// wave's instance) and writes 1/8 B: 5.25 B a row, 6.25 B with extra,
// 22.25 B with extra and the four 4-byte value lanes. At P = 64,
// B = 16384 (2^20 rows) that is about 1.64 us, 1.96 us and 6.96 us. The
// counts and sums are P * 28 B.
//
// Design. The blocks of one slot form a thread-block cluster: grid
// (C, P), cluster (C, 1, 1), C = min(8, the blocks the slot needs), 512
// threads a block. A warp takes two tiles of 256 rows at a time (a tile
// is 32 mask bytes, one a lane: a lane "owns" rows 8 lane .. 8 lane + 7
// of it) and the cluster's warps grid-stride over the slot's tiles; every
// load of both tiles is issued before the first is used. The mask is read
// a byte a lane, present and extra 8 bytes a lane, expire_ts as the
// owner's two 16-byte loads (measured faster than 16 contiguous bytes a
// lane with the liveness nibbles shuffled to their owner, PERF.md), and
// with the sum the lanes 16 bytes a lane (instruction m reads row
// 32 m + lane, 512 contiguous bytes; the row's live bit comes from its
// owner by a shuffle). Each warp writes its sums into rank 0's shared
// memory through distributed shared memory; after one cluster barrier
// rank 0's first warp adds them and stores the slot's counts and sums
// with plain stores: no atomics, no memset, and a result that does not
// depend on the blocks' order.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 2;         // 256-row tiles a warp takes at a time
constexpr int kTileRows = 256;    // a tile: one mask byte a lane
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kParts = 7;         // live, considered, expired, 4 lane sums
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

// 8 bool bytes (row m in byte m) -> one byte, row m at bit 7 - m
// (jnp.packbits' order): byte m times 2^k lands at bit 56 + k for
// k = 7 - m, and no two partial products share a bit.
__device__ __forceinline__ uint32_t pack_bools(uint2 v) {
  const unsigned long long x =
      (static_cast<unsigned long long>(v.y) << 32) | v.x;
  return static_cast<uint32_t>((x * 0x8040201008040201ull) >> 56);
}

__device__ __forceinline__ uint32_t is_alive(uint32_t ets, uint32_t now) {
  return ets == 0 || ets > now;
}

// the liveness of 4 consecutive rows, the first at bit 3
__device__ __forceinline__ uint32_t alive_nibble(uint4 e, uint32_t now) {
  return (is_alive(e.x, now) << 3) | (is_alive(e.y, now) << 2) |
         (is_alive(e.z, now) << 1) | is_alive(e.w, now);
}

template <bool kWithSum, bool kExtra>
__global__ void __launch_bounds__(kThreads)
    mesh_step_kernel(const uint8_t* __restrict__ packed,
                     const uint8_t* __restrict__ allowed,
                     const uint32_t* __restrict__ expire_ts,
                     const uint8_t* __restrict__ present,
                     const uint8_t* __restrict__ extra,
                     const uint4* __restrict__ lanes, uint32_t now, int64_t b,
                     uint8_t* __restrict__ out, int32_t* __restrict__ counts,
                     uint32_t* __restrict__ lane_sums) {
  cg::cluster_group cluster = cg::this_cluster();
  const int p = blockIdx.y;
  const unsigned rank = blockIdx.x;  // the cluster's rank: grid x == C
  const unsigned blocks = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t slot_bytes = b >> 3;
  const int64_t tiles = (slot_bytes + 31) >> 5;
  const int64_t row0 = static_cast<int64_t>(p) * b;  // the slot's first row
  const bool gate = allowed[p] != 0;

  uint32_t c_live = 0, c_cons = 0, c_exp = 0;
  uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  for (int64_t t0 = (static_cast<int64_t>(rank) * kWarps + warp) * kTiles;
       t0 < tiles; t0 += static_cast<int64_t>(blocks) * kWarps * kTiles) {
    // every load of the warp's tiles first
    uint4 ea[kTiles], eb[kTiles];
    uint32_t st[kTiles];
    uint2 pr[kTiles], ex[kTiles];
    uint4 ln[kTiles][kWithSum ? 8 : 1];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const int64_t tr = (t0 + u) * kTileRows;  // the tile's first row
      const int64_t j = (t0 + u) * 32 + lane;   // the mask byte owned
      ea[u] = eb[u] = make_uint4(0, 0, 0, 0);
      st[u] = 0;
      pr[u] = ex[u] = make_uint2(0, 0);
      if (j < slot_bytes) {
        const uint32_t* e = expire_ts + row0 + 8 * j;
        ea[u] = *reinterpret_cast<const uint4*>(e);
        eb[u] = *reinterpret_cast<const uint4*>(e + 4);
        st[u] = packed[static_cast<int64_t>(p) * slot_bytes + j];
        pr[u] = *reinterpret_cast<const uint2*>(present + row0 + 8 * j);
        if (kExtra) {
          ex[u] = *reinterpret_cast<const uint2*>(extra + row0 + 8 * j);
        }
      }
      if (kWithSum) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int64_t r = tr + 32 * m + lane;
          ln[u][m] = r < b ? lanes[row0 + r] : make_uint4(0, 0, 0, 0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const int64_t j = (t0 + u) * 32 + lane;
      const uint32_t alive =
          (alive_nibble(ea[u], now) << 4) | alive_nibble(eb[u], now);
      const uint32_t gated = gate ? st[u] : 0;
      if (j < slot_bytes) {
        out[static_cast<int64_t>(p) * slot_bytes + j] =
            static_cast<uint8_t>(gated);
      }
      const uint32_t cons = gated & alive;
      const uint32_t live = kExtra ? cons & pack_bools(ex[u]) : cons;
      c_cons += __popc(cons);
      c_live += __popc(live);
      c_exp += __popc(pack_bools(pr[u]) & ~alive & 0xFF);
      if (kWithSum) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          // row 32 m + lane of the tile: owner 4 m + lane / 8
          const uint32_t owner =
              __shfl_sync(kFull, live, 4 * m + (lane >> 3));
          const uint32_t w = ((owner >> (7 - (lane & 7))) & 1) ? kFull : 0u;
          s0 += ln[u][m].x & w;
          s1 += ln[u][m].y & w;
          s2 += ln[u][m].z & w;
          s3 += ln[u][m].w & w;
        }
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
  // every warp's partials into rank 0's shared memory, then one barrier
  __shared__ uint32_t all_part[kMaxCluster * kWarps][kParts];
  if (lane == 0) {
    const uint32_t mine[kParts] = {c_live, c_cons, c_exp, s0, s1, s2, s3};
    uint32_t* dst = cluster.map_shared_rank(&all_part[0][0], 0) +
                    (rank * kWarps + warp) * kParts;
#pragma unroll
    for (int i = 0; i < kParts; ++i) dst[i] = mine[i];
  }
  cluster.sync();
  if (rank != 0 || warp != 0) return;
  // rank 0's first warp adds them, kMaxCluster * kWarps / 32 warps' a
  // lane, then by shuffles
  const unsigned n = blocks * kWarps;
  uint32_t sum[kParts] = {0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kMaxCluster * kWarps / 32; ++k) {
    const unsigned w = lane + 32 * k;
    if (w < n) {
#pragma unroll
      for (int i = 0; i < kParts; ++i) sum[i] += all_part[w][i];
    }
  }
#pragma unroll
  for (int i = 0; i < kParts; ++i) sum[i] = warp_sum(sum[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      counts[3 * p + i] = static_cast<int32_t>(sum[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) lane_sums[4 * p + i] = sum[3 + i];
  }
}

using MeshStepKernel = void (*)(const uint8_t*, const uint8_t*,
                                const uint32_t*, const uint8_t*,
                                const uint8_t*, const uint4*, uint32_t,
                                int64_t, uint8_t*, int32_t*, uint32_t*);

}  // namespace

// Launches the epilogue over a [p, b] image on `stream` and returns the
// launch's error (cudaGetLastError(); 0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take. Device
// pointers: packed uint8[p, b / 8] (the static mask), allowed uint8[p],
// expire_ts uint32[p, b] (16-byte aligned), present uint8[p, b] (8-byte
// aligned), extra uint8[p, b] (8-byte aligned) or null for all ones,
// lanes uint32[p, b, 4] (16-byte aligned; read only with with_sum), and
// the outputs out uint8[p, b / 8], counts int32[p, 3], lane_sums
// uint32[p, 4] (4-byte aligned; one buffer in the wrapper), each written
// whole. b is a multiple of 8.
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
  if (p == 0) return 0;
  const int64_t tiles = (b / 8 + 31) / 32;
  const int64_t need = (tiles + kWarps * kTiles - 1) / (kWarps * kTiles);
  const int c = static_cast<int>(need < kMaxCluster ? need : kMaxCluster);
  const MeshStepKernel kernel =
      with_sum ? (extra ? mesh_step_kernel<true, true>
                        : mesh_step_kernel<true, false>)
               : (extra ? mesh_step_kernel<false, true>
                        : mesh_step_kernel<false, false>);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(c), static_cast<unsigned>(p), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, packed, allowed, expire_ts, present, extra,
      reinterpret_cast<const uint4*>(lanes), now, b, out, counts, lane_sums);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
