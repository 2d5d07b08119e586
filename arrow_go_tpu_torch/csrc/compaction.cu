// K1: stable partition of every payload by a keep flag (compact_flagged).
//
// Replaces the TPU kernel arrow_go_tpu/ops/compaction.py:_stitch (the
// Pallas stitch behind compact_flagged). There, each 8192-row block is
// sorted on ~keep and a sequential grid writes each block's kept prefix
// at its offset, later blocks overwriting earlier blocks' tails. Hopper
// runs blocks concurrently, so nothing may rely on write order: here
// every row is written exactly once, to its final place.
//
//   1. count:   per tile of TILE rows, the kept count (ballot + popc).
//   2. offsets: inclusive scan of the tile counts (torch.cumsum in the
//               wrapper; the JAX package also scans outside its kernel).
//   3. scatter: each row's rank among the tile's kept rows comes from
//               the warp ballot (popc of the lanes below) plus the warp
//               prefix in shared memory. Kept rows go to off + rank,
//               un-kept rows to total + (rows before the tile that were
//               not kept) + (un-kept rows of the tile before this one).
//
// The output is the whole stable partition, tail included, identical to
// the plain version (a stable argsort on ~keep), so no later gather can
// read a stale tail. All payloads move in one launch; each is copied by
// its element size (1, 2, 4 or 8 bytes).
//
// Bound on this card: bytes. Each payload is read once and written once
// and keep is read twice (count and scatter); there is no arithmetic to
// speak of. Reads are coalesced; writes of a warp land on two
// contiguous runs (kept and un-kept), so they stay near-coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 2048
#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_PAYLOADS 16

struct Payloads {
  const void* src[MAX_PAYLOADS];
  void* dst[MAX_PAYLOADS];
  int size[MAX_PAYLOADS];
  int n;
};

__global__ void __launch_bounds__(THREADS)
count_kernel(const unsigned char* __restrict__ keep, long long n,
             long long* __restrict__ counts) {
  __shared__ int warp_cnt[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  int c = 0;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const long long row = base + i;
    const bool k = row < n && keep[row] != 0;
    c += __popc(__ballot_sync(0xffffffffu, k));
  }
  if (lane == 0) warp_cnt[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < WARPS; ++w) t += warp_cnt[w];
    counts[blockIdx.x] = t;
  }
}

__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int size, long long from,
                                          long long to) {
  switch (size) {
    case 1:
      static_cast<uint8_t*>(dst)[to] = static_cast<const uint8_t*>(src)[from];
      break;
    case 2:
      static_cast<uint16_t*>(dst)[to] =
          static_cast<const uint16_t*>(src)[from];
      break;
    case 4:
      static_cast<uint32_t*>(dst)[to] =
          static_cast<const uint32_t*>(src)[from];
      break;
    default:
      static_cast<uint64_t*>(dst)[to] =
          static_cast<const uint64_t*>(src)[from];
      break;
  }
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const unsigned char* __restrict__ keep, long long n,
               const long long* __restrict__ incl, Payloads pl) {
  __shared__ int warp_cnt[WARPS];
  __shared__ int warp_off[WARPS + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;
  const long long base = tile * TILE;
  const long long excl = tile == 0 ? 0 : incl[tile - 1];
  const long long total = incl[gridDim.x - 1];
  const unsigned below = (1u << lane) - 1u;
  int running = 0;  // kept rows of this tile before the current chunk
  for (int chunk = 0; chunk < TILE; chunk += THREADS) {
    const long long row = base + chunk + threadIdx.x;
    const bool in = row < n;
    const bool k = in && keep[row] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, k);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < WARPS; ++w) {
        warp_off[w] = s;
        s += warp_cnt[w];
      }
      warp_off[WARPS] = s;
    }
    __syncthreads();
    if (in) {
      // kept rows of this tile strictly before `row`
      const long long rank = running + warp_off[warp] + __popc(ballot & below);
      const long long local = chunk + threadIdx.x;
      const long long dst =
          k ? excl + rank : total + (base - excl) + (local - rank);
      for (int p = 0; p < pl.n; ++p)
        copy_elem(pl.src[p], pl.dst[p], pl.size[p], row, dst);
    }
    running += warp_off[WARPS];
    __syncthreads();  // warp_cnt / warp_off are rewritten by the next chunk
  }
}

extern "C" int agt_compact_count(const void* keep, long long n, void* counts,
                                 void* stream) {
  const long long tiles = (n + TILE - 1) / TILE;
  count_kernel<<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(keep), n,
      static_cast<long long*>(counts));
  return (int)cudaGetLastError();
}

extern "C" int agt_compact_scatter(const void* keep, long long n,
                                   const void* incl, int n_pay,
                                   void* const* srcs, void* const* dsts,
                                   const int* sizes, void* stream) {
  if (n_pay < 1 || n_pay > MAX_PAYLOADS) return (int)cudaErrorInvalidValue;
  Payloads pl;
  pl.n = n_pay;
  for (int p = 0; p < n_pay; ++p) {
    if (sizes[p] != 1 && sizes[p] != 2 && sizes[p] != 4 && sizes[p] != 8)
      return (int)cudaErrorInvalidValue;
    pl.src[p] = srcs[p];
    pl.dst[p] = dsts[p];
    pl.size[p] = sizes[p];
  }
  const long long tiles = (n + TILE - 1) / TILE;
  scatter_kernel<<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(keep), n,
      static_cast<const long long*>(incl), pl);
  return (int)cudaGetLastError();
}
