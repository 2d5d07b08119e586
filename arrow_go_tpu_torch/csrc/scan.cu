// K2: inclusive running u64 max of (hi, lo_i) packs (cummax_u64_lanes).
//
// Replaces the TPU kernel arrow_go_tpu/ops/scan.py:cummax_u64_lanes (the
// Pallas `kernel` / `scan_block`), which scans 8192-row blocks with roll
// networks and carries the running max across a sequential grid in
// VMEM. Hopper blocks run concurrently, so the carry needs its own pass:
//
//   1. tile_max:   the max of every pack lane over each tile of TILE rows.
//   2. scan_tiles: one block per lane max-scans the tile maxima in place
//                  (inclusive), in chunks of the block width.
//   3. tile_scan:  each tile scans its rows chunk by chunk (warp
//                  __shfl_up_sync scan of 64-bit values, then a scan of the
//                  warp totals), seeded with the previous tile's scanned
//                  max, and writes the high word of lane 0's running max
//                  and the low word of each lane's.
//
// Every pack (hi << 32) | lo_i is built in registers as unsigned 64-bit
// and compared as unsigned, so each lane is the exact per-pack u64 max,
// as in the JAX package's fallback (scan.py:49-60); the inputs and
// outputs are int64 tensors carrying u32 values.
//
// Bound on this card: bytes. The lanes are read twice (passes 1 and 3)
// and written once; the compare work is a few operations per byte. All
// loads and stores are coalesced: thread t of a chunk touches row
// chunk_base + t.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define ITEMS 8
#define TILE (THREADS * ITEMS)
#define SCAN_THREADS 1024
#define MAX_LO 4

typedef unsigned long long u64;

struct Lanes {
  const long long* lo[MAX_LO];
  long long* out_lo[MAX_LO];
  int n;
};

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 pack(long long hi, long long lo) {
  return ((u64)(uint32_t)hi << 32) | (u64)(uint32_t)lo;
}

// Inclusive max-scan across the block; every thread must call it.
// `warp_tot` holds at least blockDim.x / 32 values.
__device__ u64 block_incl_max(u64 v, u64* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = umax(v, u);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    u64 t = lane < nw ? warp_tot[lane] : 0ull;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 u = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = umax(t, u);
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v = umax(v, warp_tot[warp - 1]);
  __syncthreads();  // warp_tot is reused by the next call
  return v;
}

__global__ void __launch_bounds__(THREADS)
tile_max_kernel(const long long* __restrict__ hi, Lanes L, long long n,
                u64* __restrict__ tile_max, long long tiles) {
  __shared__ u64 red[MAX_LO][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  u64 m[MAX_LO];
#pragma unroll
  for (int i = 0; i < MAX_LO; ++i) m[i] = 0ull;
  for (int c = 0; c < ITEMS; ++c) {
    const long long r = base + (long long)c * THREADS + threadIdx.x;
    if (r < n) {
      const long long h = hi[r];
#pragma unroll
      for (int i = 0; i < MAX_LO; ++i)
        if (i < L.n) m[i] = umax(m[i], pack(h, L.lo[i][r]));
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_LO; ++i) {
    if (i >= L.n) break;
    u64 v = m[i];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = umax(v, __shfl_down_sync(0xffffffffu, v, d));
    if (lane == 0) red[i][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < L.n) {
    u64 v = 0ull;
    for (int w = 0; w < THREADS / 32; ++w) v = umax(v, red[threadIdx.x][w]);
    tile_max[threadIdx.x * tiles + blockIdx.x] = v;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles_kernel(u64* tile_max, long long tiles) {
  __shared__ u64 warp_tot[SCAN_THREADS / 32];
  __shared__ u64 last;
  u64* a = tile_max + (long long)blockIdx.x * tiles;
  u64 carry = 0ull;
  for (long long base = 0; base < tiles; base += SCAN_THREADS) {
    const long long idx = base + threadIdx.x;
    u64 v = idx < tiles ? a[idx] : 0ull;
    v = umax(block_incl_max(v, warp_tot), carry);
    if (idx < tiles) a[idx] = v;
    if (threadIdx.x == SCAN_THREADS - 1) last = v;
    __syncthreads();
    carry = last;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
tile_scan_kernel(const long long* __restrict__ hi, Lanes L, long long n,
                 const u64* __restrict__ incl_tiles, long long tiles,
                 long long* __restrict__ out_hi) {
  __shared__ u64 warp_tot[MAX_LO][THREADS / 32];
  __shared__ u64 last[MAX_LO];
  const long long base = (long long)blockIdx.x * TILE;
  u64 carry[MAX_LO];
#pragma unroll
  for (int i = 0; i < MAX_LO; ++i)
    carry[i] = (i < L.n && blockIdx.x > 0)
                   ? incl_tiles[i * tiles + blockIdx.x - 1] : 0ull;
  for (int c = 0; c < ITEMS; ++c) {
    const long long r = base + (long long)c * THREADS + threadIdx.x;
    const bool in = r < n;
    const long long h = in ? hi[r] : 0;
#pragma unroll
    for (int i = 0; i < MAX_LO; ++i) {
      if (i >= L.n) break;
      u64 v = in ? pack(h, L.lo[i][r]) : 0ull;
      v = umax(block_incl_max(v, warp_tot[i]), carry[i]);
      if (in) {
        if (i == 0) out_hi[r] = (long long)(v >> 32);
        L.out_lo[i][r] = (long long)(v & 0xffffffffull);
      }
      if (threadIdx.x == THREADS - 1) last[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_LO; ++i)
      if (i < L.n) carry[i] = last[i];
    __syncthreads();
  }
}

extern "C" int agt_cummax_u64_lanes(const void* hi, int n_lo,
                                    const void* const* los, void* out_hi,
                                    void* const* out_los, long long n,
                                    void* scratch, void* stream) {
  if (n_lo < 1 || n_lo > MAX_LO) return (int)cudaErrorInvalidValue;
  Lanes L;
  L.n = n_lo;
  for (int i = 0; i < n_lo; ++i) {
    L.lo[i] = static_cast<const long long*>(los[i]);
    L.out_lo[i] = static_cast<long long*>(out_los[i]);
  }
  const long long tiles = (n + TILE - 1) / TILE;
  cudaStream_t s = (cudaStream_t)stream;
  u64* tmax = static_cast<u64*>(scratch);
  const long long* h = static_cast<const long long*>(hi);
  tile_max_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(h, L, n, tmax, tiles);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_tiles_kernel<<<n_lo, SCAN_THREADS, 0, s>>>(tmax, tiles);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  tile_scan_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
      h, L, n, tmax, tiles, static_cast<long long*>(out_hi));
  return (int)cudaGetLastError();
}
