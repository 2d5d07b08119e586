// K1: stable partition of every payload by a keep flag (compact_flagged).
//
// Replaces the TPU kernel arrow_go_tpu/ops/compaction.py:_stitch (the
// Pallas stitch behind compact_flagged). There, each 8192-row block is
// sorted on ~keep and a sequential grid writes each block's kept prefix
// at its offset, later blocks overwriting earlier blocks' tails. Hopper
// runs blocks concurrently, so nothing may rely on write order: here
// every row is written exactly once, to its final place, and the output
// is the whole stable partition (kept rows in order, then the un-kept
// rows in order), tail included, identical to the plain version.
//
// Bound on this card: bytes. Each payload is read once and written once
// and keep is read twice (the count pass and the scatter pass); there is
// no arithmetic to speak of. What the design does about it:
//
//   count:   one warp per tile of TILE rows, 16-byte loads of keep,
//            kept bytes counted with __vcmpne4 + popc. The tile counts
//            go to `stat`; their sum (the kept total, which places the
//            un-kept rows) is added up with integer atomics and taken by
//            the last block to finish (a ticket), which resets the
//            per-stream scratch for the next call. Reads keep only.
//   scatter: one block per tile; each thread owns RPT consecutive rows
//            (one 16-byte load of keep). The kept counts are scanned in
//            registers, with __shfl_up_sync and one shared-memory step
//            across warps. The tile's offset comes from a decoupled
//            look-back over `stat` in the same kernel: a tile publishes
//            its inclusive prefix (flagged) as soon as it knows it, and a
//            later tile adds the counts of the tiles between it and the
//            nearest published prefix. Every count is already there from
//            the count pass, so no block ever waits on another. Each
//            row's place in the partitioned tile goes to a shared-memory
//            map once per tile; then each payload in turn is loaded with
//            coalesced 16-byte loads (scalar ones for a view that is not
//            16-byte aligned, with the same bits), permuted into one
//            shared staging buffer, and written out as two contiguous
//            runs, consecutive threads on consecutive addresses. Loads
//            start one payload ahead (the first before the keep
//            scan, the next before the write-out of the current one), so
//            the block keeps reads in flight while it scans and writes.
//            The element size (1, 2, 4, 8) is a template parameter: one
//            switch per payload and tile, none per row.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define RPT 16                       // rows per thread: one 16-byte keep load
#define TILE (THREADS * RPT)         // rows per tile
#define MAX_PAYLOADS 16
#define INCL_FLAG (1LL << 62)        // stat[t] holds tile t's inclusive prefix
#define FULL 0xffffffffu

struct Payload {
  const void* src;
  void* dst;
  int size;
  int aligned;                       // src is 16-byte aligned
};

struct Payloads {
  Payload p[MAX_PAYLOADS];
  int n;
};

// Per-stream scratch, zeroed once when it is allocated: the running kept
// total of the count pass, its ticket, and the total of the last call.
struct Scratch {
  unsigned long long running;
  unsigned long long ticket;
  long long total;
};

// Kept bytes among the 4 of w, as a 4-bit mask (bit j = byte j).
__device__ __forceinline__ uint32_t keep_bits4(uint32_t w) {
  const uint32_t b = __vcmpne4(w, 0u) & 0x01010101u;
  return (b | (b >> 7) | (b >> 14) | (b >> 21)) & 0xfu;
}

__device__ __forceinline__ int keep_count16(uint4 v) {
  return __popc(__vcmpne4(v.x, 0u) & 0x01010101u) +
         __popc(__vcmpne4(v.y, 0u) & 0x01010101u) +
         __popc(__vcmpne4(v.z, 0u) & 0x01010101u) +
         __popc(__vcmpne4(v.w, 0u) & 0x01010101u);
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// ---------------------------------------------------------------- count

__global__ void __launch_bounds__(THREADS)
count_kernel(const unsigned char* __restrict__ keep, long long n,
             int aligned, long long tiles, long long* __restrict__ stat,
             Scratch* scratch) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * WARPS;
  long long mine = 0;
  for (long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       t < tiles; t += warps) {
    const long long base = t * TILE;
    const long long rows = n - base < TILE ? n - base : TILE;
    int c = 0;
    if (aligned && rows == TILE) {
      const uint4* k = reinterpret_cast<const uint4*>(keep + base);
      uint4 v[TILE / 16 / 32];
#pragma unroll
      for (int i = 0; i < TILE / 16 / 32; ++i) v[i] = k[lane + 32 * i];
#pragma unroll
      for (int i = 0; i < TILE / 16 / 32; ++i) c += keep_count16(v[i]);
    } else {
      for (long long r = lane; r < rows; r += 32) c += keep[base + r] != 0;
    }
    c = warp_sum(c);
    if (lane == 0) stat[t] = c;
    mine += c;
  }
  if (lane == 0 && mine) {
    atomicAdd(&scratch->running, (unsigned long long)mine);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&scratch->ticket, 1ULL) == gridDim.x - 1) {
      __threadfence();
      scratch->total = (long long)atomicExch(&scratch->running, 0ULL);
      scratch->ticket = 0;
    }
  }
}

// -------------------------------------------------------------- scatter

// Tiles before `tile` hold their count or (flagged) their inclusive
// prefix; walk back 32 at a time to the nearest inclusive prefix.
// Returns the rows kept before the tile (on every lane of the warp).
__device__ long long lookback(const long long* stat, long long tile,
                              int lane) {
  long long excl = 0;
  for (long long j = tile - 1;; j -= 32) {
    const long long idx = j - lane;
    // before tile 0 stands an inclusive prefix of 0
    const long long v =
        idx >= 0 ? *(reinterpret_cast<const volatile long long*>(stat) + idx)
                 : INCL_FLAG;
    const unsigned inc = __ballot_sync(FULL, (v & INCL_FLAG) != 0);
    if (inc) {
      const int first = __ffs(inc) - 1;   // the nearest published tile
      excl += warp_sum(lane < first ? v
                                    : lane == first ? (v & ~INCL_FLAG) : 0LL);
      return excl;
    }
    excl += warp_sum(v);
  }
}

template <int S> struct Elem;
template <> struct Elem<1> { typedef uint8_t T; };
template <> struct Elem<2> { typedef uint16_t T; };
template <> struct Elem<4> { typedef uint32_t T; };
template <> struct Elem<8> { typedef unsigned long long T; };

// Start this thread's 16-byte loads of one payload's rows of the tile
// (coalesced: load k of thread t is vector t + k * THREADS), where the
// source is aligned. They stay in flight until scatter_payload uses
// them, so the kernel starts them early: the first payload's before the
// keep scan, each next payload's before the current one's write-out.
template <int S>
__device__ __forceinline__ void load_payload(const Payload& pl,
                                             long long base, int rows,
                                             uint4 (&v)[8]) {
  typedef typename Elem<S>::T E;
  constexpr int VEC = 16 / S;                   // elements per load
  constexpr int VPT = TILE / VEC / THREADS;     // loads per thread (= S)
  const uint4* src = reinterpret_cast<const uint4*>(
      static_cast<const E*>(pl.src) + base);
  const int nvec = pl.aligned ? rows / VEC : 0;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int vi = threadIdx.x + k * THREADS;
    if (vi < nvec) v[k] = src[vi];
  }
}

// The payload's rows of the tile into `stage`, in partitioned order:
// row r goes to slot[r]. Rows past the loaded vectors (the ragged end,
// or every row of a source that is not 16-byte aligned) are read here,
// one element a thread.
template <int S>
__device__ __forceinline__ void scatter_payload(const Payload& pl,
                                                long long base, int rows,
                                                const uint4 (&v)[8],
                                                const uint16_t* slot,
                                                unsigned char* stage) {
  typedef typename Elem<S>::T E;
  constexpr int VEC = 16 / S;
  constexpr int VPT = TILE / VEC / THREADS;
  const E* src = static_cast<const E*>(pl.src) + base;
  E* st = reinterpret_cast<E*>(stage);
  const int nvec = pl.aligned ? rows / VEC : 0;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int vi = threadIdx.x + k * THREADS;
    if (vi < nvec) {
      const E* e = reinterpret_cast<const E*>(&v[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) st[slot[vi * VEC + j]] = e[j];
    }
  }
  for (int r = nvec * VEC + threadIdx.x; r < rows; r += THREADS)
    st[slot[r]] = src[r];
}

// The partitioned tile out of `stage`: slots [0, kept) to kept_dst..,
// slots [kept, rows) to unkept_dst..; consecutive threads, consecutive
// addresses.
template <int S>
__device__ __forceinline__ void write_payload(const Payload& pl,
                                              const unsigned char* stage,
                                              int rows, int kept,
                                              long long kept_dst,
                                              long long unkept_dst) {
  typedef typename Elem<S>::T E;
  const E* st = reinterpret_cast<const E*>(stage);
  E* dst = static_cast<E*>(pl.dst);
#pragma unroll 4
  for (int s = threadIdx.x; s < rows; s += THREADS)
    dst[s < kept ? kept_dst + s : unkept_dst + (s - kept)] = st[s];
}

__device__ __forceinline__ void load_any(const Payload& q, long long base,
                                         int rows, uint4 (&v)[8]) {
  switch (q.size) {
    case 1: load_payload<1>(q, base, rows, v); break;
    case 2: load_payload<2>(q, base, rows, v); break;
    case 4: load_payload<4>(q, base, rows, v); break;
    default: load_payload<8>(q, base, rows, v); break;
  }
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const unsigned char* __restrict__ keep, long long n,
               int keep_aligned, long long* stat,
               const Scratch* __restrict__ scratch,
               const __grid_constant__ Payloads pl) {
  __shared__ __align__(16) unsigned char stage[TILE * 8];
  __shared__ __align__(16) uint16_t slot[TILE];
  __shared__ int warp_tot[WARPS];
  __shared__ long long tile_excl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;
  const long long base = tile * TILE;
  const int rows = (int)(n - base < TILE ? n - base : TILE);
  uint4 v[8];                           // one payload's loads in flight
  load_any(pl.p[0], base, rows, v);

  if (warp == 0) {
    const long long cnt = stat[tile];   // this tile's count, from the count pass
    const long long excl = lookback(stat, tile, lane);
    if (lane == 0) {
      *(reinterpret_cast<volatile long long*>(stat) + tile) =
          (excl + cnt) | INCL_FLAG;
      tile_excl = excl;
    }
  }

  // this thread's RPT rows: a bit mask of the kept ones
  const int row0 = threadIdx.x * RPT;
  uint32_t m = 0;
  if (keep_aligned && row0 + RPT <= rows) {
    const uint4 v = reinterpret_cast<const uint4*>(keep + base)[threadIdx.x];
    m = keep_bits4(v.x) | (keep_bits4(v.y) << 4) | (keep_bits4(v.z) << 8) |
        (keep_bits4(v.w) << 12);
  } else {
    for (int j = 0; j < RPT; ++j)
      if (row0 + j < rows && keep[base + row0 + j]) m |= 1u << j;
  }
  // block exclusive scan of the per-thread kept counts
  const int c = __popc(m);
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int kept = 0, before = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    kept += t;
  }
  const int rank = before + incl - c;   // kept rows of the tile before row0
  // each row's slot in the partitioned tile: kept rows first, in order
  uint32_t sl[RPT / 2];              // two 16-bit slots a word
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int k = rank + __popc(m & ((1u << j) - 1u));
    const uint32_t s = ((m >> j) & 1u) ? k : kept + (row0 + j - k);
    sl[j / 2] = j % 2 ? sl[j / 2] | (s << 16) : s;
  }
  uint4* slot4 = reinterpret_cast<uint4*>(slot + row0);
  slot4[0] = make_uint4(sl[0], sl[1], sl[2], sl[3]);
  slot4[1] = make_uint4(sl[4], sl[5], sl[6], sl[7]);
  __syncthreads();

  const long long excl = tile_excl;
  const long long kept_dst = excl;
  const long long unkept_dst = scratch->total + (base - excl);
  for (int p = 0; p < pl.n; ++p) {
    const Payload& q = pl.p[p];
    switch (q.size) {
      case 1: scatter_payload<1>(q, base, rows, v, slot, stage); break;
      case 2: scatter_payload<2>(q, base, rows, v, slot, stage); break;
      case 4: scatter_payload<4>(q, base, rows, v, slot, stage); break;
      default: scatter_payload<8>(q, base, rows, v, slot, stage); break;
    }
    __syncthreads();
    if (p + 1 < pl.n) load_any(pl.p[p + 1], base, rows, v);
    switch (q.size) {
      case 1: write_payload<1>(q, stage, rows, kept, kept_dst, unkept_dst);
        break;
      case 2: write_payload<2>(q, stage, rows, kept, kept_dst, unkept_dst);
        break;
      case 4: write_payload<4>(q, stage, rows, kept, kept_dst, unkept_dst);
        break;
      default: write_payload<8>(q, stage, rows, kept, kept_dst, unkept_dst);
        break;
    }
    __syncthreads();   // the next payload reuses the staging buffer
  }
}

// Blocks of the count pass resident at once on the card: its grid.
static int count_grid(long long tiles) {
  static int resident = 0;
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_kernel,
                                                  THREADS, 0);
    resident = sms * per_sm < 1 ? 1 : sms * per_sm;
  }
  const long long need = (tiles + WARPS - 1) / WARPS;
  return (int)(need < resident ? need : resident);
}

// keep: n flag bytes (keep_aligned: 16-byte aligned); srcs/dsts/sizes/
// aligned: n_pay payloads of n elements (sizes 1, 2, 4 or 8; aligned:
// src 16-byte aligned); stat: ceil(n / TILE) int64 of scratch for this
// call; scratch: 3 int64 per stream, zeroed before its first use.
// Returns a CUDA error code.
extern "C" int agt_compact(const void* keep, long long n, int keep_aligned,
                           int n_pay, void* const* srcs, void* const* dsts,
                           const int* sizes, const int* aligned, void* stat,
                           void* scratch, void* stream) {
  if (n_pay < 1 || n_pay > MAX_PAYLOADS || n < 1)
    return (int)cudaErrorInvalidValue;
  Payloads pl;
  pl.n = n_pay;
  for (int p = 0; p < n_pay; ++p) {
    if (sizes[p] != 1 && sizes[p] != 2 && sizes[p] != 4 && sizes[p] != 8)
      return (int)cudaErrorInvalidValue;
    pl.p[p].src = srcs[p];
    pl.p[p].dst = dsts[p];
    pl.p[p].size = sizes[p];
    pl.p[p].aligned = aligned[p];
  }
  const long long tiles = (n + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* k = static_cast<const unsigned char*>(keep);
  count_kernel<<<count_grid(tiles), THREADS, 0, s>>>(
      k, n, keep_aligned, tiles, static_cast<long long*>(stat),
      static_cast<Scratch*>(scratch));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
      k, n, keep_aligned, static_cast<long long*>(stat),
      static_cast<const Scratch*>(scratch), pl);
  return (int)cudaGetLastError();
}
