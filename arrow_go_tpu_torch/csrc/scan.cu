// K2: inclusive running u64 max of (hi, lo_i) packs (cummax_u64_lanes),
// and its hi-only mode: the running max of one u32 lane (cummax_u32).
//
// Replaces the TPU kernel arrow_go_tpu/ops/scan.py:cummax_u64_lanes (the
// Pallas `kernel` / `scan_block`), which scans 8192-row blocks with roll
// networks and carries the running max across a sequential grid in
// VMEM. Hopper blocks run concurrently, so the carry travels between
// tiles through device memory instead, in the same single pass.
//
// Bound on this card: bytes. Every lane is read once and every fill is
// written once, in one launch; the compare work is a few operations per
// byte. What the design does about it:
//
//   ticket:    each block takes its tile index from an atomic counter in
//              the per-stream scratch, so tiles start in index order and
//              a tile only ever waits on tiles that are already running
//              (a tile index from blockIdx.x could wait on a block that
//              was never scheduled). The block that takes the last ticket
//              resets the counter for the next call.
//   load:      consecutive threads read consecutive 16-byte vectors (two
//              rows) of every lane (scalar loads for a view that is not
//              16-byte aligned, with the same bits) and put each row's
//              pack in shared memory, padded by PAD rows after every RPT
//              so that the reads below hit each bank once.
//   scan:      each thread owns RPT consecutive rows and scans them
//              serially in registers; the thread totals are max-scanned
//              with __shfl_up_sync in each warp and once across warps
//              through shared memory: four barriers a tile, the ticket's
//              included.
//   carry:     a decoupled look-back over per-tile status words. A tile
//              publishes its aggregate as soon as its block scan has it,
//              then walks back, 32 tiles a step, over the aggregates to
//              the nearest published inclusive prefix, waiting on a tile
//              that has not published yet (there is no count pass to fill
//              the words first), and publishes its own inclusive prefix.
//              In the hi-only mode the u32 value, its state and the
//              call's epoch share one 64-bit word. In the pack mode a
//              value is a whole u64, so the values go first and the flag
//              word after, with release / acquire ordering, and are read
//              in the opposite order; a reader that finds an aggregate's
//              flag may read the inclusive prefix that replaced it, which
//              is a max over an earlier prefix and so changes nothing.
//              Status words carry the call's epoch: a word from an
//              earlier call never looks current, so the scratch needs no
//              fill between calls.
//   store:     the tile's rows, maxed with the carry, go out of shared
//              memory with coalesced 16-byte stores.
//   occupancy: a block's loads are in flight only until its scan, so the
//              bytes in flight come from many resident blocks: registers
//              are capped for 8 blocks of 256 threads per SM in the
//              hi-only mode and 4 in the pack mode (with 2 lo lanes 64
//              registers, no spill). On the H100 this was faster at all
//              of the join's shapes than no cap, 4096- or 1024-row
//              tiles, 128-thread blocks, or persistent blocks that
//              prefetch the next tile with cp.async (PERF.md §6).
//
// Every pack (hi << 32) | lo_i is built in registers as unsigned 64-bit
// and compared as unsigned, so each lane is the exact per-pack u64 max,
// as in the JAX package's fallback (scan.py:49-60); the inputs and
// outputs are int64 tensors carrying u32 values. With no lo lane the
// value is the hi word alone, which is lane 0's max's hi word for a zero
// lo lane.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define RPT 8                          // rows per thread in the scan
#define PAIRS (RPT / 2)                // 16-byte vectors per thread and lane
#define TILE (THREADS * RPT)           // rows per tile
#define PAD 2                          // shared rows of padding per RPT
#define SROWS (THREADS * (RPT + PAD))  // shared rows of one lane
#define MAX_LO 4
#define MAX_DEVICES 64
#define FULL 0xffffffffu
#define ST_A 1ull                      // a status word holds the aggregate
#define ST_P 2ull                      // ... the inclusive prefix
#define MIN_BLOCKS_HI 8                // blocks resident per SM that
#define MIN_BLOCKS_PACK 4              // __launch_bounds__ asks for

typedef unsigned long long u64;

struct Lanes {
  const long long* hi;
  const long long* lo[MAX_LO];
  long long* out_hi;
  long long* out_lo[MAX_LO];
};

__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a > b ? a : b; }

__device__ __forceinline__ u64 pack(long long hi, long long lo) {
  return ((u64)(uint32_t)hi << 32) | (u64)(uint32_t)lo;
}

// row r of a tile in a lane's shared buffer
__device__ __forceinline__ int srow(int r) { return r + (r / RPT) * PAD; }

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = umax(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// Rows r and r + 1 of a lane (0 past `rows`).
__device__ __forceinline__ longlong2 load2(const long long* p, int r,
                                           int rows, int aligned) {
  if (aligned && r + 1 < rows)
    return __ldg(reinterpret_cast<const longlong2*>(p) + (r >> 1));
  longlong2 v;
  v.x = r < rows ? __ldg(p + r) : 0;
  v.y = r + 1 < rows ? __ldg(p + r + 1) : 0;
  return v;
}

__device__ __forceinline__ void store2(long long* p, int r, int rows,
                                       int aligned, u64 a, u64 b) {
  if (aligned && r + 1 < rows) {
    reinterpret_cast<longlong2*>(p)[r >> 1] =
        make_longlong2((long long)a, (long long)b);
    return;
  }
  if (r < rows) p[r] = (long long)a;
  if (r + 1 < rows) p[r + 1] = (long long)b;
}

// Status word layout. Hi-only (K = 0): [epoch:30][state:2][value:32].
// Pack mode: flags[t] = [epoch:62][state:2], values at vals[t * K + i].
// Either layout's word from an earlier call fails the other's epoch test.
template <int K>
__device__ __forceinline__ u64 state_of(u64 w, u64 epoch) {
  if constexpr (K == 0) return (w >> 34) == epoch ? (w >> 32) & 3ull : 0ull;
  else return (w >> 2) == epoch ? w & 3ull : 0ull;
}

template <int K>
__device__ __forceinline__ u64 load_flag(const u64* p) {
  if constexpr (K == 0) return ld_relaxed(p);
  else return ld_acquire(p);
}

template <int K>
__device__ __forceinline__ void publish(u64* flags, u64* vals, long long t,
                                        u64 epoch, u64 state, const u64* v) {
  if constexpr (K == 0) {
    st_relaxed(flags + t, (epoch << 34) | (state << 32) | v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) st_relaxed(vals + t * K + i, v[i]);
    st_release(flags + t, (epoch << 2) | state);
  }
}

// Warp 0 of tile `tile` (> 0): the max over tiles [0, tile) of each lane,
// on every lane of the warp.
template <int K>
__device__ void lookback(const u64* flags, const u64* vals, long long tile,
                         u64 epoch, u64* carry) {
  constexpr int NV = K ? K : 1;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NV; ++i) carry[i] = 0ull;
  for (long long j = tile - 1;; j -= 32) {
    const long long idx = j - lane;
    u64 w = 0ull, st = ST_P;           // before tile 0: a prefix of 0
    if (idx >= 0) {
      w = load_flag<K>(flags + idx);
      st = state_of<K>(w, epoch);
    }
    // a tile that took its ticket earlier publishes without waiting on
    // anyone, so this ends
    while (__any_sync(FULL, st == 0ull)) {
      if (st == 0ull) {
        w = load_flag<K>(flags + idx);
        st = state_of<K>(w, epoch);
      }
    }
    const unsigned inc = __ballot_sync(FULL, st == ST_P);
    const int last = inc ? __ffs(inc) - 1 : 31;   // nearest inclusive prefix
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      u64 x = 0ull;
      if (idx >= 0 && lane <= last) {
        if constexpr (K == 0) x = w & 0xffffffffull;
        else x = ld_relaxed(vals + idx * K + i);
      }
      carry[i] = umax(carry[i], warp_max(x));
    }
    if (inc) return;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS,
                                  K == 0 ? MIN_BLOCKS_HI : MIN_BLOCKS_PACK)
cummax_kernel(const __grid_constant__ Lanes L, long long n, int aligned,
              u64* scratch, long long tiles, long long cap, u64 epoch) {
  constexpr int NV = K ? K : 1;
  extern __shared__ __align__(16) u64 buf[];   // NV lanes of SROWS rows
  __shared__ u64 warp_tot[NV][WARPS];
  __shared__ u64 carry_s[NV];
  __shared__ long long tile_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64* flags = scratch + 1;
  u64* vals = flags + cap;

  if (threadIdx.x == 0) {
    const u64 t = atomicAdd(scratch, 1ull);
    if (t == (u64)(tiles - 1)) atomicExch(scratch, 0ull);  // the last ticket
    tile_s = (long long)t;
  }
  __syncthreads();
  const long long tile = tile_s;
  const long long base = tile * TILE;
  const int rows = (int)(n - base < TILE ? n - base : TILE);

  // load: vector p = threadIdx.x + k * THREADS holds rows 2p, 2p + 1
  longlong2 h[PAIRS], lo[NV][PAIRS];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k)
    h[k] = load2(L.hi + base, 2 * (threadIdx.x + k * THREADS), rows,
                 aligned);
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int k = 0; k < PAIRS; ++k)
      lo[i][k] = load2(L.lo[i] + base, 2 * (threadIdx.x + k * THREADS), rows,
                       aligned);
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int s = srow(2 * (threadIdx.x + k * THREADS));
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      ulonglong2 q;
      if constexpr (K == 0)
        q = make_ulonglong2((uint32_t)h[k].x, (uint32_t)h[k].y);
      else
        q = make_ulonglong2(pack(h[k].x, lo[i][k].x),
                            pack(h[k].y, lo[i][k].y));
      *reinterpret_cast<ulonglong2*>(buf + i * SROWS + s) = q;
    }
  }
  __syncthreads();

  // scan: this thread's RPT consecutive rows, serially
  const int row0 = threadIdx.x * (RPT + PAD);
  u64 v[NV][RPT];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int k = 0; k < PAIRS; ++k) {
      const ulonglong2 q =
          *reinterpret_cast<const ulonglong2*>(buf + i * SROWS + row0 + 2 * k);
      v[i][2 * k] = q.x;
      v[i][2 * k + 1] = q.y;
    }
#pragma unroll
    for (int k = 1; k < RPT; ++k) v[i][k] = umax(v[i][k], v[i][k - 1]);
  }
  // thread totals: inclusive scan in the warp, then across warps
  u64 excl[NV], agg[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    u64 x = v[i][RPT - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 u = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x = umax(x, u);
    }
    const u64 e = __shfl_up_sync(FULL, x, 1);
    excl[i] = lane ? e : 0ull;
    if (lane == 31) warp_tot[i][warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    u64 before = 0ull, all = 0ull;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const u64 t = warp_tot[i][w];
      if (w < warp) before = umax(before, t);
      all = umax(all, t);
    }
    excl[i] = umax(excl[i], before);
    agg[i] = all;
  }

  // carry: warp 0 publishes, looks back, publishes again
  if (warp == 0) {
    u64 carry[NV];
    if (tile == 0) {
      if (lane == 0) publish<K>(flags, vals, 0, epoch, ST_P, agg);
#pragma unroll
      for (int i = 0; i < NV; ++i) carry[i] = 0ull;
    } else {
      if (lane == 0) publish<K>(flags, vals, tile, epoch, ST_A, agg);
      lookback<K>(flags, vals, tile, epoch, carry);
      if (lane == 0) {
        u64 incl[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) incl[i] = umax(carry[i], agg[i]);
        publish<K>(flags, vals, tile, epoch, ST_P, incl);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) carry_s[i] = carry[i];
    }
  }
  // the tile's running max without the carry, back over this thread's rows
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < PAIRS; ++k)
      *reinterpret_cast<ulonglong2*>(buf + i * SROWS + row0 + 2 * k) =
          make_ulonglong2(umax(excl[i], v[i][2 * k]),
                          umax(excl[i], v[i][2 * k + 1]));
  __syncthreads();

  // store: the carry in, coalesced 16-byte stores
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int r = 2 * (threadIdx.x + k * THREADS);
    if (r >= rows) break;
    const int s = srow(r);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const ulonglong2 q =
          *reinterpret_cast<const ulonglong2*>(buf + i * SROWS + s);
      const u64 a = umax(carry_s[i], q.x), b = umax(carry_s[i], q.y);
      if constexpr (K == 0) {
        store2(L.out_hi + base, r, rows, aligned, a, b);
      } else {
        if (i == 0)
          store2(L.out_hi + base, r, rows, aligned, a >> 32, b >> 32);
        store2(L.out_lo[i] + base, r, rows, aligned, a & 0xffffffffull,
               b & 0xffffffffull);
      }
    }
  }
}

template <int K>
static int launch(const Lanes& L, long long n, int aligned, u64* scratch,
                  long long tiles, long long cap, u64 epoch,
                  cudaStream_t s) {
  constexpr int NV = K ? K : 1;
  const int smem = NV * SROWS * (int)sizeof(u64);
  // above 48 KB, static and dynamic together, only after this opt-in,
  // made once per device and mode
  static bool opted[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !opted[dev]) {
    e = cudaFuncSetAttribute(cummax_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) opted[dev] = true;
  }
  cummax_kernel<K><<<(unsigned)tiles, THREADS, smem, s>>>(
      L, n, aligned, scratch, tiles, cap, epoch);
  return (int)cudaGetLastError();
}

// hi, out_hi: n int64; los / out_los: n_lo (0..4) lanes of n int64, null
// when n_lo is 0 (the hi-only mode); aligned: every pointer is 16-byte
// aligned; scratch: per-stream scratch of 1 + cap * (1 + MAX_LO) int64
// for cap >= ceil(n / TILE) tiles, zeroed when it was allocated: the
// ticket, cap status words, then cap * MAX_LO value words. The layout
// depends on cap alone, so a status word only ever holds status words
// of earlier calls. epoch: this call's number on that scratch, 1 .. 2^30
// - 1, a new one each call. Returns a CUDA error code.
extern "C" int agt_cummax_u64_lanes(const void* hi, int n_lo,
                                    const void* const* los, void* out_hi,
                                    void* const* out_los, long long n,
                                    int aligned, void* scratch, long long cap,
                                    unsigned long long epoch, void* stream) {
  const long long tiles = (n + TILE - 1) / TILE;
  if (n_lo < 0 || n_lo > MAX_LO || n < 1 || tiles > 0x7fffffffLL ||
      cap < tiles || epoch < 1 || epoch >= (1ull << 30))
    return (int)cudaErrorInvalidValue;
  Lanes L;
  L.hi = static_cast<const long long*>(hi);
  L.out_hi = static_cast<long long*>(out_hi);
  for (int i = 0; i < MAX_LO; ++i) {
    L.lo[i] = i < n_lo ? static_cast<const long long*>(los[i]) : nullptr;
    L.out_lo[i] = i < n_lo ? static_cast<long long*>(out_los[i]) : nullptr;
  }
  u64* sc = static_cast<u64*>(scratch);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_lo) {
    case 0: return launch<0>(L, n, aligned, sc, tiles, cap, epoch, s);
    case 1: return launch<1>(L, n, aligned, sc, tiles, cap, epoch, s);
    case 2: return launch<2>(L, n, aligned, sc, tiles, cap, epoch, s);
    case 3: return launch<3>(L, n, aligned, sc, tiles, cap, epoch, s);
    default: return launch<4>(L, n, aligned, sc, tiles, cap, epoch, s);
  }
}
