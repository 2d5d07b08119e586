// K3: masked reduction (sum / prod / min / max) of one column, with the
// count of the rows it took (reduce, reduce_with_count).
//
// Replaces the TPU kernel arrow_go_tpu/ops/reductions.py:_reduce_kernel
// (through _reduce_pallas_call and reduce_pallas). There, a sequential
// grid streams (rows, 128) blocks through VMEM, expands the packed
// validity words in the kernel, and carries one (1, 1) accumulator from
// step to step. Hopper blocks run concurrently, so nothing carries from
// block to block; one launch does it all:
//
//   a grid-stride loop: each thread loads VEC values with one streaming
//   16-byte load (UNROLL loads in flight, the last ones too, under a
//   predicate instead of one at a time), tests validity bit i itself
//   (one word covers a chunk: VEC divides 32), reduces in registers and
//   counts the rows it took (popc of the chunk's bits); rows past the
//   last whole chunk, or every row of an unaligned column, take a scalar
//   loop. The warp (__shfl_down_sync) and the block (shared memory)
//   reduce both, and each block writes its partial and its count. Then
//   it fences and takes a ticket; the last block to arrive combines
//   every partial in block order (a fixed order, whichever block is
//   last), writes the accumulator and the int64 count side by side, and
//   resets the ticket.
//
// Row i counts when i < n and its validity bit is set; rows in [n, P)
// are never read. No float atomics: the grid depends on n, the element
// size and the card only (one wave of resident blocks), and the combine
// order is fixed, so the result is bit-identical from run to run. The
// partials and the ticket are per-stream scratch, zeroed once: a ticket
// is never shared by two streams. Integer sums and products run in
// unsigned arithmetic, so they wrap as the JAX package's do, without
// undefined behaviour. Float min and max propagate NaN as jnp.min /
// jnp.max do (fminf / fmaxf would drop it); float sums and products
// propagate it by arithmetic.
//
// Types follow the JAX package's _acc_dtype: int32 sums into int64,
// everything else reduces in its own type. The TPU kernel takes 32-bit
// lanes only (Mosaic cannot lower 64-bit ones); Hopper has native
// 64-bit integers and doubles, so int64 and float64 take this kernel too.
//
// Bound on this card: bytes. Rows [0, n) of the values and their
// validity words are read once; the arithmetic is one operation per
// value. One launch instead of two, and the count in the same pass,
// save a launch and its gap per reduction, and the caller's separate
// popcount kernels and their host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define THREADS 256
#define WARPS (THREADS / 32)
#define UNROLL 2

enum { OP_SUM = 0, OP_PROD = 1, OP_MIN = 2, OP_MAX = 3 };
enum { DT_INT32 = 0, DT_INT64 = 1, DT_FLOAT32 = 2, DT_FLOAT64 = 3 };

template <typename A> struct Bounds;
template <> struct Bounds<int> {
  static __device__ int lowest() { return (int)0x80000000; }
  static __device__ int highest() { return 0x7fffffff; }
};
template <> struct Bounds<long long> {
  static __device__ long long lowest() {
    return (long long)0x8000000000000000ULL;
  }
  static __device__ long long highest() { return 0x7fffffffffffffffLL; }
};
template <> struct Bounds<float> {
  static __device__ float lowest() { return __int_as_float(0xff800000); }
  static __device__ float highest() { return __int_as_float(0x7f800000); }
};
template <> struct Bounds<double> {
  static __device__ double lowest() {
    return __longlong_as_double((long long)0xfff0000000000000ULL);
  }
  static __device__ double highest() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
};

template <int OP, typename A>
__device__ __forceinline__ A identity() {
  if constexpr (OP == OP_SUM) return (A)0;
  else if constexpr (OP == OP_PROD) return (A)1;
  else if constexpr (OP == OP_MIN) return Bounds<A>::highest();
  else return Bounds<A>::lowest();
}

template <int OP, typename A>
__device__ __forceinline__ A combine(A a, A b) {
  if constexpr (OP == OP_SUM) {
    return a + b;
  } else if constexpr (OP == OP_PROD) {
    return a * b;
  } else {
    if constexpr (std::is_floating_point<A>::value) {
      if (a != a) return a;  // NaN wins, as in jnp.min / jnp.max
      if (b != b) return b;
    }
    if constexpr (OP == OP_MIN) return b < a ? b : a;
    else return a < b ? b : a;
  }
}

// Reduce v (by OP) and c (by sum) across the block; the results are
// valid in thread 0.
template <int OP, typename A>
__device__ void block_reduce(A& v, long long& c) {
  __shared__ unsigned long long part_raw[WARPS];
  __shared__ long long part_cnt[WARPS];
  A* part = reinterpret_cast<A*>(part_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = combine<OP>(v, __shfl_down_sync(0xffffffffu, v, d));
    c += __shfl_down_sync(0xffffffffu, c, d);
  }
  if (lane == 0) {
    part[warp] = v;
    part_cnt[warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? part[lane] : identity<OP, A>();
    c = lane < WARPS ? part_cnt[lane] : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      v = combine<OP>(v, __shfl_down_sync(0xffffffffu, v, d));
      c += __shfl_down_sync(0xffffffffu, c, d);
    }
  }
}

template <typename T>
struct alignas(16) Pack {
  T x[16 / sizeof(T)];
};

// Fold the VEC values of chunk c (rows c*VEC ..) into acc; count the
// rows taken.
template <typename T, typename A, int OP, bool VALID>
__device__ __forceinline__ void fold_chunk(A& acc, int& cnt,
                                           const Pack<T>& p, uint32_t bits) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (!VALID || ((bits >> k) & 1u)) acc = combine<OP>(acc, (A)p.x[k]);
  if (VALID) cnt += __popc(bits & ((1u << VEC) - 1u));
}

// One 16-byte chunk of values, loaded as streaming (evict-first): each
// value is read once.
template <typename T>
__device__ __forceinline__ Pack<T> load_pack(const Pack<T>* p) {
  Pack<T> v;
  *reinterpret_cast<uint4*>(&v) = __ldcs(reinterpret_cast<const uint4*>(p));
  return v;
}

template <bool VALID>
__device__ __forceinline__ uint32_t chunk_bits(const uint32_t* words,
                                               long long row0) {
  return VALID ? words[row0 >> 5] >> (row0 & 31) : 0xffffffffu;
}

// Per-stream scratch: partials and counts of up to max_partials blocks,
// then the ticket (zeroed once; the last block resets it).
template <typename A>
struct Scratch {
  A* partials;
  long long* counts;
  unsigned int* ticket;
};

// T: the value type; A: the accumulator (an unsigned type for integer
// sums and products, so that they wrap). out: the accumulator in its
// first bytes, the count in out[1].
template <typename T, typename A, int OP, bool VALID>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const T* __restrict__ vals, const uint32_t* __restrict__ words,
              long long n, int aligned, Scratch<A> scratch,
              long long* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ bool last;
  const Pack<T>* packs = reinterpret_cast<const Pack<T>*>(vals);
  A acc = identity<OP, A>();
  int cnt = 0;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  // whole chunks: one 16-byte load each, UNROLL of them in flight
  const long long full = aligned ? n / VEC : 0;
  long long c = tid;
  for (; c + (UNROLL - 1) * stride < full; c += UNROLL * stride) {
    Pack<T> p[UNROLL];
    uint32_t bits[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      p[u] = load_pack(packs + c + u * stride);
      bits[u] = chunk_bits<VALID>(words, (c + u * stride) * VEC);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      fold_chunk<T, A, OP, VALID>(acc, cnt, p[u], bits[u]);
  }
  if (c < full) {   // the last whole chunks, their loads in flight at once
    Pack<T> p[UNROLL];
    uint32_t bits[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c + u * stride < full) {
        p[u] = load_pack(packs + c + u * stride);
        bits[u] = chunk_bits<VALID>(words, (c + u * stride) * VEC);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c + u * stride < full)
        fold_chunk<T, A, OP, VALID>(acc, cnt, p[u], bits[u]);
  }
  // the ragged end (or every row of an unaligned column), one row each
  for (long long i = full * VEC + tid; i < n; i += stride)
    if (!VALID || ((words[i >> 5] >> (i & 31)) & 1u)) {
      acc = combine<OP>(acc, (A)vals[i]);
      cnt += VALID;
    }
  long long bc = cnt;
  block_reduce<OP>(acc, bc);
  if (threadIdx.x == 0) {
    scratch.partials[blockIdx.x] = acc;
    scratch.counts[blockIdx.x] = bc;
    __threadfence();
    last = atomicAdd(scratch.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial, in block order
  __threadfence();
  acc = identity<OP, A>();
  bc = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) {
    acc = combine<OP>(acc, __ldcg(scratch.partials + i));
    bc += __ldcg(scratch.counts + i);
  }
  block_reduce<OP>(acc, bc);
  if (threadIdx.x == 0) {
    *reinterpret_cast<A*>(out) = acc;
    out[1] = VALID ? bc : n;
    *scratch.ticket = 0;
  }
}

// Blocks of a kernel resident at once on the card: pass 1's grid, so
// that every block runs in one wave and none waits for a second one.
template <typename K>
static int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const int r = sms * per_sm;
  return r < 1 ? 1 : r;
}

template <typename T, typename A, int OP, bool VALID>
static int launch(const void* vals, const void* words, long long n,
                  int aligned, void* scratch, int max_partials, void* out,
                  cudaStream_t s) {
  const auto kernel = reduce_kernel<T, A, OP, VALID>;
  static const int resident = resident_blocks(kernel);  // per kernel
  constexpr int VEC = 16 / sizeof(T);
  const long long need = ((n + VEC - 1) / VEC + THREADS - 1) / THREADS;
  long long grid = need < resident ? need : resident;
  if (grid > max_partials) grid = max_partials;  // one partial per block
  if (grid < 1) grid = 1;
  long long* base = static_cast<long long*>(scratch);
  Scratch<A> sc;
  sc.partials = reinterpret_cast<A*>(base);
  sc.counts = base + max_partials;
  sc.ticket = reinterpret_cast<unsigned int*>(base + 2 * max_partials);
  kernel<<<(int)grid, THREADS, 0, s>>>(static_cast<const T*>(vals),
                                       static_cast<const uint32_t*>(words),
                                       n, aligned, sc,
                                       static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

template <typename T, typename A, int OP>
static int launch(const void* vals, const void* words, long long n,
                  int aligned, void* scratch, int max_partials, void* out,
                  cudaStream_t s) {
  return words ? launch<T, A, OP, true>(vals, words, n, aligned, scratch,
                                        max_partials, out, s)
               : launch<T, A, OP, false>(vals, words, n, aligned, scratch,
                                         max_partials, out, s);
}

// vals: n values (dtype); words: validity words (u32, LSB-first) or
// null; aligned: vals is 16-byte aligned; scratch: 2 * max_partials + 1
// int64 of per-stream scratch (max_partials >= 1 caps the grid), zeroed
// before its first use; out: 2 int64, the accumulator in the first
// bytes of out[0] and the count of valid rows in [0, n) in out[1].
// Returns a CUDA error code.
extern "C" int agt_reduce(int dtype, int op, const void* vals,
                          const void* words, long long n, int aligned,
                          void* scratch, int max_partials, void* out,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (max_partials < 1) return (int)cudaErrorInvalidValue;
#define K3_CASE(D, O, T, A) \
  case D * 4 + O:           \
    return launch<T, A, O>(vals, words, n, aligned, scratch, max_partials, \
                           out, s);
  switch (dtype * 4 + op) {
    K3_CASE(DT_INT32, OP_SUM, int, unsigned long long)
    K3_CASE(DT_INT32, OP_PROD, int, unsigned int)
    K3_CASE(DT_INT32, OP_MIN, int, int)
    K3_CASE(DT_INT32, OP_MAX, int, int)
    K3_CASE(DT_INT64, OP_SUM, long long, unsigned long long)
    K3_CASE(DT_INT64, OP_PROD, long long, unsigned long long)
    K3_CASE(DT_INT64, OP_MIN, long long, long long)
    K3_CASE(DT_INT64, OP_MAX, long long, long long)
    K3_CASE(DT_FLOAT32, OP_SUM, float, float)
    K3_CASE(DT_FLOAT32, OP_PROD, float, float)
    K3_CASE(DT_FLOAT32, OP_MIN, float, float)
    K3_CASE(DT_FLOAT32, OP_MAX, float, float)
    K3_CASE(DT_FLOAT64, OP_SUM, double, double)
    K3_CASE(DT_FLOAT64, OP_PROD, double, double)
    K3_CASE(DT_FLOAT64, OP_MIN, double, double)
    K3_CASE(DT_FLOAT64, OP_MAX, double, double)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K3_CASE
}
