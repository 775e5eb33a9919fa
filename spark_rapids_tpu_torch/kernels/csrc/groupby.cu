// Segmented fold (S1) of the group-by's sort path, for Hopper (sm_90a):
// per group, the sum (float64), min or max of its rows, in one launch.
//
// Replaces no TPU kernel. It stands in for spark_rapids_tpu/ops/
// groupby.py: _seg_scan (a jnp segmented scan, no pallas_call) where the
// sort path sums floats and takes a min or max, and for the scatter of
// float atomics the port used before (index_add_), which contended on a
// few addresses when groups were few and long.
//
// What it computes (kernels/groupby.py seg_fold is its plain version and
// the two agree bit for bit). The rows are sorted by group: group g is
// the sizes[g] >= 1 rows of x from starts[g], groups in row order and not
// overlapping. A node at level L of group g covers its rows
// [i * 8^L, (i + 1) * 8^L), cut at the group's end, and is the in-order
// fold of up to 8 children ((c0 op c1) op c2 ...); a single child is its
// own value. The group's result is its root. No step meets two groups'
// values, nothing is added atomically, and any aligned subtree can be
// folded by any thread: the design below only chooses who folds which.
//
// Bound: device-memory bytes. Each row is read once, starts and sizes
// once, each result written once (float64 at the q5lite step: 8 B a row
// and 24 B a group). The version before this one made one launch a level
// from the host, with a cumulative sum between levels and a binary search
// of the group of every piece; its calls cost 3-5x index_add_ in host
// work. This one is one launch with no host work between levels:
// - a block owns a tile of TILE = 4,096 rows and the groups whose first
//   row lies in it; two warps find them with a 32-way search of starts
//   (log32 of the group count rounds of loads, not a binary search per
//   piece);
// - a group of at most SHORT = 64 rows is folded by one thread;
//   neighbouring threads take neighbouring groups, and a thread loads the
//   first rows of four groups before it folds any (q18's last merge: one
//   or two rows a key, so a thread's latency is one round trip for four
//   groups, not two for each);
// - a group of up to CHUNK = 512 rows (8^3) is one warp's task; a longer
//   group is cut into chunks of CHUNK rows aligned to its first row, and
//   each chunk is the task of a warp of the block whose tile holds the
//   chunk's first row (q13's 209,882-row groups spread over every SM). A
//   warp folds 256 rows at a time, 8 consecutive rows a lane (16-byte
//   loads when the rows are aligned and one column wide): each lane folds
//   its piece in registers, a shuffle chain over 8 lanes folds 8 pieces,
//   and those nodes feed a stack of per-level accumulators, one level a
//   lane;
// - a chunk's node goes to scratch; a counter per long group, tagged with
//   the call's epoch so no memset clears it (an atomicMax raises a stale
//   word to the epoch, an atomicAdd counts), tells the warp that finishes
//   the group's last chunk, and that warp folds the group's nodes in
//   order. At most one long group starts in a CHUNK of rows, so the
//   scratch is two nodes and one counter per CHUNK rows.
//
// The op (add, min, max) is a template parameter, and so is the lane
// type: add over float64; min and max over float32, float64, int8
// (booleans), int16, int32 and int64. min(a, b) is b when b < a or b is
// NaN, else a (max likewise with b > a): NaN wins and a tie keeps the
// earlier value, as the plain version's ops do.
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int W = 8;                // FOLD_WIDTH: children of a node
constexpr long long TILE = 4096;    // rows whose groups a block owns
constexpr long long CHUNK = 512;    // a warp's task of a long group (8^3)
constexpr int SHORT = 64;           // a group of at most this many: a thread
constexpr int UNROLL = 4;           // groups a thread starts at once
// tasks that start in a tile: ranges of more than SHORT rows, and the
// last, shorter chunks of long groups, one per CHUNK rows at most
constexpr int MAX_TASKS =
    (int)(TILE / (SHORT + 1)) + 1 + 2 * (int)(TILE / CHUNK);
constexpr unsigned FULL = 0xffffffffu;

enum Op { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2 };
enum Type { T_F32 = 0, T_F64 = 1, T_I8 = 2, T_I16 = 3, T_I32 = 4,
            T_I64 = 5 };

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }

template <int OP, typename T>
__device__ __forceinline__ T apply(T a, T b) {
  if (OP == OP_ADD) return a + b;
  if (OP == OP_MIN) return (b < a || is_nan(b)) ? b : a;
  return (b > a || is_nan(b)) ? b : a;
}

// loads through the read-only path (ld_nc) and from L2 (ld_cg: chunk
// nodes other blocks wrote during this launch); int64_t as long long,
// which the intrinsics take
template <typename T>
__device__ __forceinline__ T ld_nc(const T* p) { return __ldg(p); }
template <>
__device__ __forceinline__ int64_t ld_nc(const int64_t* p) {
  return (int64_t)__ldg((const long long*)p);
}
template <typename T>
__device__ __forceinline__ T ld_cg(const T* p) { return __ldcg(p); }
template <>
__device__ __forceinline__ int64_t ld_cg(const int64_t* p) {
  return (int64_t)__ldcg((const long long*)p);
}

template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(FULL, v, src);
}
// int8 and int16 travel through a shuffle as int
__device__ __forceinline__ int8_t shfl(int8_t v, int src) {
  return (int8_t)__shfl_sync(FULL, (int)v, src);
}
__device__ __forceinline__ int16_t shfl(int16_t v, int src) {
  return (int16_t)__shfl_sync(FULL, (int)v, src);
}

// Items [i0, i0 + cnt) of a strided column (cnt <= 8; the rest 0): one
// 16-byte load per 16 bytes (8 bytes for int8) when the 8 items are
// contiguous and aligned, else one load each.
template <typename T>
__device__ __forceinline__ void load_piece(const T* p, int cnt, int stride,
                                           T (&v)[W]) {
  constexpr int BYTES = W * (int)sizeof(T);
  constexpr int ALIGN = BYTES >= 16 ? 16 : BYTES;
  if (cnt == W && stride == 1 && ((uintptr_t)p % ALIGN) == 0) {
    if constexpr (BYTES >= 16) {
      union { uint4 r[BYTES / 16]; T t[W]; } u;
#pragma unroll
      for (int k = 0; k < BYTES / 16; ++k)
        u.r[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = u.t[j];
    } else {
      union { uint2 r; T t[W]; } u;
      u.r = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = u.t[j];
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = j < cnt ? ld_nc(p + j * stride) : T(0);
}

template <int OP, typename T>
__device__ __forceinline__ T fold8(const T (&v)[W], int cnt) {
  T acc = v[0];
#pragma unroll
  for (int j = 1; j < W; ++j)
    if (j < cnt) acc = apply<OP>(acc, v[j]);
  return acc;
}

template <typename T>
struct RowItem {  // rows of one column from a first row
  const T* x;
  int m, c;
  long long first;
  __device__ void load8(long long i, int cnt, T (&v)[W]) const {
    load_piece(x + (first + i) * m + c, cnt, m, v);
  }
};

template <typename T>
struct NodeItem {  // the chunk nodes of one long group, in order
  const T* nodes;
  int m, c;
  long long start;
  __device__ void load8(long long k0, int cnt, T (&v)[W]) const {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const long long k = k0 + j;
      const long long sub = (start + k * CHUNK) / CHUNK;
      v[j] = j < cnt ? ld_cg(nodes + (2 * sub + (k == 0)) * m + c) : T(0);
    }
  }
};

// The in-order tree over `count` items, folded by one warp: every lane
// calls it with the same arguments and gets the root. Each slab of 256
// items gives lane l the piece of items base + 8 l .. + 7, which it folds
// in registers; lanes 8 q .. 8 q + 7 fold their pieces into node q
// through a shuffle chain; the (up to 4) nodes are pushed, in order, onto
// a stack whose level k (the node of 8^(k + 3) items being built) lives
// in lane k.
template <int OP, typename T, typename Item>
__device__ T warp_fold(long long count, const Item& item) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  T s_acc = T(0);  // this lane's stack level
  int s_cnt = 0;
  int top = 0;     // levels in use: lanes [0, top)
  for (long long base = 0; base < count; base += 32 * W) {
    const long long p0 = base + (long long)W * lane;
    const int cnt = (int)max(0ll, min((long long)W, count - p0));
    T v[W];
    item.load8(p0, cnt, v);
    const T piece = fold8<OP>(v, cnt);
    const int pieces = (int)min(32ll, (count - base + W - 1) / W);
    T node = shfl(piece, W * q);
#pragma unroll
    for (int t = 1; t < W; ++t) {
      const T y = shfl(piece, W * q + t);
      if (W * q + t < pieces) node = apply<OP>(node, y);
    }
    for (int p = 0; p < 4 && W * p < pieces; ++p) {
      T carry = shfl(node, W * p);
      for (int k = 0;; ++k) {
        int full = 0;
        if (lane == k) {
          s_acc = s_cnt ? apply<OP>(s_acc, carry) : carry;
          full = ++s_cnt == W;
          if (full) s_cnt = 0;
        }
        if (k >= top) top = k + 1;
        if (!__shfl_sync(FULL, full, k)) break;
        carry = shfl(s_acc, k);
      }
    }
  }
  // the rightmost partial node of each level is the last child of the
  // one above it
  T carry = T(0);
  bool has = false;
  for (int k = 0; k < top; ++k) {
    const int c = __shfl_sync(FULL, s_cnt, k);
    const T a = shfl(s_acc, k);
    if (c > 0) {
      carry = has ? apply<OP>(a, carry) : a;
      has = true;
    }
  }
  return carry;
}

// First index i in [lo, hi) with starts[i] >= key, else hi; one warp.
__device__ long long warp_lower_bound(const int64_t* __restrict__ starts,
                                      long long lo, long long hi,
                                      long long key) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long span = hi - lo;
    const long long p = lo + span * (lane + 1) / 33;
    const bool below = ld_nc(starts + p) < key;
    const unsigned b = __ballot_sync(FULL, below);
    const int c = __popc(b);  // the probes below key are a prefix
    const long long p_last = __shfl_sync(FULL, p, c > 0 ? c - 1 : 0);
    const long long p_next = __shfl_sync(FULL, p, c < 32 ? c : 31);
    if (c > 0) lo = p_last + 1;
    if (c < 32) hi = p_next;
  }
  return lo;
}

template <typename T>
struct Args {
  const T* x;
  int m;
  const int64_t* starts;
  const int64_t* sizes;
  long long groups;
  T* out;                       // [groups, m]
  T* nodes;                     // [2 * ceil(n / CHUNK), m]: chunk nodes
  unsigned long long* counter;  // [ceil(n / CHUNK)]: epoch << 32 | done
  unsigned epoch;
};

// A group of at most SHORT rows, column c, by one thread; `first` is its
// first row, already loaded.
template <int OP, typename T>
__device__ T thread_fold(const Args<T>& a, long long s, long long size,
                         int c, T first) {
  const T* r = a.x + s * a.m + c;
  T res = first;
  for (long long p = 0; p < size; p += W) {
    const int cnt = (int)min((long long)W, size - p);
    T v[W];
    load_piece(r + p * a.m, cnt, a.m, v);
    if (p == 0) v[0] = first;
    const T piece = fold8<OP>(v, cnt);
    res = p ? apply<OP>(res, piece) : piece;
  }
  return res;
}

// Task t of the block's list, by one warp: a whole group (k < 0) into
// out, or chunk k of a long group into the scratch; the warp that
// completes a long group's last chunk folds its nodes into out.
template <int OP, typename T>
__device__ void warp_task(const Args<T>& a, long long g, long long s,
                          long long size, int k) {
  const int lane = threadIdx.x & 31;
  if (k < 0) {
    for (int c = 0; c < a.m; ++c) {
      const T r = warp_fold<OP, T>(size, RowItem<T>{a.x, a.m, c, s});
      if (lane == 0) a.out[g * a.m + c] = r;
    }
    return;
  }
  const long long c0 = s + k * CHUNK;
  const long long len = min(CHUNK, size - k * CHUNK);
  const long long sub = c0 / CHUNK;
  for (int c = 0; c < a.m; ++c) {
    const T r = warp_fold<OP, T>(len, RowItem<T>{a.x, a.m, c, c0});
    if (lane == 0) a.nodes[(2 * sub + (k == 0)) * a.m + c] = r;
  }
  const long long chunks = (size + CHUNK - 1) / CHUNK;
  int last = 0;
  if (lane == 0) {
    __threadfence();  // the nodes, before the count that publishes them
    // epoch << 32 | chunks done: a word of an earlier call (a smaller
    // epoch) is raised to this epoch with none done, then counted; no
    // compare-and-swap loop, so hundreds of chunks of one group do not
    // retry against each other
    unsigned long long* w = a.counter + s / CHUNK;
    const unsigned long long tag = (unsigned long long)a.epoch << 32;
    atomicMax(w, tag);
    const unsigned long long before = atomicAdd(w, 1ull);
    last = (long long)(unsigned)before + 1 == chunks;
    __threadfence();
  }
  __syncwarp();
  if (!__shfl_sync(FULL, last, 0)) return;
  for (int c = 0; c < a.m; ++c) {
    const T r = warp_fold<OP, T>(chunks, NodeItem<T>{a.nodes, a.m, c, s});
    if (lane == 0) a.out[g * a.m + c] = r;
  }
}

template <int OP, typename T>
__global__ void __launch_bounds__(THREADS) seg_fold_kernel(Args<T> a) {
  __shared__ long long s_bounds[2];
  __shared__ long long s_tg[MAX_TASKS], s_ts[MAX_TASKS], s_tz[MAX_TASKS];
  __shared__ int s_tk[MAX_TASKS];
  __shared__ int s_ntasks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * TILE;
  const long long r1 = r0 + TILE;

  // the groups whose first row lies in [r0, r1)
  if (warp < 2) {
    const long long at =
        warp_lower_bound(a.starts, 0, a.groups, warp ? r1 : r0);
    if (lane == 0) s_bounds[warp] = at;
  }
  if (threadIdx.x == 0) s_ntasks = 0;
  __syncthreads();
  const long long ga = s_bounds[0], gb = s_bounds[1];

  // chunks of the long group that covers r0, if any, that start here
  if (threadIdx.x == 0 && ga > 0) {
    const long long s = ld_nc(a.starts + ga - 1);
    const long long size = ld_nc(a.sizes + ga - 1);
    if (size > CHUNK && s < r0 && r0 < s + size) {
      for (long long k = (r0 - s + CHUNK - 1) / CHUNK;
           k * CHUNK < size && s + k * CHUNK < r1; ++k) {
        const int t = atomicAdd(&s_ntasks, 1);
        s_tg[t] = ga - 1;
        s_ts[t] = s;
        s_tz[t] = size;
        s_tk[t] = (int)k;
      }
    }
  }
  // short groups by thread, UNROLL at a time; the rest become tasks
  for (long long g0 = ga + threadIdx.x; g0 < gb;
       g0 += (long long)UNROLL * THREADS) {
    long long s[UNROLL], z[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + (long long)u * THREADS;
      s[u] = g < gb ? ld_nc(a.starts + g) : 0;
      z[u] = g < gb ? ld_nc(a.sizes + g) : 0;
    }
    for (int c = 0; c < a.m; ++c) {
      T first[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        first[u] = z[u] > 0 && z[u] <= SHORT
                       ? ld_nc(a.x + s[u] * a.m + c) : T(0);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (z[u] > 0 && z[u] <= SHORT)
          a.out[(g0 + (long long)u * THREADS) * a.m + c] =
              thread_fold<OP, T>(a, s[u], z[u], c, first[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (z[u] <= SHORT) continue;
      const long long g = g0 + (long long)u * THREADS;
      if (z[u] <= CHUNK) {
        const int t = atomicAdd(&s_ntasks, 1);
        s_tg[t] = g;
        s_ts[t] = s[u];
        s_tz[t] = z[u];
        s_tk[t] = -1;
        continue;
      }
      for (long long k = 0; k * CHUNK < z[u] && s[u] + k * CHUNK < r1;
           ++k) {
        const int t = atomicAdd(&s_ntasks, 1);
        s_tg[t] = g;
        s_ts[t] = s[u];
        s_tz[t] = z[u];
        s_tk[t] = (int)k;
      }
    }
  }
  __syncthreads();
  for (int t = warp; t < s_ntasks; t += WARPS)
    warp_task<OP, T>(a, s_tg[t], s_ts[t], s_tz[t], s_tk[t]);
}

template <int OP, typename T>
int launch(const void* x, int m, long long n, const void* starts,
           const void* sizes, long long groups, void* out, void* nodes,
           void* counter, unsigned epoch, cudaStream_t stream) {
  Args<T> a;
  a.x = (const T*)x;
  a.m = m;
  a.starts = (const int64_t*)starts;
  a.sizes = (const int64_t*)sizes;
  a.groups = groups;
  a.out = (T*)out;
  a.nodes = (T*)nodes;
  a.counter = (unsigned long long*)counter;
  a.epoch = epoch;
  const long long tiles = (n + TILE - 1) / TILE;
  seg_fold_kernel<OP, T><<<(unsigned)tiles, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int OP>
int by_type(int type, const void* x, int m, long long n, const void* st,
            const void* sz, long long groups, void* out, void* nodes,
            void* counter, unsigned epoch, cudaStream_t s) {
  switch (type) {
    case T_F32: return launch<OP, float>(x, m, n, st, sz, groups, out, nodes,
                                         counter, epoch, s);
    case T_F64: return launch<OP, double>(x, m, n, st, sz, groups, out,
                                          nodes, counter, epoch, s);
    case T_I8: return launch<OP, int8_t>(x, m, n, st, sz, groups, out, nodes,
                                         counter, epoch, s);
    case T_I16: return launch<OP, int16_t>(x, m, n, st, sz, groups, out,
                                           nodes, counter, epoch, s);
    case T_I32: return launch<OP, int32_t>(x, m, n, st, sz, groups, out,
                                           nodes, counter, epoch, s);
    case T_I64: return launch<OP, int64_t>(x, m, n, st, sz, groups, out,
                                           nodes, counter, epoch, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Rows of one scratch slot: the scratch holds, per this many rows of x
// (rounded up), two chunk nodes of m elements and one 8-byte counter.
long long srt_seg_fold_chunk() { return CHUNK; }

// x: [n, m] row-major of `type`; starts, sizes: int64[groups], groups in
// row order, sizes >= 1; out: [groups, m]; with slots = ceil(n / CHUNK),
// nodes: 2 * slots * m elements; counter: slots 8-byte words, zeroed
// once when allocated and then only ever tagged with a new epoch (1 + the
// number of earlier calls on this scratch, below 2^32); one stream at a
// time. op: add (float64 only),
// min or max. One kernel launch.
int srt_seg_fold(int op, int type, const void* x, int m, long long n,
                 const void* starts, const void* sizes, long long groups,
                 void* out, void* nodes, void* counter, unsigned epoch,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (groups <= 0 || n <= 0 || m <= 0) return (int)cudaGetLastError();
  if (op == OP_ADD) {
    if (type != T_F64) return (int)cudaErrorInvalidValue;
    return launch<OP_ADD, double>(x, m, n, starts, sizes, groups, out,
                                  nodes, counter, epoch, s);
  }
  if (op == OP_MIN)
    return by_type<OP_MIN>(type, x, m, n, starts, sizes, groups, out, nodes,
                           counter, epoch, s);
  if (op == OP_MAX)
    return by_type<OP_MAX>(type, x, m, n, starts, sizes, groups, out, nodes,
                           counter, epoch, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
