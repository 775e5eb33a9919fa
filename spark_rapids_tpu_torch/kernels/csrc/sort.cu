// Partition (K1) and LSD radix argsort (K2) kernels for Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/native/kernels/sort.py: partition_order (the
// stable mask-true-first permutation) and radix_order (the stable LSD
// binary-radix argsort over order-preserving unsigned key views).
//
// Both are bound by device-memory bytes, not arithmetic.
//
// K1 reads one byte and writes four per row, and is bound by those bytes
// (and, below a few million rows, by its one launch). One launch per
// call, a persistent grid of co-resident blocks (a cooperative launch),
// each owning a contiguous run of 4,096-row tiles:
// - the block counts its trues with 16-byte loads of the mask (four
//   tiles' loads in flight), one __vcmpne4 per 4 bytes and one __popc
//   per 16, and publishes the count in a status word tagged with the
//   call's epoch, so no memset clears stale words of an earlier call;
// - it waits for every block's word of this epoch. A one-sweep
//   look-back would give a tile the trues before it, but a false row's
//   place, n_true + its false-rank, needs every tile's count: the true
//   count of the whole mask, which the last tile would learn last. The
//   wait is safe because all blocks are resident. The mask is read a
//   second time (1 B a row against the 4 written);
// - per tile, with the next tile's load already in flight, it ranks
//   rows by a block scan of (valid, true) counts, stages the tile
//   partitioned in shared memory (its trues, then its falses, each in
//   row order) and writes both runs to consecutive addresses, so the
//   4-byte stores coalesce;
// - block 0 writes n_true, which the host copies back once per call.
// An input of at most one tile runs on one block with no wait. The mask
// may start anywhere: loads cover the 16-byte chunks that hold it and
// mask out the bytes outside it.
//
// K2's bound is its keys read once and the int32 permutation written
// once. Above that bound it pays for its passes:
// - one histogram launch reads every key once and counts every 8-bit
//   digit of every key (a histogram does not depend on row order);
// - a pass whose digit is the same for all rows is the identity and is
//   skipped: the host reads the pass flags back (one small copy and one
//   stream synchronisation per call). Keys of a narrow range (customer
//   ids below 2^20 in int64) keep 3 of their 8 passes;
// - each remaining pass is one kernel in the one-sweep scheme: tile ids
//   from an atomic counter, ranking in shared memory with
//   warp ballots, decoupled look-back over earlier tiles for the
//   global digit offsets, and a reorder by digit in shared memory so
//   each digit run is written to consecutive addresses. A pass reads
//   (u64 key, i32 index) and writes them back, 24 B a row; the first
//   pass run reads the key alone, a later key's first pass gathers it
//   through the permutation, and a key's last pass writes the index
//   alone.
//
// Plain C interface for ctypes; every entry point launches on the stream
// it is given, allocates nothing (scratch comes from the caller) and
// returns cudaGetLastError() or the first failing call's error.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;                // K2: 8-bit digits

__host__ __device__ inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// Exclusive scan of one int per thread across the block. Writes the block
// total to *total. All threads must call it; smem holds WARPS + 1 ints.
__device__ int block_exclusive_scan(int v, int* total, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? smem[lane] : 0;
    int s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < WARPS) smem[lane] = s - w;
    if (lane == WARPS - 1) smem[WARPS] = s;
  }
  __syncthreads();
  int out = x - v + smem[warp];
  *total = smem[WARPS];
  __syncthreads();
  return out;
}

// ---- K1: partition_order ---------------------------------------------------

constexpr int K1_VEC = 16;                    // mask bytes a thread loads
constexpr int K1_TILE = THREADS * K1_VEC;     // 4,096 rows a tile
constexpr int K1_MAX_BLOCKS = 4096;           // status words in the scratch

// bit k set when mask byte k of the 16 is nonzero
__device__ __forceinline__ unsigned true_bits(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned ne = __vcmpne4(w[j], 0u);  // 0xff in each nonzero byte
    bits |= (((ne >> 7) & 1u) | ((ne >> 14) & 2u) | ((ne >> 21) & 4u) |
             ((ne >> 28) & 8u)) << (4 * j);
  }
  return bits;
}

struct K1Args {
  const uint8_t* chunks;  // the mask rounded down to 16 bytes
  int head;               // mask - chunks: chunk byte v holds row v - head
  int n;
  int* out;
  unsigned long long* status;  // [gridDim.x]: epoch << 32 | trues
  unsigned epoch;
  int* n_true;
};

// Rows of chunk bytes [c, c + 16) inside the mask, as a bit set.
__device__ __forceinline__ unsigned valid_bits(const K1Args& a, long long c) {
  const long long lo = max(0ll, (long long)a.head - c);
  const long long hi = min(16ll, (long long)a.head + a.n - c);
  if (hi <= lo) return 0u;
  return ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

__device__ __forceinline__ uint4 load_chunk(const K1Args& a, long long c) {
  if (c >= (long long)a.head + a.n) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(a.chunks + c));
}

__global__ void __launch_bounds__(THREADS) k1_partition(K1Args a) {
  __shared__ int s_rows[K1_TILE];  // a tile, partitioned
  __shared__ int scan_smem[WARPS + 1];
  __shared__ int s_red[2][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nchunk = (long long)a.head + a.n;
  const int ntiles = cdiv(nchunk, K1_TILE);
  // block b owns tiles [t0, t1), contiguous and in block order
  const int per = ntiles / gridDim.x, extra = ntiles % gridDim.x;
  const int t0 = blockIdx.x * per + min((int)blockIdx.x, extra);
  const int t1 = t0 + per + ((int)blockIdx.x < extra ? 1 : 0);

  // count this block's trues, four tiles' loads in flight at a time;
  // keep the first tile's bits in registers
  const long long lane0 = (long long)threadIdx.x * K1_VEC;
  const long long c_first = (long long)t0 * K1_TILE + lane0;
  const unsigned first_bits =
      true_bits(load_chunk(a, c_first)) & valid_bits(a, c_first);
  int mine = __popc(first_bits);
  for (int t = t0 + 1; t < t1; t += 4) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = t + u < t1 ? load_chunk(a, (long long)(t + u) * K1_TILE + lane0)
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (t + u < t1)
        mine += __popc(true_bits(v[u]) &
                       valid_bits(a, (long long)(t + u) * K1_TILE + lane0));
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) s_red[0][warp] = mine;
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) count += s_red[0][w];

  // trues before this block, and in all
  int before = 0, n_true = count;
  if (gridDim.x > 1) {
    volatile unsigned long long* st = a.status;
    if (threadIdx.x == 0)
      st[blockIdx.x] = ((unsigned long long)a.epoch << 32) | (unsigned)count;
    int b_sum = 0, t_sum = 0;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS) {
      unsigned long long v;
      do {
        v = st[j];
      } while ((unsigned)(v >> 32) != a.epoch);
      const int c = (int)(unsigned)v;
      t_sum += c;
      if (j < (int)blockIdx.x) b_sum += c;
    }
    b_sum = __reduce_add_sync(0xffffffffu, b_sum);
    t_sum = __reduce_add_sync(0xffffffffu, t_sum);
    __syncthreads();  // s_red[0] was read above
    if (lane == 0) {
      s_red[0][warp] = b_sum;
      s_red[1][warp] = t_sum;
    }
    __syncthreads();
    n_true = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      before += s_red[0][w];
      n_true += s_red[1][w];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.n_true = n_true;

  // rows before the block's first tile, and the falses among them
  int true_base = before;
  int false_base =
      (int)max(0ll, (long long)t0 * K1_TILE - a.head) - before;
  // the next tile's chunk is loaded while this one is ranked and written
  uint4 ahead = t0 + 1 < t1 ? load_chunk(a, c_first + K1_TILE)
                            : make_uint4(0u, 0u, 0u, 0u);
  for (int t = t0; t < t1; ++t) {
    const long long c = (long long)t * K1_TILE + lane0;
    const unsigned valid = valid_bits(a, c);
    unsigned trues = first_bits;
    if (t > t0) {
      trues = true_bits(ahead) & valid;
      if (t + 1 < t1) ahead = load_chunk(a, c + K1_TILE);
    }
    // (valid rows << 16 | true rows) before this thread, and in the tile
    int total;
    const int excl = block_exclusive_scan(
        (__popc(valid) << 16) | __popc(trues), &total, scan_smem);
    const int tile_trues = total & 0xffff, tile_rows = total >> 16;
    int ti = excl & 0xffff;
    int fi = tile_trues + (excl >> 16) - ti;
    const int row0 = (int)(c - a.head);
#pragma unroll
    for (int k = 0; k < K1_VEC; ++k) {
      if (!((valid >> k) & 1u)) continue;
      if ((trues >> k) & 1u)
        s_rows[ti++] = row0 + k;
      else
        s_rows[fi++] = row0 + k;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < tile_rows; j += THREADS)
      a.out[j < tile_trues ? true_base + j
                           : n_true + false_base + (j - tile_trues)] =
          s_rows[j];
    true_base += tile_trues;
    false_base += tile_rows - tile_trues;
    __syncthreads();  // s_rows is rewritten by the next tile
  }
}

// ---- K2: radix_order -------------------------------------------------------

// key type codes (the Python wrapper maps torch dtypes onto them)
enum KeyType { K_BOOL = 0, K_I8 = 1, K_I16 = 2, K_I32 = 3, K_I64 = 4 };

// Order-isomorphic unsigned view: bool as 0/1, narrow signed ints shifted
// by 2^(bits-1) into [0, 2^bits), int64 with its sign bit flipped.
template <int KT>
__device__ __forceinline__ uint64_t ukey(const void* p, long long i) {
  if (KT == K_BOOL) return ((const uint8_t*)p)[i] ? 1ull : 0ull;
  if (KT == K_I8)
    return (uint64_t)((int64_t)((const int8_t*)p)[i] + (1ll << 7));
  if (KT == K_I16)
    return (uint64_t)((int64_t)((const int16_t*)p)[i] + (1ll << 15));
  if (KT == K_I32)
    return (uint64_t)((int64_t)((const int32_t*)p)[i] + (1ll << 31));
  return (uint64_t)((const int64_t*)p)[i] ^ 0x8000000000000000ull;
}

__device__ __forceinline__ uint64_t unsigned_key(const void* p, int kt,
                                                 long long i) {
  switch (kt) {
    case K_BOOL:
      return ukey<K_BOOL>(p, i);
    case K_I8:
      return ukey<K_I8>(p, i);
    case K_I16:
      return ukey<K_I16>(p, i);
    case K_I32:
      return ukey<K_I32>(p, i);
    default:
      return ukey<K_I64>(p, i);
  }
}

__device__ __forceinline__ int digit_of(uint64_t u, int shift, int dbits) {
  return (int)((u >> shift) & ((1ull << dbits) - 1));
}

// One launch of the histogram covers a group of keys: at most GROUP_KEYS
// keys, so at most GROUP_KEYS * 8 digit passes (64 KB of shared counts).
constexpr int GROUP_KEYS = 8;
constexpr int H_ITEMS = 8;                  // histogram: rows per thread
constexpr int H_TILE = THREADS * H_ITEMS;   // per block and round

struct KeyGroup {
  const void* key[GROUP_KEYS];
  int type[GROUP_KEYS];
  int width[GROUP_KEYS];
  int pass0[GROUP_KEYS];  // the key's first pass, counted in the group
  int nkeys;
  int npasses;
};

// Counts every 8-bit digit of one key (width w) into hk[pass][RADIX];
// the loads of a round are issued together.
template <int KT>
__device__ void hist_key(const void* key, int w, int n, int* hk) {
  const int npk = (w + 7) / 8;
  const int ntiles = cdiv(n, H_TILE);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long t0 = (long long)t * H_TILE + threadIdx.x;
    uint64_t u[H_ITEMS];
#pragma unroll
    for (int it = 0; it < H_ITEMS; ++it) {
      const long long e = t0 + (long long)it * THREADS;
      u[it] = e < n ? ukey<KT>(key, e) : 0;
    }
#pragma unroll
    for (int it = 0; it < H_ITEMS; ++it) {
      if (t0 + (long long)it * THREADS >= n) break;
#pragma unroll
      for (int p = 0; p < 8; ++p)
        if (p < npk)
          atomicAdd(&hk[p * RADIX + digit_of(u[it], 8 * p,
                                             w - 8 * p < 8 ? w - 8 * p : 8)],
                    1);
    }
  }
}

// Digit histograms of every pass of every key of the group, from the raw
// key arrays (a histogram does not depend on row order). The last block
// to finish turns each pass's counts into exclusive digit offsets (in
// place, a warp per pass) and flags the pass trivial when one digit
// holds all n rows.
__global__ void __launch_bounds__(THREADS)
    k2_hist(KeyGroup g, int n, int* hist, unsigned* done, int* trivial) {
  extern __shared__ int h[];  // [npasses][RADIX]
  __shared__ bool last;
  const int cells = g.npasses * RADIX;
  for (int i = threadIdx.x; i < cells; i += THREADS) h[i] = 0;
  __syncthreads();
  for (int k = 0; k < g.nkeys; ++k) {
    int* hk = h + g.pass0[k] * RADIX;
    switch (g.type[k]) {
      case K_BOOL:
        hist_key<K_BOOL>(g.key[k], g.width[k], n, hk);
        break;
      case K_I8:
        hist_key<K_I8>(g.key[k], g.width[k], n, hk);
        break;
      case K_I16:
        hist_key<K_I16>(g.key[k], g.width[k], n, hk);
        break;
      case K_I32:
        hist_key<K_I32>(g.key[k], g.width[k], n, hk);
        break;
      default:
        hist_key<K_I64>(g.key[k], g.width[k], n, hk);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += THREADS)
    if (h[i]) atomicAdd(&hist[i], h[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < g.npasses; p += WARPS) {
    int* hp = hist + p * RADIX + lane * 8;  // lane owns 8 digits
    int c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = __ldcg(hp + j);
    int sum = 0;
    bool all = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      all |= c[j] == n;
      const int v = c[j];
      c[j] = sum;
      sum += v;
    }
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) hp[j] = c[j] + x - sum;
    const unsigned any = __ballot_sync(0xffffffffu, all);
    if (lane == 0) trivial[p] = any != 0u;
  }
}

// How a pass reads its rows: the key straight from its array (the first
// pass run, under the identity permutation), the key gathered through
// the permutation so far (a later key's first pass), or the key's
// unsigned view carried in row order by the previous pass.
enum PassMode { M_DIRECT = 0, M_GATHER = 1, M_CARRIED = 2 };

struct Pass {
  const void* key;
  int type;
  int mode;
  int shift, dbits;
  const uint64_t* u_in;
  const int* idx_in;
  uint64_t* u_out;  // null on the key's last pass
  int* idx_out;
  const int* offsets;  // RADIX exclusive digit offsets of this pass
  unsigned* tile_counter;
  unsigned long long* status;  // [tiles][RADIX], tagged with epoch
  unsigned epoch;              // 1 + the pass's number in this call
  int n;
};

// A pass's tile: 3,072 rows, 12 a thread. At 80 registers a thread
// three blocks fit an SM; 16 rows a thread spill there.
constexpr int P_ITEMS = 12;
constexpr int P_TILE = THREADS * P_ITEMS;
constexpr size_t P_SMEM =  // 46 KB: under the 48 KB default limit
    (size_t)P_TILE * (8 + 4) + (size_t)(WARPS + 2) * RADIX * 4;

// status word: epoch (30 bits) | flag (2 bits) | count (32 bits)
constexpr unsigned long long F_AGG = 1, F_INCL = 2;

__device__ __forceinline__ unsigned long long status_word(
    unsigned epoch, unsigned long long flag, int count) {
  return ((unsigned long long)epoch << 34) | (flag << 32) | (unsigned)count;
}

// One stable 8-bit counting pass, one kernel (the one-sweep scheme). A
// block takes the next tile id from a counter, so every tile before it
// belongs to a block already running. It counts its tile's digits first
// (per-warp shared counters) and publishes them at once, then ranks its
// rows in index order: each warp walks its P_ITEMS rounds of 32 rows,
// one ballot per digit bit finds the lanes that share a lane's digit (on
// this card cheaper than __match_any_sync), and a group's leader takes the
// group's slots from the warp's counter. Rows land in shared memory at
// their rank, ordered by digit. The block then looks back over the tiles
// before it for their digit counts (decoupled look-back), and each
// digit's rows go out to consecutive addresses. Three blocks fit an SM,
// so one block's loads overlap the others' ranking.
__global__ void __launch_bounds__(THREADS, 3) k2_pass(Pass a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_u = (uint64_t*)smem;           // [P_TILE]
  int* s_idx = (int*)(s_u + P_TILE);         // [P_TILE]
  int* s_warp = s_idx + P_TILE;              // [WARPS][RADIX]
  int* s_start = s_warp + WARPS * RADIX;     // [RADIX]
  int* s_base = s_start + RADIX;             // [RADIX]
  __shared__ int scan_smem[WARPS + 1];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(a.tile_counter, 1u);
  for (int i = threadIdx.x; i < WARPS * RADIX; i += THREADS) s_warp[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long tile0 = (long long)tile * P_TILE;
  const int rows = (int)min((long long)P_TILE, (long long)a.n - tile0);
  const long long w0 = tile0 + (long long)warp * 32 * P_ITEMS + lane;
  int* wc = s_warp + warp * RADIX;

  uint64_t u[P_ITEMS];
  int ix[P_ITEMS];
#pragma unroll
  for (int it = 0; it < P_ITEMS; ++it) {
    const long long e = w0 + it * 32;
    u[it] = 0;
    ix[it] = 0;
    if (e < a.n) {
      if (a.mode == M_DIRECT) {
        ix[it] = (int)e;
        u[it] = unsigned_key(a.key, a.type, e);
      } else {
        ix[it] = a.idx_in[e];
        u[it] = a.mode == M_GATHER ? unsigned_key(a.key, a.type, ix[it])
                                   : a.u_in[e];
      }
    }
  }
#pragma unroll
  for (int it = 0; it < P_ITEMS; ++it)
    if (w0 + it * 32 < a.n) atomicAdd(&wc[digit_of(u[it], a.shift, a.dbits)], 1);
  __syncthreads();
  // thread t owns digit t (THREADS == RADIX): warp offsets, tile count
  const int t = threadIdx.x;
  int count = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = s_warp[w * RADIX + t];
    s_warp[w * RADIX + t] = count;
    count += c;
  }
  volatile unsigned long long* st = a.status;
  st[(long long)tile * RADIX + t] =
      status_word(a.epoch, tile == 0 ? F_INCL : F_AGG, count);
  int total;
  s_start[t] = block_exclusive_scan(count, &total, scan_smem);
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < P_ITEMS; ++it) {
    const bool valid = w0 + it * 32 < a.n;
    const int d = valid ? digit_of(u[it], a.shift, a.dbits) : RADIX;
    unsigned peers = __ballot_sync(0xffffffffu, valid);
    peers = valid ? peers : ~peers;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b < a.dbits) {
        const bool bit = (d >> b) & 1;
        const unsigned bal = __ballot_sync(0xffffffffu, bit);
        peers &= bit ? bal : ~bal;
      }
    }
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    if (valid && lane == leader) {
      slot = wc[d];
      wc[d] = slot + __popc(peers);
    }
    slot = __shfl_sync(0xffffffffu, slot, leader);
    if (valid) {
      const int pos = s_start[d] + slot + __popc(peers & lt);
      s_u[pos] = u[it];
      s_idx[pos] = ix[it];
    }
    __syncwarp();
  }
  // decoupled look-back: sum the counts of digit t over earlier tiles
  int before = 0;
  for (int j = tile - 1; j >= 0; --j) {
    unsigned long long v;
    do {
      v = st[(long long)j * RADIX + t];
    } while ((unsigned)(v >> 34) != a.epoch || ((v >> 32) & 3ull) == 0);
    before += (int)(unsigned)v;
    if (((v >> 32) & 3ull) == F_INCL) break;
  }
  if (tile > 0)
    st[(long long)tile * RADIX + t] =
        status_word(a.epoch, F_INCL, before + count);
  s_base[t] = a.offsets[t] + before - s_start[t];
  __syncthreads();
  for (int p = threadIdx.x; p < rows; p += THREADS) {
    const uint64_t v = s_u[p];
    const int pos = s_base[digit_of(v, a.shift, a.dbits)] + p;
    a.idx_out[pos] = s_idx[p];
    if (a.u_out) a.u_out[pos] = v;
  }
}

__global__ void k2_iota(int* out, int n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = (int)i;
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

// Scratch of one radix_order call, in this order: the zeroed block
// (digit offsets of every pass, trivial flags, the histogram launches'
// done counters, one tile counter per pass, then the look-back status
// words), the carried keys (two u64 buffers) and a second int32 index
// buffer.
struct K2Layout {
  size_t status, zeroed, u_a, u_b, idx, total;
  int npasses, ngroups, ntiles;
};

K2Layout k2_layout(int n, int nkeys, const int* widths) {
  K2Layout l;
  l.npasses = 0;
  for (int k = 0; k < nkeys; ++k) l.npasses += (widths[k] + 7) / 8;
  l.ngroups = cdiv(nkeys, GROUP_KEYS);
  l.ntiles = cdiv(n, P_TILE);
  l.status = align_up(((size_t)l.npasses * (RADIX + 2) + l.ngroups) * 4);
  l.zeroed = l.status + (size_t)l.ntiles * RADIX * 8;
  l.u_a = align_up(l.zeroed);
  l.u_b = l.u_a + align_up((size_t)n * 8);
  l.idx = l.u_b + align_up((size_t)n * 8);
  l.total = l.idx + align_up((size_t)n * 4);
  return l;
}

}  // namespace

extern "C" {

// Bytes of K1's scratch, whatever n: the blocks' status words, then
// n_true. Zeroed once when allocated; calls tag their words with a new
// epoch each, so it is never cleared again.
size_t srt_k1_scratch_bytes() { return (size_t)K1_MAX_BLOCKS * 8 + 8; }

// mask: n bytes (0/1); out: int32[n]; scratch: srt_k1_scratch_bytes()
// bytes, used by one stream at a time; epoch: 1 + the number of earlier
// calls on this scratch (below 2^32); n_true_host: pinned host int32 that
// receives the true count, or null for none. One kernel launch (plus one
// 4-byte device-to-host copy when n_true_host is given); the caller
// synchronises the stream before it reads *n_true_host.
int srt_k1_partition_order(const void* mask, int n, void* out,
                           void* scratch, unsigned epoch, void* n_true_host,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  // per device, once: how many blocks can be resident at a time
  static int resident_of[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& resident = resident_of[dev & 63];
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k1_partition,
                                                  THREADS, 0);
    resident = std::min(sms * per_sm, K1_MAX_BLOCKS);
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  K1Args a;
  a.head = (int)((uintptr_t)mask & 15u);
  a.chunks = (const uint8_t*)mask - a.head;
  a.n = n;
  a.out = (int*)out;
  a.status = (unsigned long long*)scratch;
  a.epoch = epoch;
  a.n_true = (int*)((char*)scratch + (size_t)K1_MAX_BLOCKS * 8);
  const int ntiles = cdiv((long long)a.head + n, K1_TILE);
  const int grid = std::min(ntiles, resident);
  cudaError_t err;
  if (grid == 1) {
    k1_partition<<<1, THREADS, 0, s>>>(a);
    err = cudaGetLastError();
  } else {
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)k1_partition, grid,
                                      THREADS, args, 0, s);
  }
  if (err != cudaSuccess) return (int)err;
  if (n_true_host)
    err = cudaMemcpyAsync(n_true_host, a.n_true, 4, cudaMemcpyDeviceToHost,
                          s);
  return (int)err;
}

size_t srt_k2_scratch_bytes(int n, int nkeys, const int* widths) {
  return k2_layout(n, nkeys, widths).total;
}

// keys[k]: device pointers, most significant key first; key_types[k]:
// KeyType codes; widths[k]: bits to sort on (<= the key's own width).
// out: int32[n], the stable ascending permutation; scratch:
// srt_k2_scratch_bytes(n, nkeys, widths) bytes.
//
// The host reads the trivial-pass flags back (one small device-to-host
// copy and one stream synchronisation per call), so a skipped pass costs
// no launch. Launches: one histogram per group of 8 keys, then one kernel
// per pass whose digit varies (one iota kernel if none does).
int srt_k2_radix_order(int nkeys, void* const* keys, const int* key_types,
                       const int* widths, int n, void* out, void* scratch,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || nkeys <= 0) return (int)cudaGetLastError();
  const K2Layout l = k2_layout(n, nkeys, widths);
  char* base = (char*)scratch;
  int* offsets = (int*)base;  // [npasses][RADIX]
  int* trivial = offsets + (size_t)l.npasses * RADIX;
  unsigned* done = (unsigned*)(trivial + l.npasses);
  unsigned* tile_counters = done + l.ngroups;
  unsigned long long* status = (unsigned long long*)(base + l.status);
  uint64_t* u_buf[2] = {(uint64_t*)(base + l.u_a), (uint64_t*)(base + l.u_b)};
  int* idx_tmp = (int*)(base + l.idx);
  cudaError_t err = cudaMemsetAsync(base, 0, l.zeroed, s);
  if (err != cudaSuccess) return (int)err;
  // key k's passes are numbered from first_pass[k], low digit first
  std::vector<int> first_pass(nkeys + 1, 0);
  for (int k = 0; k < nkeys; ++k)
    first_pass[k + 1] = first_pass[k] + (widths[k] + 7) / 8;

  std::vector<int> skip(l.npasses);
  if (l.npasses > 0) {
    // per device, once: the SM count and the histogram's shared memory
    static int sms_of[64];
    int dev = 0;
    cudaGetDevice(&dev);
    int& sms = sms_of[dev & 63];
    if (sms == 0) {
      cudaFuncSetAttribute(k2_hist,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           GROUP_KEYS * 8 * RADIX * 4);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const int hist_blocks = std::min(cdiv(n, H_TILE), 4 * sms);
    for (int g0 = 0; g0 < nkeys; g0 += GROUP_KEYS) {
      KeyGroup g;
      g.nkeys = std::min(GROUP_KEYS, nkeys - g0);
      g.npasses = first_pass[g0 + g.nkeys] - first_pass[g0];
      for (int k = 0; k < g.nkeys; ++k) {
        g.key[k] = keys[g0 + k];
        g.type[k] = key_types[g0 + k];
        g.width[k] = widths[g0 + k];
        g.pass0[k] = first_pass[g0 + k] - first_pass[g0];
      }
      if (g.npasses > 0)
        k2_hist<<<hist_blocks, THREADS, (size_t)g.npasses * RADIX * 4, s>>>(
            g, n, offsets + (size_t)first_pass[g0] * RADIX,
            done + g0 / GROUP_KEYS, trivial + first_pass[g0]);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = cudaMemcpyAsync(skip.data(), trivial, (size_t)l.npasses * 4,
                          cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaStreamSynchronize(s)) != cudaSuccess) return (int)err;
  }

  // the passes to run, least significant key and digit first
  struct Run { int key, pass, shift, dbits; };
  std::vector<Run> runs;
  for (int k = nkeys - 1; k >= 0; --k)
    for (int shift = 0; shift < widths[k]; shift += 8) {
      const int p = first_pass[k] + shift / 8;
      if (!skip[p])
        runs.push_back({k, p, shift, std::min(8, widths[k] - shift)});
    }
  const int e = (int)runs.size();
  if (e == 0) {  // every digit constant: the identity
    k2_iota<<<cdiv(n, THREADS), THREADS, 0, s>>>((int*)out, n);
    return (int)cudaGetLastError();
  }
  // a key's first pass reads the key itself, each later one what the
  // pass before wrote; the index buffers alternate so that the last
  // pass writes `out`
  const int* idx_prev = nullptr;
  const uint64_t* u_prev = nullptr;
  for (int i = 0; i < e; ++i) {
    const Run& r = runs[i];
    const bool key_first = i == 0 || runs[i - 1].key != r.key;
    const bool key_last = i == e - 1 || runs[i + 1].key != r.key;
    Pass a;
    a.key = keys[r.key];
    a.type = key_types[r.key];
    a.mode = i == 0 ? M_DIRECT : key_first ? M_GATHER : M_CARRIED;
    a.shift = r.shift;
    a.dbits = r.dbits;
    a.u_in = key_first ? nullptr : u_prev;
    a.u_out = key_last ? nullptr : a.u_in == u_buf[0] ? u_buf[1] : u_buf[0];
    a.idx_in = idx_prev;
    a.idx_out = (e - 1 - i) % 2 == 0 ? (int*)out : idx_tmp;
    a.offsets = offsets + (size_t)r.pass * RADIX;
    a.tile_counter = tile_counters + i;
    a.status = status;
    a.epoch = (unsigned)i + 1;
    a.n = n;
    k2_pass<<<l.ntiles, THREADS, P_SMEM, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    idx_prev = a.idx_out;
    u_prev = a.u_out;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
