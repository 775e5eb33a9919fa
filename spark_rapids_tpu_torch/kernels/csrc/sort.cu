// Partition (K1) and LSD radix argsort (K2) kernels for Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/native/kernels/sort.py: partition_order (the
// stable mask-true-first permutation) and radix_order (the stable LSD
// binary-radix argsort over order-preserving unsigned key views).
//
// Both are bound by device-memory bytes, not arithmetic: K1 reads one
// byte and writes four per row, K2 reads and writes a (u64 key, i32
// index) pair per row per 8-bit digit pass. The design keeps every pass
// a streaming read of contiguous tiles; the only cross-block state is a
// small array of per-tile counts, scanned by a three-kernel device scan
// (tile scan, one-block scan of tile totals, add-back). Stability comes
// from ordering: a tile's rows are ranked in index order inside the tile,
// and tiles are ranked in block order by the scan.
//
// Plain C interface for ctypes; every entry point launches on the stream
// it is given, allocates nothing (scratch comes from the caller) and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                  // K1 and scans: rows per thread
constexpr int TILE = THREADS * ITEMS;     // 2048 rows per block
constexpr int R_ITEMS = 16;               // K2: rows per thread
constexpr int R_TILE = THREADS * R_ITEMS; // 4096 rows per block
constexpr int RADIX = 256;                // K2: 8-bit digits

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

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

// ---- device-wide exclusive scan of int32 -----------------------------------

__global__ void scan_tiles(int* a, int m, int* tile_sums) {
  __shared__ int smem[WARPS + 1];
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int v[ITEMS];
  int s = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    long long i = base + j;
    v[j] = i < m ? a[i] : 0;
    s += v[j];
  }
  int total;
  int p = block_exclusive_scan(s, &total, smem);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    long long i = base + j;
    if (i < m) a[i] = p;
    p += v[j];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block walks the whole (short) array; also writes the grand total.
__global__ void scan_single(int* a, int m, int* total_out) {
  __shared__ int smem[WARPS + 1];
  int carry = 0;
  for (long long c0 = 0; c0 < m; c0 += TILE) {
    const long long base = c0 + (long long)threadIdx.x * ITEMS;
    int v[ITEMS];
    int s = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      long long i = base + j;
      v[j] = i < m ? a[i] : 0;
      s += v[j];
    }
    int total;
    int p = block_exclusive_scan(s, &total, smem) + carry;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      long long i = base + j;
      if (i < m) a[i] = p;
      p += v[j];
    }
    carry += total;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

__global__ void scan_add(int* a, int m, const int* tile_sums) {
  const long long base = (long long)blockIdx.x * TILE;
  const int add = tile_sums[blockIdx.x];
  for (int k = threadIdx.x; k < TILE; k += THREADS) {
    long long i = base + k;
    if (i < m) a[i] += add;
  }
}

// scratch: tile_sums[cdiv(m, TILE)] then total[1]; m > 0
void device_exclusive_scan(int* a, int m, int* scratch, cudaStream_t s) {
  const int nt = cdiv(m, TILE);
  int* tile_sums = scratch;
  int* total = scratch + nt;
  scan_tiles<<<nt, THREADS, 0, s>>>(a, m, tile_sums);
  scan_single<<<1, THREADS, 0, s>>>(tile_sums, nt, total);
  scan_add<<<nt, THREADS, 0, s>>>(a, m, tile_sums);
}

int scan_scratch_ints(int m) { return cdiv(m, TILE) + 1; }

// ---- K1: partition_order ---------------------------------------------------

__global__ void k1_count(const uint8_t* mask, int n, int* counts) {
  __shared__ int smem[WARPS + 1];
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  int c = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    long long i = base + j;
    if (i < n && mask[i]) ++c;
  }
  int total;
  block_exclusive_scan(c, &total, smem);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// offsets[b]: trues in blocks before b; *n_true: trues overall. A true row
// lands at its true-rank, a false row at n_true + its false-rank.
__global__ void k1_scatter(const uint8_t* mask, int n, const int* offsets,
                           const int* n_true, int* out) {
  __shared__ int smem[WARPS + 1];
  const long long base = (long long)blockIdx.x * TILE +
                         (long long)threadIdx.x * ITEMS;
  uint8_t m[ITEMS];
  int c = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    long long i = base + j;
    m[j] = (i < n) ? (mask[i] != 0) : 0;
    c += m[j];
  }
  int total;
  int trues_before = block_exclusive_scan(c, &total, smem) +
                     offsets[blockIdx.x];
  const int nt = *n_true;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    long long i = base + j;
    if (i >= n) break;
    if (m[j]) {
      out[trues_before] = (int)i;
      ++trues_before;
    } else {
      out[nt + (int)i - trues_before] = (int)i;
    }
  }
}

// ---- K2: radix_order -------------------------------------------------------

// key type codes (the Python wrapper maps torch dtypes onto them)
enum KeyType { K_BOOL = 0, K_I8 = 1, K_I16 = 2, K_I32 = 3, K_I64 = 4 };

// Order-isomorphic unsigned view: bool as 0/1, narrow signed ints shifted
// by 2^(bits-1) into [0, 2^bits), int64 with its sign bit flipped.
__device__ __forceinline__ uint64_t unsigned_key(const void* p, int kt,
                                                 long long i) {
  switch (kt) {
    case K_BOOL:
      return ((const uint8_t*)p)[i] ? 1ull : 0ull;
    case K_I8:
      return (uint64_t)((int64_t)((const int8_t*)p)[i] + (1ll << 7));
    case K_I16:
      return (uint64_t)((int64_t)((const int16_t*)p)[i] + (1ll << 15));
    case K_I32:
      return (uint64_t)((int64_t)((const int32_t*)p)[i] + (1ll << 31));
    default:
      return (uint64_t)((const int64_t*)p)[i] ^ 0x8000000000000000ull;
  }
}

// u[e] = unsigned view of key[idx[e]]: the key as seen through the
// permutation so far (identity for the first key processed).
__global__ void k2_load(const void* key, int kt, int* idx, int n, int first,
                        uint64_t* u) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  int ix;
  if (first) {
    ix = (int)e;
    idx[e] = ix;
  } else {
    ix = idx[e];
  }
  u[e] = unsigned_key(key, kt, ix);
}

__global__ void k2_hist(const uint64_t* u, int n, int shift, int dbits,
                        int* hist) {
  __shared__ int h[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += THREADS) h[d] = 0;
  __syncthreads();
  const uint64_t dmask = (1ull << dbits) - 1;
  const long long tile0 = (long long)blockIdx.x * R_TILE;
  for (int r = 0; r < R_ITEMS; ++r) {
    long long e = tile0 + (long long)r * THREADS + threadIdx.x;
    if (e < n) atomicAdd(&h[(int)((u[e] >> shift) & dmask)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += THREADS)
    hist[(long long)d * gridDim.x + blockIdx.x] = h[d];
}

// offsets: the digit-major histogram after an exclusive scan, so
// offsets[d * nblocks + b] = rows with a smaller digit anywhere plus rows
// with digit d in earlier blocks. Inside the block, rows are ranked in
// index order: round r covers rows r*THREADS .. r*THREADS+255 of the tile,
// warps in order, lanes in order (__match_any_sync groups equal digits).
__global__ void k2_scatter(const uint64_t* u_in, const int* idx_in, int n,
                           int shift, int dbits, const int* offsets,
                           uint64_t* u_out, int* idx_out) {
  __shared__ int run[RADIX];
  __shared__ int wcnt[WARPS][RADIX + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < RADIX; d += THREADS)
    run[d] = offsets[(long long)d * gridDim.x + blockIdx.x];
  const uint64_t dmask = (1ull << dbits) - 1;
  const long long tile0 = (long long)blockIdx.x * R_TILE;
  for (int r = 0; r < R_ITEMS; ++r) {
    const long long e = tile0 + (long long)r * THREADS + threadIdx.x;
    const bool valid = e < n;
    uint64_t u = 0;
    int ix = 0, d = RADIX;  // out-of-range rows use a bucket nobody reads
    if (valid) {
      u = u_in[e];
      ix = idx_in[e];
      d = (int)((u >> shift) & dmask);
    }
    for (int k = lane; k <= RADIX; k += 32) wcnt[warp][k] = 0;
    __syncwarp();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (lane == __ffs(peers) - 1) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    for (int dd = threadIdx.x; dd < RADIX; dd += THREADS) {
      int s = run[dd];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int c = wcnt[w][dd];
        wcnt[w][dd] = s;
        s += c;
      }
      run[dd] = s;
    }
    __syncthreads();
    if (valid) {
      const int pos = wcnt[warp][d] + rank;
      u_out[pos] = u;
      idx_out[pos] = ix;
    }
    __syncthreads();
  }
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

}  // namespace

extern "C" {

int srt_k1_scratch_ints(int n) {
  const int nb = cdiv(n, TILE);
  return nb + scan_scratch_ints(nb);
}

// mask: n bytes (0/1); out: int32[n]; scratch: srt_k1_scratch_ints(n) ints
int srt_k1_partition_order(const void* mask, int n, void* out,
                           void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const int nb = cdiv(n, TILE);
  int* counts = (int*)scratch;
  int* scan_scratch = counts + nb;
  int* n_true = scan_scratch + cdiv(nb, TILE);
  k1_count<<<nb, THREADS, 0, s>>>((const uint8_t*)mask, n, counts);
  device_exclusive_scan(counts, nb, scan_scratch, s);
  k1_scatter<<<nb, THREADS, 0, s>>>((const uint8_t*)mask, n, counts, n_true,
                                    (int*)out);
  return (int)cudaGetLastError();
}

size_t srt_k2_scratch_bytes(int n) {
  const int nb = cdiv(n, R_TILE);
  const int m = RADIX * nb;
  return 2 * align_up((size_t)n * 8) + align_up((size_t)n * 4) +
         align_up((size_t)(m + scan_scratch_ints(m)) * 4);
}

// keys[k]: device pointers, most significant key first; key_types[k]:
// KeyType codes; widths[k]: bits to sort on (<= the key's own width).
// out: int32[n], the stable ascending permutation.
int srt_k2_radix_order(int nkeys, void* const* keys, const int* key_types,
                       const int* widths, int n, void* out, void* scratch,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || nkeys <= 0) return (int)cudaGetLastError();
  const int nb = cdiv(n, R_TILE);
  const int m = RADIX * nb;
  char* p = (char*)scratch;
  uint64_t* u_a = (uint64_t*)p;
  p += align_up((size_t)n * 8);
  uint64_t* u_b = (uint64_t*)p;
  p += align_up((size_t)n * 8);
  int* idx_tmp = (int*)p;
  p += align_up((size_t)n * 4);
  int* hist = (int*)p;
  int* scan_scratch = hist + m;

  int* idx_cur = (int*)out;
  int* idx_nxt = idx_tmp;
  const int load_blocks = cdiv(n, THREADS);
  // least significant key first; each key sorts on its low `width` bits
  for (int k = nkeys - 1; k >= 0; --k) {
    k2_load<<<load_blocks, THREADS, 0, s>>>(keys[k], key_types[k], idx_cur,
                                            n, k == nkeys - 1, u_a);
    uint64_t* uc = u_a;
    uint64_t* un = u_b;
    for (int shift = 0; shift < widths[k]; shift += 8) {
      const int dbits = widths[k] - shift < 8 ? widths[k] - shift : 8;
      k2_hist<<<nb, THREADS, 0, s>>>(uc, n, shift, dbits, hist);
      device_exclusive_scan(hist, m, scan_scratch, s);
      k2_scatter<<<nb, THREADS, 0, s>>>(uc, idx_cur, n, shift, dbits, hist,
                                        un, idx_nxt);
      uint64_t* tu = uc;
      uc = un;
      un = tu;
      int* ti = idx_cur;
      idx_cur = idx_nxt;
      idx_nxt = ti;
    }
  }
  if (idx_cur != (int*)out) {
    cudaError_t err = cudaMemcpyAsync(out, idx_cur, (size_t)n * 4,
                                      cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
