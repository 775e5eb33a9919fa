// Hash-join probe kernel (K3) for Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/native/kernels/join.py: probe. The build side
// is the hash-sorted int64 build column plus a bucket-offset table `part`
// (bucket = top table_bits bits of the sign-flipped hash, so each bucket
// is a contiguous, ascending slice of the sorted column). For every
// stream hash the kernel returns the leftmost hash match `lo` and the
// match run length `cnt` inside its bucket: the contract of two
// searchsorted calls, and of the TPU kernel's scan (lo = start + #(v < h),
// cnt = #(v == h) over the bucket).
//
// Bound: device-memory bytes. The stream side reads 8 B and writes 8 B
// (two int32) per probe row; the build column and the table are read
// once. Both are small next to the stream at the main shape (an ~18k-row
// build, 28.8M probes), so what costs time above the bound is each row's
// chain of dependent loads (hash, bucket offsets, build hashes) and the
// L2 requests of the last two. Each thread probes ROWS rows with
// independent loads, reads the stream hashes as 16-byte vectors and
// writes lo and cnt as 16-byte vectors.
//
// Two kernels:
// - k3_staged, for builds of at most about 27,000 rows (the build column
//   and a coarse bucket table fit in a block's 227 KB of shared memory):
//   one persistent 1024-thread block per SM copies the live build hashes
//   into shared memory, derives the offsets of 2^cbits coarse buckets
//   from them (4 to 8 rows a bucket), and then walks the stream. Every
//   build lookup is a shared-memory load; only the stream touches
//   device memory.
// - k3_probe otherwise: the table and the build column are read through
//   the read-only path from L2; a bucket's two offsets come in one
//   8-byte load where they share an aligned word.
//
// Skew: a bucket holds a whole run of one build key (a build of 1.2M
// rows on 6 keys has six buckets of ~200k rows). The TPU kernel scanned
// the bucket, O(run) per probe. Here a bucket of at most LINEAR entries
// is scanned (unrolled, predicated, no dependent loads), and a longer
// one is binary-searched for lower_bound(h) and upper_bound(h): O(log
// run) dependent loads, 18 for each end of a 200k run.
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;    // probe rows per thread
constexpr int LINEAR = 4;  // buckets up to this size are scanned
constexpr int S_THREADS = 1024;
constexpr int S_BYTES = 232448;  // shared memory a Hopper block can have
constexpr int MAX_CBITS = 12;

__device__ __forceinline__ uint64_t flip(int64_t h) {
  return (uint64_t)h ^ 0x8000000000000000ull;
}

// First position in [a, b) whose value is not below h (kStrict) or not
// above h (!kStrict); v[a, b) is ascending. Shared or global memory.
template <bool kStrict>
__device__ __forceinline__ int bound(const int64_t* __restrict__ v, int a,
                                     int b, int64_t h) {
  while (a < b) {
    const int mid = (int)(((unsigned)a + (unsigned)b) >> 1);
    const int64_t x = v[mid];
    if (kStrict ? (x < h) : (x <= h))
      a = mid + 1;
    else
      b = mid;
  }
  return a;
}

// The ROWS stream hashes from `base`: two 16-byte loads for a full,
// aligned group, else one by one (missing rows read as 0).
template <bool kVec>
__device__ __forceinline__ bool load_rows(const int64_t* __restrict__ h_p,
                                          long long base, int n,
                                          int64_t (&h)[ROWS]) {
  const bool full = kVec && base + ROWS <= n;
  if (full) {
    const longlong2 a = __ldg((const longlong2*)(h_p + base));
    const longlong2 b = __ldg((const longlong2*)(h_p + base + 2));
    h[0] = a.x;
    h[1] = a.y;
    h[2] = b.x;
    h[3] = b.y;
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) h[r] = base + r < n ? h_p[base + r] : 0;
  }
  return full;
}

__device__ __forceinline__ void store_rows(int* __restrict__ lo,
                                           int* __restrict__ cnt,
                                           long long base, int n, bool full,
                                           const int (&l)[ROWS],
                                           const int (&c)[ROWS]) {
  if (full) {
    *(int4*)(lo + base) = make_int4(l[0], l[1], l[2], l[3]);
    *(int4*)(cnt + base) = make_int4(c[0], c[1], c[2], c[3]);
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (base + r < n) {
        lo[base + r] = l[r];
        cnt[base + r] = c[r];
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS)
    k3_probe(const int64_t* __restrict__ sb_h, const int* __restrict__ part,
             int shift, const int64_t* __restrict__ h_p, int n,
             int* __restrict__ lo, int* __restrict__ cnt) {
  const long long base =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * ROWS;
  if (base >= n) return;
  int64_t h[ROWS];
  const bool full = load_rows<kVec>(h_p, base, n, h);
  int st[ROWS], en[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = (int)(flip(h[r]) >> shift);
    if (kVec && (b & 1) == 0) {  // both offsets in one 8-byte load
      const int2 pr = __ldg((const int2*)(part + b));
      st[r] = pr.x;
      en[r] = pr.y;
    } else {
      st[r] = __ldg(part + b);
      en[r] = __ldg(part + b + 1);
    }
  }
  int l[ROWS], c[ROWS];
  // short buckets: every load independent of the others
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    l[r] = st[r];
    c[r] = 0;
    const bool short_bucket = en[r] - st[r] <= LINEAR;
#pragma unroll
    for (int k = 0; k < LINEAR; ++k) {
      const int j = st[r] + k;
      if (short_bucket && j < en[r]) {
        const int64_t v = __ldg(sb_h + j);
        l[r] += v < h[r];
        c[r] += v == h[r];
      }
    }
  }
  // long buckets: the two ends of h's run by binary search
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (en[r] - st[r] > LINEAR) {
      const int lower = bound<true>(sb_h, st[r], en[r], h[r]);
      l[r] = lower;
      c[r] = bound<false>(sb_h, lower, en[r], h[r]) - lower;
    }
  }
  store_rows(lo, cnt, base, n, full, l, c);
}

// The build hashes and a table of 2^cbits coarse buckets in shared
// memory; the live rows are part[2^table_bits] (a table carried from
// the reference parks padding rows past them).
template <bool kVec>
__global__ void __launch_bounds__(S_THREADS)
    k3_staged(const int64_t* __restrict__ sb_h, int n_build,
              const int* __restrict__ part, int table_bits, int cbits,
              const int64_t* __restrict__ h_p, int n, int* __restrict__ lo,
              int* __restrict__ cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_sb = (int64_t*)smem;      // [n_build]
  int* s_cb = (int*)(s_sb + n_build);  // [2^cbits + 1]
  const int nv = min(n_build, __ldg(part + (1 << table_bits)));
  for (int i = threadIdx.x; i < nv; i += S_THREADS) s_sb[i] = __ldg(sb_h + i);
  __syncthreads();
  // s_cb[j]: the first live row whose coarse bucket is not below j
  const int ncb = 1 << cbits, cshift = 64 - cbits;
  for (int j = threadIdx.x; j <= ncb; j += S_THREADS) {
    int a = 0, b = nv;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if ((long long)(flip(s_sb[mid]) >> cshift) < j)
        a = mid + 1;
      else
        b = mid;
    }
    s_cb[j] = a;
  }
  __syncthreads();
  const long long groups = ((long long)n + ROWS - 1) / ROWS;
  for (long long g = (long long)blockIdx.x * S_THREADS + threadIdx.x;
       g < groups; g += (long long)gridDim.x * S_THREADS) {
    const long long base = g * ROWS;
    int64_t h[ROWS];
    const bool full = load_rows<kVec>(h_p, base, n, h);
    int l[ROWS], c[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int cb = (int)(flip(h[r]) >> cshift);
      const int e = s_cb[cb + 1];
      l[r] = bound<true>(s_sb, s_cb[cb], e, h[r]);
      c[r] = bound<false>(s_sb, l[r], e, h[r]) - l[r];
    }
    store_rows(lo, cnt, base, n, full, l, c);
  }
}

int bit_length(unsigned x) {
  int b = 0;
  while (x) {
    ++b;
    x >>= 1;
  }
  return b;
}

}  // namespace

extern "C" {

// sb_h: int64[n_build] ascending; part: int32[2^table_bits + 1];
// h_p: int64[n]; lo, cnt: int32[n]. 1 <= table_bits <= 31.
int srt_k3_probe(const void* sb_h, int n_build, const void* part,
                 int table_bits, const void* h_p, int n, void* lo, void* cnt,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  // vector loads and stores need aligned rows and offsets; torch's
  // allocator gives that, a sliced view may not
  const bool vec = ((uintptr_t)h_p % 16 == 0) && ((uintptr_t)lo % 16 == 0) &&
                   ((uintptr_t)cnt % 16 == 0) && ((uintptr_t)part % 8 == 0);
  const int cbits = std::min(MAX_CBITS, std::max(1, bit_length(n_build) - 3));
  const size_t staged =
      (size_t)n_build * 8 + (((size_t)1 << cbits) + 1) * 4;
  const int64_t* sb = (const int64_t*)sb_h;
  const int* pt = (const int*)part;
  const int64_t* hp = (const int64_t*)h_p;
  if (n_build > 0 && staged <= (size_t)S_BYTES) {
    // per device, once: the SM count and the staged kernels' limit
    static int sms_of[64];
    int dev = 0;
    cudaGetDevice(&dev);
    int& sms = sms_of[dev & 63];
    if (sms == 0) {
      cudaFuncSetAttribute(k3_staged<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S_BYTES);
      cudaFuncSetAttribute(k3_staged<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S_BYTES);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const long long groups = ((long long)n + ROWS - 1) / ROWS;
    const int blocks = (int)std::min<long long>(
        sms, (groups + S_THREADS - 1) / S_THREADS);
    if (vec)
      k3_staged<true><<<blocks, S_THREADS, staged, s>>>(
          sb, n_build, pt, table_bits, cbits, hp, n, (int*)lo, (int*)cnt);
    else
      k3_staged<false><<<blocks, S_THREADS, staged, s>>>(
          sb, n_build, pt, table_bits, cbits, hp, n, (int*)lo, (int*)cnt);
    return (int)cudaGetLastError();
  }
  const long long threads = ((long long)n + ROWS - 1) / ROWS;
  const int blocks = (int)((threads + THREADS - 1) / THREADS);
  if (vec)
    k3_probe<true><<<blocks, THREADS, 0, s>>>(sb, pt, 64 - table_bits, hp, n,
                                              (int*)lo, (int*)cnt);
  else
    k3_probe<false><<<blocks, THREADS, 0, s>>>(sb, pt, 64 - table_bits, hp,
                                               n, (int*)lo, (int*)cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
