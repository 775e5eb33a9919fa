// Dictionary-string kernels (K4 match table, K5 LIKE table, K6
// substring) for Hopper (sm_90a).
//
// Both work on a dictionary's padded char table: chars uint8[n, L] (L a
// power of two <= 512, each entry's UTF-8 bytes zero-padded) and lens
// int32[n]. The per-row work of a string expression stays a gather by
// code; these kernels do the per-entry work once per dictionary.
//
// K4 replaces spark_rapids_tpu/native/kernels/strings.py: _match_table.
// One thread per entry answers starts / ends / contains for one needle of
// m bytes (1 <= m <= L), held in shared memory. starts compares bytes
// 0..m-1, ends bytes len-m..len-1, contains scans the windows p with
// p + m <= len and stops at the first hit. The TPU kernel materialized an
// (n, L-m+1, m) window tensor for contains, capped by a 64 MiB budget;
// this one builds nothing, so it takes every table the encoder accepts.
// Bound: the table's bytes (n*L + 4n read, n written); each thread walks
// its own row, whose bytes share cache lines with its neighbours' rows.
//
// K5 replaces strings.py: _like_table (SQL LIKE). The host parses the
// pattern into its non-empty %-separated segments, each with its branch of
// the TPU kernel: an anchored first segment compares bytes 0..m-1, an
// anchored last one the window at len-m (starting at or after the cursor),
// any other one takes its leftmost window at or after the cursor (greedy is
// exact for segments of fixed length); a pattern without % also needs the
// exact length. '_' matches one byte (the host keeps it off non-ASCII
// tables). One thread per entry; the segment table (offset, length,
// branch) and the pattern bytes (0x100 = wildcard) are copied once per
// block into shared memory sized at launch. Matched segments never
// overlap, so a pattern whose bytes exceed L matches nothing and the host
// launches nothing: the shared copy is at most (3 + 1) * 4 * 512 bytes,
// and every pattern the parser gives runs here. The TPU kernel built an
// (n, L-m+1, m) window tensor per segment under a 64 MiB budget; this one
// builds nothing and has no budget. Bound: the table's bytes (n*L + 4n
// read, n written), or the byte comparisons of this data where those are
// larger; like K4, each thread walks its own row and stops a window at its
// first mismatch and the search at its first hit.
//
// K6 replaces strings.py: substring_colv's kernel. One thread per output
// byte (entry i, byte j) computes its entry's clamped slice (Spark's
// 1-based or negative pos, optional length), writes the byte or zero
// padding, and byte 0 writes the new length. Bound: n*L bytes read and
// written plus the lengths; reads and writes are coalesced along j.
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_NEEDLE = 512;

enum Kind { STARTS = 0, ENDS = 1, CONTAINS = 2 };

__device__ __forceinline__ bool window_eq(const uint8_t* __restrict__ row,
                                          int p, const uint8_t* nd,
                                          int m) {
  for (int k = 0; k < m; ++k) {
    if (row[p + k] != nd[k]) return false;
  }
  return true;
}

__global__ void k4_match_table(const uint8_t* __restrict__ chars,
                               const int* __restrict__ lens, int n, int L,
                               const uint8_t* __restrict__ needle, int m,
                               int kind, uint8_t* __restrict__ out) {
  __shared__ uint8_t nd[MAX_NEEDLE];
  for (int k = threadIdx.x; k < m; k += blockDim.x) nd[k] = needle[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = chars + i * (long long)L;
  const int len = lens[i];
  bool hit = false;
  if (len >= m) {
    if (kind == STARTS) {
      hit = window_eq(row, 0, nd, m);
    } else if (kind == ENDS) {
      hit = window_eq(row, len - m, nd, m);
    } else {
      for (int p = 0; p + m <= len && !hit; ++p) hit = window_eq(row, p, nd, m);
    }
  }
  out[i] = hit ? 1 : 0;
}

constexpr int LIKE_WILD = 0x100;
enum LikeMode { LIKE_PREFIX = 0, LIKE_SUFFIX = 1, LIKE_SEARCH = 2 };

__device__ __forceinline__ bool like_eq(const uint8_t* __restrict__ row,
                                        int p, const int* seg, int m) {
  for (int k = 0; k < m; ++k) {
    const int t = seg[k];
    if (t != LIKE_WILD && row[p + k] != t) return false;
  }
  return true;
}

__global__ void k5_like_table(const uint8_t* __restrict__ chars,
                              const int* __restrict__ lens, int n, int L,
                              const int* __restrict__ spec, int nseg,
                              int nbytes, int exact_len,
                              uint8_t* __restrict__ out) {
  // 3 * nseg ints of (offset, length, mode), then nbytes pattern entries
  extern __shared__ int sp[];
  const int total = 3 * nseg + nbytes;
  for (int k = threadIdx.x; k < total; k += blockDim.x) sp[k] = spec[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = chars + i * (long long)L;
  const int len = lens[i];
  const int* pat = sp + 3 * nseg;
  bool ok = true;
  int cur = 0;
  for (int s = 0; s < nseg && ok; ++s) {
    const int* seg = pat + sp[3 * s];
    const int m = sp[3 * s + 1];
    const int mode = sp[3 * s + 2];
    if (mode == LIKE_PREFIX) {
      ok = len >= m && like_eq(row, 0, seg, m);
      cur = m;
    } else if (mode == LIKE_SUFFIX) {
      ok = len - m >= cur && like_eq(row, len - m, seg, m);
      cur = len;
    } else {
      int p = cur;
      while (p + m <= len && !like_eq(row, p, seg, m)) ++p;
      ok = p + m <= len;
      cur = p + m;
    }
  }
  if (exact_len >= 0) ok = ok && len == exact_len;
  out[i] = ok ? 1 : 0;
}

__global__ void k6_substring(const uint8_t* __restrict__ chars,
                             const int* __restrict__ lens, int n, int L,
                             long long pos, long long length, int has_length,
                             uint8_t* __restrict__ out,
                             int* __restrict__ out_lens) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * L) return;
  const long long i = t / L;
  const int j = (int)(t - i * L);
  const long long len = lens[i];
  // strings.py:306-317: end derives from the unclamped start
  long long start = pos > 0 ? pos - 1 : (pos < 0 ? len + pos : 0);
  long long end = has_length ? start + length : len;
  long long start_c = start < 0 ? 0 : (start > len ? len : start);
  long long end_c = end < len ? end : len;
  end_c = end_c < 0 ? 0 : end_c;
  long long out_len = end_c - start_c;
  out_len = out_len < 0 ? 0 : out_len;
  out[t] = j < out_len ? chars[i * L + start_c + j] : 0;
  if (j == 0) out_lens[i] = (int)out_len;
}

}  // namespace

extern "C" {

// chars: uint8[n, L]; lens: int32[n]; needle: uint8[m], 1 <= m <= L <= 512;
// kind 0 starts, 1 ends, 2 contains; out: bool[n].
int srt_k4_match_table(const void* chars, const void* lens, int n, int L,
                       const void* needle, int m, int kind, void* out,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (m < 1 || m > MAX_NEEDLE || m > L) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n + THREADS - 1) / THREADS);
  k4_match_table<<<blocks, THREADS, 0, s>>>(
      (const uint8_t*)chars, (const int*)lens, n, L, (const uint8_t*)needle,
      m, kind, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// chars: uint8[n, L]; lens: int32[n]; spec: int32[3 * nseg + nbytes], the
// segments' (offset, length, mode) then the pattern entries (byte, or 0x100
// for '_'); every segment non-empty, nbytes <= L; exact_len -1 for none;
// out: bool[n].
int srt_k5_like_table(const void* chars, const void* lens, int n, int L,
                      const void* spec, int nseg, int nbytes, int exact_len,
                      void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (nseg < 0 || nbytes < nseg || nbytes > L || L > MAX_NEEDLE)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n + THREADS - 1) / THREADS);
  const size_t smem = (size_t)(3 * nseg + nbytes) * sizeof(int);
  k5_like_table<<<blocks, THREADS, smem, s>>>(
      (const uint8_t*)chars, (const int*)lens, n, L, (const int*)spec, nseg,
      nbytes, exact_len, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// chars: uint8[n, L]; lens: int32[n]; out: uint8[n, L]; out_lens: int32[n].
// has_length 0 means "to the end" (length is then ignored).
int srt_k6_substring(const void* chars, const void* lens, int n, int L,
                     long long pos, long long length, int has_length,
                     void* out, void* out_lens, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const long long total = (long long)n * L;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  k6_substring<<<(unsigned)blocks, THREADS, 0, s>>>(
      (const uint8_t*)chars, (const int*)lens, n, L, pos, length, has_length,
      (uint8_t*)out, (int*)out_lens);
  return (int)cudaGetLastError();
}

}  // extern "C"
