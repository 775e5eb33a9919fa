// Dictionary-string kernels (K4 match table, K6 substring) for Hopper
// (sm_90a).
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
