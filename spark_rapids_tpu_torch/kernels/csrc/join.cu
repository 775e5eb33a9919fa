// Hash-join probe kernel (K3) for Hopper (sm_90a).
//
// Replaces spark_rapids_tpu/native/kernels/join.py: probe. The build side
// is the hash-sorted int64 build column plus a bucket-offset table `part`
// (bucket = top table_bits bits of the sign-flipped hash, so each bucket
// is a contiguous slice of the sorted column). One thread per probe row
// scans its own bucket part[b] .. part[b+1] and returns the leftmost hash
// match and the match run length: the contract of two searchsorted calls.
//
// Bound: device-memory bytes on the stream side (read 8 B, write 8 B per
// probe row); the build column and table are small enough to stay in L2,
// so the bucket scans are cache hits. Comparing the signed hashes is the
// same as comparing the sign-flipped unsigned views (order-isomorphic),
// so only the bucket id needs the unsigned view. The loop ends at the
// bucket's own end: no maximum occupancy is read on the host.
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void k3_probe(const int64_t* __restrict__ sb_h,
                         const int* __restrict__ part, int shift,
                         const int64_t* __restrict__ h_p, int n,
                         int* __restrict__ lo, int* __restrict__ cnt) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t h = h_p[i];
  const uint64_t u = (uint64_t)h ^ 0x8000000000000000ull;
  const int b = (int)(u >> shift);
  const int start = part[b];
  const int end = part[b + 1];
  int off = 0, c = 0;
  for (int j = start; j < end; ++j) {
    const int64_t v = sb_h[j];
    off += v < h;
    c += v == h;
  }
  lo[i] = start + off;
  cnt[i] = c;
}

}  // namespace

extern "C" {

// sb_h: int64[n_build] ascending; part: int32[2^table_bits + 1];
// h_p: int64[n]; lo, cnt: int32[n]. 1 <= table_bits <= 31.
int srt_k3_probe(const void* sb_h, const void* part, int table_bits,
                 const void* h_p, int n, void* lo, void* cnt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (int)(((long long)n + THREADS - 1) / THREADS);
  k3_probe<<<blocks, THREADS, 0, s>>>(
      (const int64_t*)sb_h, (const int*)part, 64 - table_bits,
      (const int64_t*)h_p, n, (int*)lo, (int*)cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
