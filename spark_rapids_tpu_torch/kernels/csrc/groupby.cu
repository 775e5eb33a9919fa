// Segmented float64 sum of the group-by's sort path, for Hopper (sm_90a).
//
// Takes the place of spark_rapids_tpu/ops/groupby.py: _seg_scan (a jnp
// segmented scan, no pallas_call) where the sort path sums floats, and of
// the scatter of float atomics the port used before (index_add_), which
// contended on a few addresses when groups were few and long.
//
// The rows are sorted by group: group g is the sizes[g] rows of x from
// starts[g]. One launch folds one level. A piece is up to W consecutive
// items of one group, counted from the group's first item; a thread sums
// the items of one piece in order and writes its total. The next level
// folds the pieces of each group, W at a time, until a group has one
// piece. So every sum is a fixed tree of in-order runs of W, the same
// one the plain version (kernels/groupby.py seg_fold) computes, and the
// two agree bit for bit; no value of one group meets another's, and
// nothing is added atomically.
//
// Level input: x [rows, m] row-major; either one piece a group
// (ends == nullptr: piece p is group p, P = G), or ends[g], the inclusive
// prefix sum of ceil(sizes[g] / W), so a piece finds its group by a binary
// search of ends. The caller sizes P from the host's row and group
// counts without reading the device; pieces past ends[G - 1] are spare
// and written as 0 (no later level reads them).
//
// Bound: device-memory bytes. The first level reads each row once and
// starts and sizes once; later levels move a W-th of the level before.
//
// Plain C interface for ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void fold_level(const double* __restrict__ x, int m,
                           const int64_t* __restrict__ starts,
                           const int64_t* __restrict__ sizes,
                           const int64_t* __restrict__ ends, int64_t groups,
                           int64_t pieces, int w, double* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pieces) return;
  int64_t g = p, k = 0;
  if (ends != nullptr) {
    int64_t lo = 0, hi = groups;  // the first group whose end is past p
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(ends + mid) <= p) lo = mid + 1; else hi = mid;
    }
    if (lo >= groups) {  // a spare piece
      for (int c = 0; c < m; ++c) out[p * m + c] = 0.0;
      return;
    }
    g = lo;
    const int64_t size = __ldg(sizes + g);
    k = p - (__ldg(ends + g) - (size + w - 1) / w);
  }
  const int64_t first = __ldg(starts + g) + k * w;
  int64_t len = __ldg(sizes + g) - k * w;
  if (len > w) len = w;
  for (int c = 0; c < m; ++c) {
    const double* r = x + first * m + c;
    double acc = r[0];
    for (int64_t j = 1; j < len; ++j) acc += r[j * m];  // in row order
    out[p * m + c] = acc;
  }
}

}  // namespace

extern "C" {

// x: float64[rows, m]; starts, sizes: int64[groups]; ends: int64[groups]
// or null; out: float64[pieces, m]. 1 <= w.
int srt_seg_sum_level(const void* x, int m, const void* starts,
                      const void* sizes, const void* ends, long long groups,
                      long long pieces, int w, void* out, void* stream) {
  if (pieces <= 0 || m <= 0) return (int)cudaGetLastError();
  const long long blocks = (pieces + THREADS - 1) / THREADS;
  fold_level<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)x, m, (const int64_t*)starts, (const int64_t*)sizes,
      (const int64_t*)ends, groups, pieces, w, (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
