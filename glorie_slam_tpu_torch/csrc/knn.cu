// Kernel F: exact k-nearest-neighbour search over a padded point cloud, the
// mapper's kNN (ops/knn.py knn_search on CUDA tensors).
//
// Replaces no TPU kernel: the JAX package's kNN (glorie_slam_tpu/ops/knn.py)
// is plain XLA, a float32 distance matrix and lax.top_k. The port's plain
// version did the same in PyTorch (a distance row per query, topk, a cumsum
// over the row for the ties, two sorts) and spent ~98% of a mapper train
// step there, writing and re-reading gigabytes of distances.
//
// For query q and valid point p (slots at or past n_valid read BIG), with
// q2 and p2 the squared norms as knn.sq_norm rounds them:
//   d = fl(fl(q2 + p2) - 2 cross),   cross = fl(fl(qz pz + fl(qy py +
//                                            fl(qx px)))),
// the cross term a float32 FMA chain in ascending coordinate order, which is
// how cuBLAS sums the plain version's K = 3 product on the H100 (the bits
// agree; see the card tests), and - 2 cross folded into one FMA (exact,
// since 2 cross is exact). The k smallest come out ordered by (distance,
// index), equal distances lowest index first, as lax.top_k lists them; when
// fewer than k points are valid, the rest read BIG at indices n_valid,
// n_valid + 1, ..., clamped to n_scan - 1, as the plain version fills them.
//
// What bounds it on the card: FP32 instruction issue. A pair costs ~6 FP32
// instructions (3 for the cross term, the add q2 + p2, the FMA for d, a
// compare) and reads nothing from device memory: the whole cloud is 16
// bytes a point. At the mapper's train step (286,720 queries against
// ~35,600 points) that is ~1.0e10 pairs, ~1.8 ms at the H100's published
// FP32 rate.
//
// The design keeps everything but the answer out of device memory:
//
// * One thread owns one query and keeps its k best as a sorted array in
//   registers (the array is unrolled, so k is a template parameter,
//   1..kMaxK). It scans point indices in ascending order and admits a
//   candidate only on a strict < against its k-th distance, which keeps
//   the (distance, index) order with no index compare.
// * A block of kThreads queries stages the cloud through shared memory in
//   tiles of kTile float4 (x, y, z, p2) points, double-buffered with
//   cp.async: every lane reads the same point (a broadcast), so one tile
//   serves 128 queries.
// * Distances are taken kGroup at a time and their minimum is tested
//   against the k-th distance once; only a group that holds a candidate
//   walks its points through the insertion. After the first few tiles
//   nearly every group is rejected by that one test.
// * When the queries alone cannot fill the card (anchoring's ~7,000, the
//   evaluation renders' few thousand rays), the host splits the valid
//   points into ranges (blockIdx.y), each scanned into a partial list, and
//   a second small pass merges each query's lists in range order with the
//   same strict < rule, which keeps the order across ranges. The host picks
//   the split from the query and point counts alone.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 256;      // points per shared-memory stage (4 KB)
constexpr int kGroup = 8;       // distances tested against the k-th at once
constexpr int kMaxK = 16;
constexpr float kBig = 1e12f;   // knn.BIG: the distance of an invalid slot

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The k best (distance, index) pairs, ascending; empty slots read
// (+inf, INT_MAX), which no candidate can fail to beat or tie.
template <int K>
struct TopK {
  float d[K];
  int i[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = __int_as_float(0x7f800000);
      i[j] = INT_MAX;
    }
  }

  __device__ __forceinline__ float kth() const { return d[K - 1]; }

  // Insert (v, idx) given v < kth(), after every entry whose distance is
  // <= v: each slot j takes its own value, the new one, or its
  // predecessor's, read before the predecessor moves.
  __device__ __forceinline__ void insert(float v, int idx) {
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      const bool shift = v < d[j - 1];
      const bool here = v < d[j];
      d[j] = shift ? d[j - 1] : (here ? v : d[j]);
      i[j] = shift ? i[j - 1] : (here ? idx : i[j]);
    }
    if (v < d[0]) {
      d[0] = v;
      i[0] = idx;
    }
  }

  // The plain version's padding: BIG at n_valid + j, clamped to n_scan - 1,
  // taken after every valid point.
  __device__ __forceinline__ void pad(int n_valid, int n_scan) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!(kBig < kth())) break;
      insert(kBig, min(n_valid + j, n_scan - 1));
    }
  }
};

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  // knn.sq_norm: x*x in float32, then y*y and z*z each added in float64
  // (the products are exact there) and rounded back to float32
  float acc = __fmul_rn(x, x);
  acc = __double2float_rn(__fma_rn((double)y, (double)y, (double)acc));
  acc = __double2float_rn(__fma_rn((double)z, (double)z, (double)acc));
  return acc;
}

__device__ __forceinline__ float distance(float qx, float qy, float qz,
                                          float q2, float4 p) {
  const float cross =
      __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
  return __fmaf_rn(-2.0f, cross, __fadd_rn(q2, p.w));
}

// Scan n points of a staged tile (first index base) into top; kFull tiles
// hold kTile points, so their loop has no bound test.
template <int K, bool kFull>
__device__ __forceinline__ void scan_tile(TopK<K>& top, const float4* tile,
                                          int n, int base, float qx, float qy,
                                          float qz, float q2) {
  const float inf = __int_as_float(0x7f800000);
#pragma unroll 1
  for (int j = 0; j < (kFull ? kTile : n); j += kGroup) {
    float dv[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float v = distance(qx, qy, qz, q2, tile[j + g]);
      dv[g] = (kFull || j + g < n) ? v : inf;
    }
    float m = dv[0];
#pragma unroll
    for (int g = 1; g < kGroup; ++g) m = fminf(m, dv[g]);
    if (m < top.kth()) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (dv[g] < top.kth()) top.insert(dv[g], base + j + g);
    }
  }
}

// Block (x, y): queries x * kThreads.., points [y * span, (y + 1) * span)
// of the first n_valid. With padded set (one range) the padded list goes to
// out_d / out_i (Q, K); else the range's list goes to part_d / part_i
// (ranges, Q, K) for knn_merge.
template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_scan(const float* __restrict__ queries,
             const float4* __restrict__ points, int Q, int n_valid,
             int n_scan, int span, bool padded, float* __restrict__ out_d,
             long long* __restrict__ out_i, float* __restrict__ part_d,
             int* __restrict__ part_i) {
  __shared__ __align__(16) float4 tiles[2][kTile];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int lo = blockIdx.y * span;
  const int hi = min(lo + span, n_valid);
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (q < Q) {
    qx = queries[3 * (size_t)q];
    qy = queries[3 * (size_t)q + 1];
    qz = queries[3 * (size_t)q + 2];
  }
  const float q2 = sq_norm(qx, qy, qz);
  TopK<K> top;
  top.clear();

  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  auto stage = [&](int t) {
    const int base = lo + t * kTile;
#pragma unroll
    for (int r = threadIdx.x; r < kTile; r += kThreads)
      if (base + r < hi) cp_async16(&tiles[t & 1][r], points + base + r);
    cp_async_commit();
  };
  if (n_tiles > 0) stage(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int base = lo + t * kTile;
    const int n = min(kTile, hi - base);
    if (n == kTile)
      scan_tile<K, true>(top, tiles[t & 1], n, base, qx, qy, qz, q2);
    else
      scan_tile<K, false>(top, tiles[t & 1], n, base, qx, qy, qz, q2);
    __syncthreads();   // the next stage overwrites this buffer
  }
  if (q >= Q) return;
  if (padded) {
    top.pad(n_valid, n_scan);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_d[(size_t)q * K + j] = top.d[j];
      out_i[(size_t)q * K + j] = top.i[j];
    }
  } else {
    const size_t row = ((size_t)blockIdx.y * Q + q) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part_d[row + j] = top.d[j];
      part_i[row + j] = top.i[j];
    }
  }
}

// One thread per query: the ranges' lists taken in range order (ascending
// indices), each until its first entry that cannot enter, then the padding.
template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_merge(const float* __restrict__ part_d,
              const int* __restrict__ part_i, int Q, int ranges, int n_valid,
              int n_scan, float* __restrict__ out_d,
              long long* __restrict__ out_i) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  TopK<K> top;
  top.clear();
  for (int s = 0; s < ranges; ++s) {
    const size_t row = ((size_t)s * Q + q) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float v = part_d[row + j];
      if (!(v < top.kth())) break;
      top.insert(v, part_i[row + j]);
    }
  }
  top.pad(n_valid, n_scan);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_d[(size_t)q * K + j] = top.d[j];
    out_i[(size_t)q * K + j] = top.i[j];
  }
}

template <int K>
int launch(const float* queries, const float4* points, int Q, int n_valid,
           int n_scan, int ranges, int span, float* part_d, int* part_i,
           float* out_d, long long* out_i, cudaStream_t stream) {
  const int blocks = (Q + kThreads - 1) / kThreads;
  const bool padded = ranges == 1;
  knn_scan<K><<<dim3(blocks, ranges), kThreads, 0, stream>>>(
      queries, points, Q, n_valid, n_scan, span, padded, out_d, out_i, part_d,
      part_i);
  int err = (int)cudaGetLastError();
  if (err || padded) return err;
  knn_merge<K><<<blocks, kThreads, 0, stream>>>(part_d, part_i, Q, ranges,
                                                 n_valid, n_scan, out_d,
                                                 out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// queries (Q, 3) float32; points (n_scan, 4) float32 rows (x, y, z, p2),
// 16-byte aligned; the first n_valid (<= n_scan) are the valid points.
// ranges > 1 splits them into ranges of span points (a multiple of the
// tile) and needs part_d / part_i of (ranges, Q, k). Writes out_d (Q, k)
// float32 and out_i (Q, k) int64. Returns a CUDA error code, or
// cudaErrorInvalidValue for a k outside 1..kMaxK.
extern "C" int glorie_knn(const void* queries, const void* points, int Q,
                          int n_valid, int n_scan, int k, int ranges,
                          int span, void* part_d, void* part_i, void* out_d,
                          void* out_i, void* stream) {
  if (Q <= 0) return 0;
  const float* qp = static_cast<const float*>(queries);
  const float4* pp = static_cast<const float4*>(points);
  float* pd = static_cast<float*>(part_d);
  int* pi = static_cast<int*>(part_i);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define GLORIE_KNN_CASE(K)                                                 \
  case K:                                                                  \
    return launch<K>(qp, pp, Q, n_valid, n_scan, ranges, span, pd, pi, od, \
                     oi, s);
    GLORIE_KNN_CASE(1) GLORIE_KNN_CASE(2) GLORIE_KNN_CASE(3)
    GLORIE_KNN_CASE(4) GLORIE_KNN_CASE(5) GLORIE_KNN_CASE(6)
    GLORIE_KNN_CASE(7) GLORIE_KNN_CASE(8) GLORIE_KNN_CASE(9)
    GLORIE_KNN_CASE(10) GLORIE_KNN_CASE(11) GLORIE_KNN_CASE(12)
    GLORIE_KNN_CASE(13) GLORIE_KNN_CASE(14) GLORIE_KNN_CASE(15)
    GLORIE_KNN_CASE(16)
#undef GLORIE_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// (kMaxK, kTile): checked by ops/knn.py when the library loads.
extern "C" void glorie_knn_geometry(int* v) {
  v[0] = kMaxK;
  v[1] = kTile;
}
