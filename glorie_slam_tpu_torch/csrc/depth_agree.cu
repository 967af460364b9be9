// Kernel B: multiview depth agreement (the 4-corner test of the depth filter).
//
// Replaces the TPU kernel glorie_slam_tpu/ops/pallas_corr.py
// depth_agree_pallas (:644, body _depth_agree_kernel :517).
//
// For source frame m, neighbour k (0..5) and pixel p, with
// cu[m, 4k + {0,1,2,3}, p] = [u, v, izd, thr] (the pixel reprojected into
// neighbour frame jxs[m, k]: position, 1 / projected disparity, threshold):
//   agree = floor(u), floor(v) inside [0, wd-1) x [0, ht-1)
//           and some bilinear corner c of dmaps[jxs[m, k]] has
//           |izd - 1/c| < thr.
// Output (M, 6, npix) float32, exactly 0 or 1.
//
// The TPU kernel held a slab of each neighbour's map in VMEM and picked
// corners with one-hot matmuls, plus an escape pass for pixels whose
// footprint left the slab: TPU gathers serialize. A Hopper thread reads its
// four corners straight from device memory (they share one or two cache
// lines), so the slab and the escape pass are gone: one thread per
// (source, neighbour, pixel).
//
// What bounds it on the card: bytes. Each thread reads its 16-byte packed
// record and writes 4 bytes; the corner reads of a neighbour map mostly
// hit L2 (a 320x640 float map is 0.8 MB).

#include <cuda_runtime.h>

namespace {

__global__ void depth_agree_kernel(const float* __restrict__ dmaps,
                                   const int* __restrict__ jxs,
                                   const float* __restrict__ cu,
                                   float* __restrict__ out, int ht, int wd,
                                   int npix) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  const int m = blockIdx.z;
  if (p >= npix) return;
  const float* rec = cu + ((size_t)m * 24 + 4 * k) * npix;
  const float u = rec[p];
  const float v = rec[npix + p];
  const float izd = rec[2 * (size_t)npix + p];
  const float thr = rec[3 * (size_t)npix + p];
  const float fu = floorf(u), fv = floorf(v);
  float res = 0.0f;
  if (fu >= 0.0f && fv >= 0.0f && fu < (float)(wd - 1)
      && fv < (float)(ht - 1)) {
    const int u0 = (int)fu, v0 = (int)fv;
    const float* d = dmaps + (size_t)jxs[m * 6 + k] * ht * wd
                     + (size_t)v0 * wd + u0;
    const float c00 = d[0], c01 = d[1], c10 = d[wd], c11 = d[wd + 1];
    const bool agree = fabsf(izd - 1.0f / c00) < thr
                       || fabsf(izd - 1.0f / c01) < thr
                       || fabsf(izd - 1.0f / c10) < thr
                       || fabsf(izd - 1.0f / c11) < thr;
    res = agree ? 1.0f : 0.0f;
  }
  out[((size_t)m * 6 + k) * npix + p] = res;
}

}  // namespace

extern "C" int glorie_depth_agree(const void* dmaps, const void* jxs,
                                  const void* cu, void* out, int M, int ht,
                                  int wd, int npix, void* stream) {
  if (M <= 0 || npix <= 0) return 0;
  const int threads = 256;
  dim3 grid((npix + threads - 1) / threads, 6, M);
  depth_agree_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dmaps), static_cast<const int*>(jxs),
      static_cast<const float*>(cu), static_cast<float*>(out), ht, wd, npix);
  return (int)cudaGetLastError();
}
