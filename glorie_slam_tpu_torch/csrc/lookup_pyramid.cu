// Kernel A: 4-level windowed correlation lookup computed from features.
//
// Replaces the TPU kernel glorie_slam_tpu/ops/pallas_corr.py
// lookup_feats_pyramid_pallas (:363, body _lookup_feats_pyr_kernel :299).
//
// For edge e, source pixel p and pyramid level l (level coordinates
// x = cx / 2^l, y = cy / 2^l):
//   corr(q) = <f1[iis[e], p], f2_l[jjs[e], q]> / 16       (fp32 accumulate)
//   out[e, p, l*49 + a*7 + b] = sum over the 2x2 bilinear corners of the
//       sample (x - 3 + a, y - 3 + b) of hat weight * corr(corner),
// with out-of-plane corners contributing zero. Output is bf16.
//
// The TPU kernel computed whole correlation planes (or a band of rows)
// on its matrix unit and reduced them with hat matrices. Here only the
// correlations a window can touch are computed: the 7x7 window plus its
// bilinear neighbour spans 8x8 target cells per level, so a pixel needs
// 4 x 64 dot products of length 128. One block takes TP pixels of one
// edge: it stages their f1 rows in shared memory, one thread per
// (pixel, cell) computes a dot product against the cell's f2 row, and
// TP*49 threads then form the window outputs.
//
// What bounds it on the card: the least time for this work is set by bytes
// (the (E, npix, 196) bf16 output is most of them); this version is limited
// well above that by its 4*64*128 MACs per (edge, pixel) on CUDA cores (the
// f2 rows a pixel reads overlap its neighbours' and stay in L1/L2).
// Tensor-core (mma/wgmma) tiles come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;      // feature channels
constexpr int kR = 3;        // window radius
constexpr int kRD = 7;       // window side
constexpr int kSide = 8;     // target cells a window touches per axis
constexpr int kCells = kSide * kSide;
constexpr int kTP = 4;       // pixels per block
constexpr int kThreads = kTP * kCells;
constexpr int kLevels = 4;

struct Levels {
  const __nv_bfloat16* f2[kLevels];
  int h[kLevels];
  int w[kLevels];
};

__device__ __forceinline__ float clean(float v, float lo, float hi) {
  // NaN -> 0 (the TPU kernel's nan_to_num); far-out coordinates clamp to
  // a value whose whole window is still off the plane (same zero output)
  if (isnan(v)) return 0.0f;
  return fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
lookup_pyramid_kernel(const __nv_bfloat16* __restrict__ f1, Levels lv,
                      const int* __restrict__ iis,
                      const int* __restrict__ jjs,
                      const float* __restrict__ coords,
                      __nv_bfloat16* __restrict__ out, int npix) {
  __shared__ __align__(16) float f1s[kTP][kC];
  __shared__ float corr[kTP][kCells];
  __shared__ float cxy[kTP][2];

  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kTP;
  const int t = threadIdx.x;
  const int ii = iis[e];
  const int jj = jjs[e];

  for (int k = t; k < kTP * kC; k += kThreads) {
    const int pp = k / kC, ch = k % kC;
    const int p = p0 + pp;
    f1s[pp][ch] = p < npix
        ? __bfloat162float(f1[((size_t)ii * npix + p) * kC + ch]) : 0.0f;
  }
  if (t < kTP * 2) {
    const int pp = t / 2, d = t % 2;
    const int p = p0 + pp;
    cxy[pp][d] = p < npix ? coords[((size_t)e * npix + p) * 2 + d] : 0.0f;
  }
  __syncthreads();

  const int pp = t / kCells;          // this thread's pixel in the tile
  const int cell = t % kCells;
  const int r = cell / kSide, c = cell % kSide;
  const bool pix_ok = p0 + pp < npix;

  for (int l = 0; l < kLevels; ++l) {
    const float inv = 1.0f / (float)(1 << l);
    const int h = lv.h[l], w = lv.w[l];
    {
      const float x = clean(cxy[pp][0] * inv, -16.0f, (float)w + 16.0f);
      const float y = clean(cxy[pp][1] * inv, -16.0f, (float)h + 16.0f);
      const int gy = (int)floorf(y) - kR + r;
      const int gx = (int)floorf(x) - kR + c;
      float acc = 0.0f;
      if (pix_ok && gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const uint4* row = reinterpret_cast<const uint4*>(
            lv.f2[l] + ((size_t)jj * h * w + (size_t)gy * w + gx) * kC);
        const float* a = f1s[pp];
#pragma unroll 4
        for (int v = 0; v < kC / 8; ++v) {
          const uint4 packed = __ldg(row + v);
          const __nv_bfloat162* b2 =
              reinterpret_cast<const __nv_bfloat162*>(&packed);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 bf = __bfloat1622float2(b2[q]);
            acc = fmaf(a[v * 8 + 2 * q], bf.x, acc);
            acc = fmaf(a[v * 8 + 2 * q + 1], bf.y, acc);
          }
        }
      }
      corr[pp][cell] = acc * (1.0f / 16.0f);
    }
    __syncthreads();
    if (t < kTP * kRD * kRD) {
      const int op = t / (kRD * kRD);
      const int s = t % (kRD * kRD);
      const int a = s / kRD, b = s % kRD;   // a: x offset, b: y offset
      const int p = p0 + op;
      if (p < npix) {
        const float x = clean(cxy[op][0] * inv, -16.0f, (float)w + 16.0f);
        const float y = clean(cxy[op][1] * inv, -16.0f, (float)h + 16.0f);
        const float fx = x - floorf(x), fy = y - floorf(y);
        const float* cr = corr[op];
        const float v =
            (1.0f - fy) * ((1.0f - fx) * cr[b * kSide + a]
                           + fx * cr[b * kSide + a + 1])
            + fy * ((1.0f - fx) * cr[(b + 1) * kSide + a]
                    + fx * cr[(b + 1) * kSide + a + 1]);
        out[((size_t)e * npix + p) * (kLevels * kRD * kRD)
            + l * kRD * kRD + s] = __float2bfloat16(v);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int glorie_lookup_pyramid(
    const void* f1, const void* f2_0, const void* f2_1, const void* f2_2,
    const void* f2_3, int h0, int w0, int h1, int w1, int h2, int w2,
    int h3, int w3, const void* iis, const void* jjs, const void* coords,
    void* out, int E, int npix, void* stream) {
  if (E <= 0 || npix <= 0) return 0;
  Levels lv;
  lv.f2[0] = static_cast<const __nv_bfloat16*>(f2_0);
  lv.f2[1] = static_cast<const __nv_bfloat16*>(f2_1);
  lv.f2[2] = static_cast<const __nv_bfloat16*>(f2_2);
  lv.f2[3] = static_cast<const __nv_bfloat16*>(f2_3);
  lv.h[0] = h0; lv.w[0] = w0; lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2; lv.h[3] = h3; lv.w[3] = w3;
  dim3 grid((npix + kTP - 1) / kTP, E);
  lookup_pyramid_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f1), lv,
      static_cast<const int*>(iis), static_cast<const int*>(jjs),
      static_cast<const float*>(coords),
      static_cast<__nv_bfloat16*>(out), npix);
  return (int)cudaGetLastError();
}
