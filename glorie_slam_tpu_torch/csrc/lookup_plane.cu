// Kernels D and E: 7x7 bilinear window lookup over precomputed correlation
// planes in pixel-minor layout.
//
// Kernel D replaces the TPU kernel glorie_slam_tpu/ops/pallas_corr.py
// lookup_pallas (:153, body _lookup_kernel :93); kernel E replaces
// lookup_pallas_slots (:477, body _lookup_kernel_slots :469), which reads
// plane row slots[e] of a capacity-S store instead of row e. Both are one
// template, lookup_plane_kernel<kSlots>.
//
// planes: (S, hl, wl, npix) bf16, plane[row, h, w, p] = correlation of
// source pixel p with target cell (h, w); coords: (E, npix, 2) float32
// [x, y] in level units (NaN -> 0). For edge e and pixel p:
//   out[e, p, a*7 + b] = sum over the 2x2 bilinear corners of the sample
//       (x - 3 + a, y - 3 + b) of weight * plane[row, corner, p],
// with out-of-plane corners contributing zero; out is (E, npix, 49) f32.
//
// The TPU kernels read a whole plane (or a band of rows, with an escape to
// the whole plane) for 128 pixels at a time and reduced it with hat
// weights on the vector unit. Here one thread takes one (edge, pixel) and
// reads only the 8x8 cells its window touches, a row at a time, forming
// the window's row b from cell rows b and b + 1. The 49 outputs of a
// thread go to shared memory (stride 49 is odd, so a warp's writes hit 32
// banks) and the block writes its pixels' outputs as one contiguous run.
//
// What bounds them on the card: bytes. The function needs the 64 touched
// cells of each (edge, pixel) and writes 196 bytes of output. The cell
// reads are scattered 2-byte loads (neighbouring pixels' windows sit one
// cell apart in a plane whose cells are npix elements apart), so each
// costs a 32-byte sector: this version moves several times the bytes its
// bound counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kR = 3;        // window radius
constexpr int kRD = 7;       // window side
constexpr int kWin = kRD * kRD;
constexpr int kSide = 8;     // cells a window touches per axis
constexpr int kTP = 128;     // pixels (threads) per block

__device__ __forceinline__ float clean(float v, float lo, float hi) {
  // NaN -> 0 (the TPU kernel's nan_to_num); far-out coordinates clamp to
  // a value whose whole window is still off the plane (same zero output)
  if (isnan(v)) return 0.0f;
  return fminf(fmaxf(v, lo), hi);
}

template <bool kSlots>
__global__ void __launch_bounds__(kTP)
lookup_plane_kernel(const __nv_bfloat16* __restrict__ planes,
                    const int* __restrict__ slots,
                    const float* __restrict__ coords,
                    float* __restrict__ out, int hl, int wl, int npix) {
  __shared__ float tile[kTP * kWin];

  const int e = blockIdx.y;
  const int p0 = blockIdx.x * kTP;
  const int t = threadIdx.x;
  const int p = p0 + t;
  const int row = kSlots ? slots[e] : e;
  const __nv_bfloat16* plane = planes + (size_t)row * hl * wl * npix;

  if (p < npix) {
    const float* cp = coords + ((size_t)e * npix + p) * 2;
    const float x = clean(cp[0], -16.0f, (float)wl + 16.0f);
    const float y = clean(cp[1], -16.0f, (float)hl + 16.0f);
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int gx0 = (int)x0 - kR, gy0 = (int)y0 - kR;
    float* o = tile + t * kWin;
    float prev[kSide], cur[kSide];
#pragma unroll
    for (int r = 0; r < kSide; ++r) {
      const int gy = gy0 + r;
      const bool row_ok = gy >= 0 && gy < hl;
#pragma unroll
      for (int c = 0; c < kSide; ++c) {
        const int gx = gx0 + c;
        cur[c] = (row_ok && gx >= 0 && gx < wl)
            ? __bfloat162float(plane[((size_t)gy * wl + gx) * npix + p])
            : 0.0f;
      }
      if (r > 0) {
        const int b = r - 1;          // window row (y offset)
#pragma unroll
        for (int a = 0; a < kRD; ++a) {   // window column (x offset)
          o[a * kRD + b] =
              (1.0f - fy) * ((1.0f - fx) * prev[a] + fx * prev[a + 1])
              + fy * ((1.0f - fx) * cur[a] + fx * cur[a + 1]);
        }
      }
#pragma unroll
      for (int c = 0; c < kSide; ++c) prev[c] = cur[c];
    }
  }
  __syncthreads();

  const int n = min(kTP, npix - p0) * kWin;
  float* dst = out + ((size_t)e * npix + p0) * kWin;
  for (int k = t; k < n; k += kTP) dst[k] = tile[k];
}

}  // namespace

// slots == nullptr: kernel D (plane row e); else kernel E (row slots[e]).
extern "C" int glorie_lookup_plane(const void* planes, const void* slots,
                                   const void* coords, void* out, int E,
                                   int hl, int wl, int npix, void* stream) {
  if (E <= 0 || npix <= 0) return 0;
  dim3 grid((npix + kTP - 1) / kTP, E);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* pl = static_cast<const __nv_bfloat16*>(planes);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (slots == nullptr) {
    lookup_plane_kernel<false><<<grid, kTP, 0, st>>>(pl, nullptr, c, o, hl,
                                                     wl, npix);
  } else {
    lookup_plane_kernel<true><<<grid, kTP, 0, st>>>(
        pl, static_cast<const int*>(slots), c, o, hl, wl, npix);
  }
  return (int)cudaGetLastError();
}
