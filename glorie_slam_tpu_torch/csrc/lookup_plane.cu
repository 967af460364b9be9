// Kernels D and E: 7x7 bilinear window lookup over precomputed correlation
// planes in pixel-minor layout.
//
// Kernel D replaces the TPU kernel glorie_slam_tpu/ops/pallas_corr.py
// lookup_pallas (:153, pallas_call :174, body _lookup_kernel :93); kernel
// E replaces lookup_pallas_slots (:477, pallas_call :507, body
// _lookup_kernel_slots :469), which reads plane row slots[e] of a
// capacity-S store instead of row e. Both are one template,
// lookup_plane_kernel<kSlots, kVec>.
//
// planes: (S, hl, wl, npix) bf16, plane[row, h, w, p] = correlation of
// source pixel p with target cell (h, w); coords: (E, npix, 2) float32
// [x, y] in level units (NaN -> 0; far-off values clamp to a point whose
// whole window is still off the plane). For edge e and pixel p:
//   out[e, p, a*7 + b] = sum over the 2x2 bilinear corners of the sample
//       (x - 3 + a, y - 3 + b) of weight * plane[row, corner, p],
// with out-of-plane corners contributing zero; out is (E, npix, 49) f32.
//
// What bounds it: the function needs each (edge, pixel)'s in-plane 8x8
// window cells once (2 bytes each), the coordinates and the float32
// output: 96 MB, 0.029 ms at 3.35 TB/s on chip_smoke's kernels-phase
// inputs. But a pixel's cells lie npix elements apart, so device memory
// serves them as 32-byte sectors: a sector at one cell holds 16
// consecutive pixels. Read one value per sector request, as a thread per
// pixel does, and the kernel is bound by sector requests (537 MB of them
// there). Read each distinct sector that a group of 16 consecutive pixels
// touches once and fully, and the least traffic is those sectors plus the
// output and coordinates: 254 MB, 0.076 ms there at the full memory rate
// (the sector floor; cuda_corr.plane_sector_stats is the same count on
// the host). Scattered 32-byte reads do not reach that rate: the card
// serves them at about a third of its rate for contiguous reads
// (scripts/sector_read_rate.py times both, and these very sectors), so
// the sector reads, and not the arithmetic, hold the kernel above the
// floor.
//
// The design reads exactly those sectors:
//
// * A block is one warp: one edge and 32 consecutive pixels, two sector
//   groups of 16, one per half-warp. Eight blocks share an SM (their
//   stages fill its shared memory); E's block reads slots[e] once.
// * A group marks the cells its windows touch in a bitmap in shared
//   memory (each pixel ORs in its window's in-plane cells, a run of at
//   most 8 bits per row), over a band of kBits consecutive row-major
//   cells from the group's first touched cell; only the words up to its
//   last touched cell are cleared and scanned. An exclusive prefix of the
//   words' popcounts numbers the touched cells; the lanes list them in
//   that order and copy their sectors into a stage in shared memory with
//   cp.async, 16 bytes a lane, neighbouring lanes on the two halves of a
//   sector (8-, 4- or 2-byte pieces when npix is not a multiple of 8,
//   which breaks the sectors' 16-byte alignment).
// * Each lane then forms its pixel's 49 values in float32 from its 8x8
//   cells in the stage, accumulating window row b from cell rows b and
//   b + 1. A window row's in-plane cells are all marked, so their slots
//   are consecutive: one popcount per row finds them. Cells off the plane
//   read as 0; NaN and far-off pixels mark nothing beyond their own
//   in-plane cells.
// * More touched cells than the stage holds (kCap) take more passes over
//   the same bitmap; cells beyond the band take further bands, each
//   starting at the next touched cell. One band covers a 40x80 plane; one
//   pass covers 87% of the groups of chip_smoke's noisy kernels-phase
//   inputs (311 touched cells on average, 557 at most) and every group of
//   its smooth flow (at most 214).
// * The outputs are staged in shared memory and each group writes its
//   16 x 49 floats as one contiguous run (16-byte stores when npix is a
//   multiple of 4).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;          // window radius
constexpr int kRD = 7;         // window side
constexpr int kWin = kRD * kRD;
constexpr int kSide = 8;       // cells a window touches per axis
constexpr int kGroup = 16;     // pixels per sector group (32 bytes of bf16)
constexpr int kWarps = 1;     // blocks of one warp free their stages alone
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = kThreads / kGroup;   // per block
constexpr int kBits = 4096;    // row-major cells per band
constexpr int kWords = kBits / 32;
constexpr int kCap = 384;      // cells staged per pass
constexpr float kMargin = 16.0f;   // coordinates clamp to [-16, size + 16]
constexpr unsigned kFull = 0xffffffffu;

// One sector group's shared memory (13,824 bytes; 2 per block).
struct GroupSmem {
  __nv_bfloat16 stage[kCap * kGroup];   // cell slot k: 16 pixels' values;
                                        // then the group's 16 x 49 outputs
  uint32_t bits[kWords];                // touched cells of the band
  uint16_t base[kWords];                // touched cells before each word
  uint16_t list[kCap];                  // band cell of each slot
};
static_assert(kGroup * kWin * 4 <= kCap * kGroup * 2, "output stage");
static_assert(sizeof(GroupSmem) % 16 == 0, "group alignment");
constexpr int kSmem = kGroups * (int)sizeof(GroupSmem);
// blocks that fit an SM's 228 KB of shared memory (1 KB reserved each)
constexpr int kBlocksPerSm = 228 * 1024 / (kSmem + 1024);

__device__ __forceinline__ float clean(float v, float lo, float hi) {
  // NaN -> 0 (the TPU kernel's nan_to_num); far-out coordinates clamp to
  // a value whose whole window is still off the plane (same zero output)
  if (isnan(v)) return 0.0f;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int group_min(int v) {
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, o, kGroup));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One piece of a sector: kVec bf16 values from device to shared memory
template <int kVec>
__device__ __forceinline__ void copy_piece(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src) {
  if constexpr (kVec == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                     "r"(smem_addr(dst)), "l"(src));
  } else if constexpr (kVec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::
                     "r"(smem_addr(dst)), "l"(src));
  } else if constexpr (kVec == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                     "r"(smem_addr(dst)), "l"(src));
  } else {
    *dst = *src;
  }
}

// bits s..t (t - s < 32) of a band's bitmap
__device__ __forceinline__ void mark(uint32_t* bits, int s, int t) {
  const uint32_t lo = ~((1u << (s & 31)) - 1u);
  const uint32_t hi = (2u << (t & 31)) - 1u;
  if ((s >> 5) == (t >> 5)) {
    atomicOr(&bits[s >> 5], lo & hi);
  } else {
    atomicOr(&bits[s >> 5], lo);
    atomicOr(&bits[t >> 5], hi);
  }
}

template <bool kSlots, int kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
lookup_plane_kernel(const __nv_bfloat16* __restrict__ planes,
                    const int* __restrict__ slots,
                    const float* __restrict__ coords,
                    float* __restrict__ out, int hl, int wl, int npix) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.y;
  // E: one load of slots[e] for the block (the warp's lanes read one
  // address), not waited for before the first copy
  const int row = kSlots ? __ldg(slots + e) : e;
  const int l16 = threadIdx.x % kGroup;
  const int gi = threadIdx.x / kGroup;
  GroupSmem& g = reinterpret_cast<GroupSmem*>(smem_raw)[gi];
  const int pg0 = (blockIdx.x * kGroups + gi) * kGroup;
  const int m = min(kGroup, npix - pg0);     // the group's pixels (<= 0:
  const bool live = l16 < m;                 // none, past the end)
  if (__all_sync(kFull, !live)) return;      // a warp past the end
  const __nv_bfloat16* plane = planes + (size_t)row * hl * wl * npix;
  const float2 c = live ? reinterpret_cast<const float2*>(coords)[
      (size_t)e * npix + pg0 + l16] : make_float2(0.0f, 0.0f);

  // the pixel's window origin, weights and in-plane cells xa..xb, ya..yb
  float fx = 0.0f, fy = 0.0f;
  int gx0 = 0, gy0 = 0, xa = 0, xb = -1, ya = 0, yb = -1;
  if (live) {
    const float x = clean(c.x, -kMargin, (float)wl + kMargin);
    const float y = clean(c.y, -kMargin, (float)hl + kMargin);
    const float x0 = floorf(x), y0 = floorf(y);
    fx = x - x0;
    fy = y - y0;
    gx0 = (int)x0 - kR;
    gy0 = (int)y0 - kR;
    xa = max(gx0, 0);
    xb = min(gx0 + kSide - 1, wl - 1);
    ya = max(gy0, 0);
    yb = min(gy0 + kSide - 1, hl - 1);
  }
  const bool any = xa <= xb && ya <= yb;
  const int ca = xa - gx0, cb = xb - gx0;    // in-plane window columns

  float acc[kRD][kRD];   // [a][b]: x offset a, y offset b
#pragma unroll
  for (int a = 0; a < kRD; ++a)
#pragma unroll
    for (int b = 0; b < kRD; ++b) acc[a][b] = 0.0f;

  // bands of kBits row-major cells, each from the group's next touched
  // cell (INT_MAX when the group has none left); last: the group's last
  // touched cell, so only the words up to it are cleared and scanned
  int band = group_min(any ? ya * wl + xa : INT_MAX);
  const int last = -group_min(any ? -(yb * wl + xb) : INT_MAX);
  while (__any_sync(kFull, band != INT_MAX)) {
    const bool active = band != INT_MAX;
    const int nw = active ? min(kWords, ((last - band) >> 5) + 1) : 0;
    const int rounds =
        __reduce_max_sync(kFull, (nw + kGroup - 1) / kGroup);
    for (int w = l16; w < nw; w += kGroup) g.bits[w] = 0u;
    __syncwarp();
    if (active && any) {
      for (int y = ya; y <= yb; ++y) {
        const int s = max(y * wl + xa - band, 0);
        const int t = min(y * wl + xb - band, kBits - 1);
        if (s <= t) mark(g.bits, s, t);
      }
    }
    __syncwarp();
    // base[w]: touched cells in words before w (16 words at a time, one
    // per lane)
    int total = 0;
    for (int q = 0; q < rounds; ++q) {
      const int w = q * kGroup + l16;
      const int n = w < nw ? __popc(g.bits[w]) : 0;
      int incl = n;
#pragma unroll
      for (int o = 1; o < kGroup; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o, kGroup);
        if (l16 >= o) incl += v;
      }
      if (w < nw) g.base[w] = (uint16_t)(total + incl - n);
      total += __shfl_sync(kFull, incl, kGroup - 1, kGroup);
    }
    __syncwarp();

    // passes of up to kCap touched cells
    for (int first = 0; __any_sync(kFull, first < total); first += kCap) {
      const int n = max(0, min(kCap, total - first));
      for (int w = l16; w < nw; w += kGroup) {
        uint32_t bw = g.bits[w];
        int k = (int)g.base[w] - first;
        if (k >= kCap || k + __popc(bw) <= 0) continue;
        while (bw) {
          const int bit = __ffs(bw) - 1;
          bw &= bw - 1u;
          if (k >= 0 && k < kCap) g.list[k] = (uint16_t)(w * 32 + bit);
          ++k;
        }
      }
      __syncwarp();
      constexpr int kPieces = kGroup / kVec;
      for (int i = l16; i < n * kPieces; i += kGroup) {
        const int k = i / kPieces, j = (i % kPieces) * kVec;
        if (j < m)
          copy_piece<kVec>(&g.stage[k * kGroup + j],
                           plane + (size_t)(band + g.list[k]) * npix + pg0 +
                               j);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();

      if (active && any) {
#pragma unroll
        for (int r = 0; r < kSide; ++r) {
          const int y = gy0 + r;
          if (y < ya || y > yb) continue;
          // the row's window cells are band cells rb + c; its in-plane
          // ones in this band (columns lo..hi) are all marked, so their
          // slots are consecutive from that of column lo
          const int rb = y * wl + gx0 - band;
          const int lo = max(ca, -rb), hi = min(cb, kBits - 1 - rb);
          if (lo > hi) continue;
          const int s = rb + lo;
          const int k0 = (int)g.base[s >> 5] - first - lo +
              __popc(g.bits[s >> 5] & ((1u << (s & 31)) - 1u));
          float v[kSide];
#pragma unroll
          for (int cc = 0; cc < kSide; ++cc) {
            const int k = k0 + cc;
            v[cc] = (cc >= lo && cc <= hi && k >= 0 && k < kCap)
                ? __bfloat162float(g.stage[k * kGroup + l16]) : 0.0f;
          }
#pragma unroll
          for (int a = 0; a < kRD; ++a) {
            const float h = (1.0f - fx) * v[a] + fx * v[a + 1];
            if (r < kRD) acc[a][r] += (1.0f - fy) * h;
            if (r > 0) acc[a][r - 1] += fy * h;
          }
        }
      }
      __syncwarp();
    }

    // the next band starts at the group's first touched cell past it
    const int band_end = active ? band + kBits : 0;
    int next = INT_MAX;
    if (active && any) {
      for (int y = ya; y <= yb; ++y) {
        if (y * wl + xb >= band_end) {
          next = max(y * wl + xa, band_end);
          break;
        }
      }
    }
    band = group_min(next);
  }

  // outputs: staged, then one contiguous run of m x 49 floats per group
  float* os = reinterpret_cast<float*>(g.stage);
  if (live) {
#pragma unroll
    for (int a = 0; a < kRD; ++a)
#pragma unroll
      for (int b = 0; b < kRD; ++b)
        os[l16 * kWin + a * kRD + b] = acc[a][b];
  }
  __syncwarp();
  const int count = max(m, 0) * kWin;
  float* dst = out + ((size_t)e * npix + min(pg0, npix)) * kWin;
  if (kVec >= 4) {   // npix % 4 == 0: the run starts 16-byte aligned
    const float4* s4 = reinterpret_cast<const float4*>(os);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = l16; k < count / 4; k += kGroup) d4[k] = s4[k];
  } else {
    for (int k = l16; k < count; k += kGroup) dst[k] = os[k];
  }
}

template <bool kSlots, int kVec>
int launch(const void* planes, const void* slots, const void* coords,
           void* out, int E, int hl, int wl, int npix, void* stream) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        lookup_plane_kernel<kSlots, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)   // all of the SM's 228 KB as shared memory
      err = cudaFuncSetAttribute(
          lookup_plane_kernel<kSlots, kVec>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  dim3 grid((npix + kThreads - 1) / kThreads, E);
  lookup_plane_kernel<kSlots, kVec><<<grid, kThreads, kSmem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(planes),
      static_cast<const int*>(slots), static_cast<const float*>(coords),
      static_cast<float*>(out), hl, wl, npix);
  return (int)cudaGetLastError();
}

template <bool kSlots>
int launch_vec(const void* planes, const void* slots, const void* coords,
               void* out, int E, int hl, int wl, int npix, void* stream) {
  // the widest piece that keeps every sector piece aligned: a cell's
  // values start at element cell * npix + 16 * group
  if (npix % 8 == 0)
    return launch<kSlots, 8>(planes, slots, coords, out, E, hl, wl, npix,
                             stream);
  if (npix % 4 == 0)
    return launch<kSlots, 4>(planes, slots, coords, out, E, hl, wl, npix,
                             stream);
  if (npix % 2 == 0)
    return launch<kSlots, 2>(planes, slots, coords, out, E, hl, wl, npix,
                             stream);
  return launch<kSlots, 1>(planes, slots, coords, out, E, hl, wl, npix,
                           stream);
}

}  // namespace

// slots == nullptr: kernel D (plane row e); else kernel E (row slots[e]).
// Planes must start 16-byte aligned and hold fewer than 2^31 - kBits
// cells (the wrappers check both).
extern "C" int glorie_lookup_plane(const void* planes, const void* slots,
                                   const void* coords, void* out, int E,
                                   int hl, int wl, int npix, void* stream) {
  if (E <= 0 || npix <= 0) return 0;
  if (slots == nullptr)
    return launch_vec<false>(planes, nullptr, coords, out, E, hl, wl, npix,
                             stream);
  return launch_vec<true>(planes, slots, coords, out, E, hl, wl, npix,
                          stream);
}

// The sector rule's constants, for cuda_corr.plane_sector_stats (the host
// copy of the rule, checked against these when the library loads): pixels
// per sector group, the coordinate clamp margin, cells per band.
extern "C" void glorie_lookup_plane_geometry(int* v) {
  v[0] = kGroup;
  v[1] = (int)kMargin;
  v[2] = kBits;
}
