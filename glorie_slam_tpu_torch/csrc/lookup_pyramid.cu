// Kernel A: 4-level windowed correlation lookup computed from features,
// and kernel C: the same lookup for one level.
//
// Kernel A replaces the TPU kernel glorie_slam_tpu/ops/pallas_corr.py
// lookup_feats_pyramid_pallas (:363, body _lookup_feats_pyr_kernel :299);
// kernel C replaces lookup_feats_pallas (:251, body _lookup_feats_kernel
// :192), which runs once per level when a feature pyramid does not have 4
// levels. Both are one template, lookup_feats_kernel<L, OutT>: kernel A is
// L = 4 with bf16 output, kernel C is L = 1 with float32 output and its
// coordinates already in level units (the caller divided them by 2^l).
//
// For edge e, source pixel p and level l (level coordinates
// x = cx / 2^l, y = cy / 2^l):
//   corr(q) = <f1[iis[e], p], f2_l[jjs[e], q]> / 16       (fp32 accumulate)
//   out[e, p, l*49 + a*7 + b] = sum over the 2x2 bilinear corners of the
//       sample (x - 3 + a, y - 3 + b) of hat weight * corr(corner),
// with out-of-plane corners contributing zero.
//
// What bounds it on the card: bytes. The stores are read once and the
// output written once (140 MB at 96 edges of a 40x80 grid, 0.042 ms at
// 3.35 TB/s); the dot products of the window cells alone are ~20 GFLOP,
// 0.02 ms on the bf16 tensor cores. A pixel's 7x7 window and its bilinear
// neighbours span 8x8 target cells per level, and neighbouring pixels'
// windows overlap almost entirely, so the design shares f2 rows between
// the pixels of a tile and computes on the tensor cores:
//
// * One block takes one edge and a 2-D tile of 64 source pixels (8x8 on
//   the pixel grid; kernel C, whose interface has no grid width, infers it
//   from the level's size when 2^k-scaled level sizes cover npix, else it
//   takes a raster run of 64 pixels). Its f1 rows arrive in shared memory
//   by cp.async, and each warp keeps the wgmma A fragments of its 16
//   pixels in registers for all levels.
// * Per level, the tile's box is, row by row, the span of the in-plane
//   8x8 window cells of its pixels (pixels off the grid or with no
//   in-plane cell add nothing; a NaN centre adds its own cells near the
//   origin only on the rows they occupy). A box row is contiguous in the
//   (N, h_l, w_l, 128) store.
// * The box's cells are walked in runs of 32, alternately by the block's
//   two warpgroups, each on its own ring of shared-memory stages filled by
//   cp.async and with its own named barrier, so the two overlap. A run is
//   one wgmma m64n32k16 chain over K = 128 (bf16 in, fp32 accumulate; B
//   read from shared memory in the K-major layout without swizzle). An
//   accumulator (pixel m, cell n) that lies in m's window goes, times
//   1/16, into m's 8x8 cell buffer in shared memory; the rest are dropped.
//   Any box, up to the whole plane, takes the same loop.
// * Per level each pixel's 49 bilinear outputs go to a shared-memory tile
//   (off-plane cells read as 0). A tile holds the levels whose outputs
//   form one 196-byte run per pixel (levels 2l and 2l + 1 of A, C's one
//   level) and leaves in 4-byte words: a run starts 4-byte aligned, and a
//   tile of all four levels would cap the kernel at two blocks per SM,
//   where it measured slower than at three.
// Level sizes of 0 give an empty box and an all-zero level. Cells are
// keyed y * 65536 + x, so the wrappers refuse planes of 16384 rows or
// 32768 columns.
//
// What holds it above the bound: each block's chain of steps, not bytes
// or products. Three blocks share an SM, and a run's time goes mostly to
// issuing its copies and to the scatter, the products finishing first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;       // feature channels (the MMA's K)
constexpr int kR = 3;         // window radius
constexpr int kRD = 7;        // window side
constexpr int kSide = 8;      // target cells a window touches per axis
constexpr int kTile = 64;     // pixels per block (the MMA's M)
constexpr int kRun = 32;      // box cells per stage (the MMA's N)
constexpr int kThreads = 256; // 2 warpgroups, each with its own runs
constexpr int kStages = 2;    // shared-memory stages per warpgroup
constexpr int kTables = kStages + 1;  // one more than the stages
constexpr int kCore = 128;    // bytes of an 8-row x 8-channel core matrix
constexpr int kGroup = 8 * kC * 2;  // bytes of 8 whole rows
// cell buffer row stride in floats: the pixels of a tile row see one cell
// at window columns one apart, so stride - 1 must be odd for the scatter's
// stores to fall in distinct banks
constexpr int kCellLd = kSide * kSide + 2;
constexpr int kMaxRows = 128; // box rows handled per pass
constexpr int kBig = 1 << 29;
constexpr int kOff = 1 << 24; // window origin of a pixel that takes no cell
constexpr float kMargin = 16.0f;  // coordinates clamp to [-kMargin, size + kMargin]
// cells and window origins as keys y * 65536 + x (planes below 16384 rows
// and 32768 columns, checked by the wrappers): a cell lies in a window iff
// key(cell) - key(origin) has no bits outside 0x00070007
constexpr int kKeyY = 65536;
constexpr int kKeyMask = ~0x00070007;
constexpr int kNoCell = -(1 << 30);   // key of a table slot past the box
constexpr int kNoPixel = 1 << 30;     // origin key of a pixel with no cell
constexpr unsigned kAll = 0xffffffffu;

template <int L>
struct Levels {
  const __nv_bfloat16* f2[L];
  int h[L];
  int w[L];
};

template <int L, typename OutT>
struct Smem {
  // each warpgroup's ring of runs of 32 rows of 128 channels, in wgmma's
  // K-major layout without swizzle (row_at); the f1 tile's 64 rows first
  // take the first two stages
  __nv_bfloat16 stage[2][kStages][kRun * kC];
  float cells[kTile][kCellLd];          // each pixel's 8x8 window cells
  // the outputs of the levels whose 49-value runs form one 196-byte run
  // of out per pixel: levels 2l, 2l + 1 of kernel A, C's one level
  OutT out[kTile * 196 / sizeof(OutT)];
  float cxy[kTile][2];
  float frac[kTile][2];                 // fx, fy at the current level
  int2 org[kTile];                      // window origins at this level
  int2 cell_xy[2][kTables][kRun];       // each run's cells: key, offset
  int xlo[kMaxRows], xhi[kMaxRows];     // the box's row spans
  int prefix[kThreads / 32][kMaxRows + 1];  // each warp's scan of them
};

// element offset of channels 8c..8c+7 of row r in a stage: 8x8 core
// matrices of 128 contiguous bytes, the 16 of a row group 128 B apart
// (wgmma's leading byte offset), row groups 2048 B apart (its stride)
__device__ __forceinline__ int row_at(int r, int c) {
  return ((r >> 3) * kGroup + c * kCore + (r & 7) * 16) / 2;
}

__device__ __forceinline__ float clean(float v, float lo, float hi) {
  // NaN -> 0 (the TPU kernel's nan_to_num); far-out coordinates clamp to
  // a value whose whole window is still off the plane (same zero output)
  if (isnan(v)) return 0.0f;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's completed cp.async writes visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// shared-memory matrix descriptor of a K-major operand without swizzle
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4)
         | (uint64_t)(kCore >> 4) << 16 | (uint64_t)(kGroup >> 4) << 32;
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions
__device__ __forceinline__ void hold(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32 over the warpgroup) += a (64 x 16, registers) * b (16 x 32)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// barrier of warpgroup g's 128 threads (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(g + 1) : "memory");
}

// Grid: (tiles of the gw x (npix / gw) pixel grid, E). A tile is tw
// pixels wide and kTile / tw rows high.
template <int L, typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
lookup_feats_kernel(const __nv_bfloat16* __restrict__ f1, Levels<L> lv,
                    const int* __restrict__ iis,
                    const int* __restrict__ jjs,
                    const float* __restrict__ coords,
                    OutT* __restrict__ out, int npix, int gw, int tw) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<L, OutT>& s = *reinterpret_cast<Smem<L, OutT>*>(smem_raw);
  constexpr int kOut = L * kRD * kRD;    // output values per pixel
  constexpr int kPair = 4 / (int)sizeof(OutT);  // levels staged together
  static_assert(L % kPair == 0, "staged levels must tile L");

  const int th = kTile / tw, gh = npix / gw;
  const int ntx = (gw + tw - 1) / tw;
  const int tx0 = (blockIdx.x % ntx) * tw, ty0 = (blockIdx.x / ntx) * th;
  const int e = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ii = iis[e], jj = jjs[e];

  // the tile's f1 rows (zero rows for pixels off the grid) and coords;
  // a warp writes 4 x 128 contiguous bytes of the stage per copy
  __nv_bfloat16* const f1s = &s.stage[0][0][0];
  for (int k = t; k < kTile * (kC / 8); k += kThreads) {
    const int m = (k & 7) + 8 * (k >> 7), c = (k >> 3) & 15;
    const int gx = tx0 + m % tw, gy = ty0 + m / tw;
    const bool ok = gx < gw && gy < gh;
    const __nv_bfloat16* src =
        ok ? f1 + ((size_t)ii * npix + (size_t)gy * gw + gx) * kC + c * 8
           : f1;
    cp_async16(&f1s[row_at(m, c)], src, ok);
  }
  cp_async_commit();
  if (t < kTile * 2) {
    const int m = t / 2, gx = tx0 + m % tw, gy = ty0 + m / tw;
    s.cxy[m][t % 2] = gx < gw && gy < gh
        ? coords[((size_t)e * npix + (size_t)gy * gw + gx) * 2 + t % 2]
        : 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // warp mt of warpgroup nh holds the mma fragments of pixels mt*16..+15
  // for the whole kernel
  const int mt = warp & 3, nh = warp >> 2;
  uint32_t a[kC / 16][4];
#pragma unroll
  for (int ks = 0; ks < kC / 16; ++ks)
    ldmatrix_x4(a[ks], &f1s[row_at(mt * 16 + (lane & 15),
                                  2 * ks + (lane >> 4))]);
  const int m_lo = mt * 16 + (lane >> 2), m_hi = m_lo + 8;
  int* const pre = s.prefix[warp];
  __syncthreads();  // the stages now take f2 runs

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const __nv_bfloat16* f2 = lv.f2[l];
    const int h = lv.h[l], w = lv.w[l];
    const float inv = 1.0f / (float)(1 << l);

    // every warp: the windows of pixels lane and lane + 32, their in-plane
    // parts [ix0, ix1] x [iy0, iy1] (none for a pixel that takes no cell)
    // and the box's row range; warp 0 records origins and fractions
    int ix0[2], ix1[2], iy0[2], iy1[2], ox[2], oy[2];
    int ylo = kBig, yhi = -kBig;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int m = lane + 32 * q;
      const int gx = tx0 + m % tw, gy = ty0 + m / tw;
      const float x = clean(s.cxy[m][0] * inv, -kMargin, (float)w + kMargin);
      const float y = clean(s.cxy[m][1] * inv, -kMargin, (float)h + kMargin);
      ox[q] = (int)floorf(x) - kR;
      oy[q] = (int)floorf(y) - kR;
      ix0[q] = max(ox[q], 0);
      ix1[q] = min(ox[q] + kSide - 1, w - 1);
      iy0[q] = max(oy[q], 0);
      iy1[q] = min(oy[q] + kSide - 1, h - 1);
      if (!(gx < gw && gy < gh && ix0[q] <= ix1[q] && iy0[q] <= iy1[q])) {
        iy0[q] = kBig;
        iy1[q] = -kBig;
        ox[q] = oy[q] = kOff;
      }
      if (warp == 0) {
        s.org[m] = make_int2(ox[q], oy[q]);
        s.frac[m][0] = x - floorf(x);
        s.frac[m][1] = y - floorf(y);
      }
      ylo = min(ylo, iy0[q]);
      yhi = max(yhi, iy1[q]);
    }
    ylo = __reduce_min_sync(kAll, ylo);
    yhi = __reduce_max_sync(kAll, yhi);
    if (ylo > yhi) __syncthreads();  // no pass below: order the records
    // window origin keys of this thread's accumulator rows (pixels m_lo,
    // m_hi lie in the same half of the tile)
    const int hx = mt >> 1 ? ox[1] : ox[0], hy = mt >> 1 ? oy[1] : oy[0];
    const int hk = hx == kOff ? kNoPixel : hy * kKeyY + hx;
    const int ko_lo = __shfl_sync(kAll, hk, m_lo & 31);
    const int ko_hi = __shfl_sync(kAll, hk, m_hi & 31);
    const __nv_bfloat16* const f2j = f2 + (size_t)jj * h * w * kC;

    for (int yp = ylo; yp <= yhi; yp += kMaxRows) {
      // box rows yp .. yp + nrows - 1: warp w takes rows w, w + 8, ...
      const int nrows = min(kMaxRows, yhi - yp + 1);
      for (int r = warp; r < nrows; r += kThreads / 32) {
        const int y = yp + r;
        int lo = kBig, hi = -kBig;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (iy0[q] <= y && y <= iy1[q]) {
            lo = min(lo, ix0[q]);
            hi = max(hi, ix1[q]);
          }
        }
        lo = __reduce_min_sync(kAll, lo);
        hi = __reduce_max_sync(kAll, hi);
        if (lane == 0) {
          s.xlo[r] = lo;
          s.xhi[r] = hi;
        }
      }
      __syncthreads();
      // each warp's own prefix sums of the row spans
      int total = 0;
      for (int base = 0; base < nrows; base += 32) {
        const int i = base + lane;
        const int len = i < nrows ? max(s.xhi[i] - s.xlo[i] + 1, 0) : 0;
        int v = len;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int n = __shfl_up_sync(kAll, v, off);
          if (lane >= off) v += n;
        }
        if (i < nrows) pre[i] = total + v - len;
        total += __shfl_sync(kAll, v, 31);
      }
      if (lane == 0) pre[nrows] = total;
      __syncwarp();
      // warpgroup nh takes the box's cells in runs of 32: runs nh, nh + 2,
      // ... (its k-th run is cells 32 * (2k + nh) ..), on its own ring
      const int nrun = (total + kRun - 1) / kRun;
      const int mine = (nrun - nh + 1) / 2;
      const int wt = t & 127;                  // thread in the warpgroup

      // cell wt of this warpgroup's k-th run into table tb (the
      // warpgroup's first kRun threads): its key and its index y * w + x
      // in the target frame's store (-1 past the box)
      auto table = [&](int k, int tb) {
        const int j = (2 * k + nh) * kRun + wt;
        int2 cell = make_int2(kNoCell, -1);
        if (j < total) {
          int lo = 0, hi = nrows;              // pre[lo] <= j < pre[lo + 1]
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (pre[mid] <= j) lo = mid; else hi = mid;
          }
          const int x = s.xlo[lo] + (j - pre[lo]), y = yp + lo;
          cell = make_int2(y * kKeyY + x, y * w + x);
        }
        s.cell_xy[nh][tb][wt] = cell;
      };
      // the k-th run's f2 rows into stage st (zero rows past the box)
      auto issue = [&](int k, int st) {
#pragma unroll
        for (int i = 0; i < kRun * (kC / 8) / 128; ++i) {
          const int idx = wt + i * 128;
          const int r = (idx & 7) + 8 * (idx >> 7), c = (idx >> 3) & 15;
          const int ci = s.cell_xy[nh][k % kTables][r].y;
          cp_async16(&s.stage[nh][st][row_at(r, c)],
                     f2j + (size_t)max(ci, 0) * kC + c * 8, ci >= 0);
        }
      };

      // each warpgroup: a ring of kStages stages, kStages - 1 runs in
      // flight, a run's cell table made one iteration before its copies;
      // the two warpgroups meet only at the block barrier after the loop
      if (wt < kRun)
        for (int k = 0; k < min(mine, kStages); ++k) table(k, k);
      group_sync(nh);
#pragma unroll
      for (int k = 0; k < kStages - 1; ++k) {
        if (k < mine) issue(k, k);
        cp_async_commit();
      }
      for (int k = 0, st = 0; k < mine;
           ++k, st = st + 1 == kStages ? 0 : st + 1) {
        cp_async_wait<kStages - 2>();
        fence_async_shared();
        group_sync(nh);

        // the products run on the tensor cores while this thread queues
        // the copies of run k + 2 and makes the table of run k + 3
        float d[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) d[i] = 0.0f;
        hold(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const char* b = reinterpret_cast<const char*>(s.stage[nh][st]);
#pragma unroll
        for (int ks = 0; ks < kC / 16; ++ks)
          wgmma_m64n32k16(d, a[ks], wgmma_desc(b + ks * 2 * kCore));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

        if (k + kStages - 1 < mine)
          issue(k + kStages - 1, st == 0 ? kStages - 1 : st - 1);
        cp_async_commit();
        if (wt < kRun && k + kStages < mine)
          table(k + kStages, (k + kStages) % kTables);

        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        hold(d);

        // keep (pixel, cell) pairs inside the pixel's window
        const int2* cells = s.cell_xy[nh][k % kTables];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int key = cells[j * 8 + (lane & 3) * 2 + q].x;
            int dd = key - ko_lo;                // dy * 65536 + dx
            if (!(dd & kKeyMask))
              s.cells[m_lo][((dd >> 13) & 0x38) | (dd & 7)] =
                  d[4 * j + q] * (1.0f / 16.0f);
            dd = key - ko_hi;
            if (!(dd & kKeyMask))
              s.cells[m_hi][((dd >> 13) & 0x38) | (dd & 7)] =
                  d[4 * j + 2 + q] * (1.0f / 16.0f);
          }
        }
      }
      __syncthreads();
    }

    // the bilinear outputs: one (pixel, window row b) per step; a cell
    // off the plane reads 0 (the box held every in-plane one)
    for (int k = t; k < kTile * kRD; k += kThreads) {
      const int m = k / kRD, b_ = k % kRD;
      const int2 o = s.org[m];
      const float fx = s.frac[m][0], fy = s.frac[m][1];
      const bool r0 = (unsigned)(o.y + b_) < (unsigned)h;
      const bool r1 = (unsigned)(o.y + b_ + 1) < (unsigned)h;
      const float* c0 = &s.cells[m][b_ * kSide];
      float v[kSide];
#pragma unroll
      for (int i = 0; i < kSide; ++i) {
        const bool col = (unsigned)(o.x + i) < (unsigned)w;
        v[i] = (1.0f - fy) * (r0 && col ? c0[i] : 0.0f)
               + fy * (r1 && col ? c0[kSide + i] : 0.0f);
      }
      OutT* dst = &s.out[(m * kPair + l % kPair) * kRD * kRD + b_];
#pragma unroll
      for (int a_ = 0; a_ < kRD; ++a_)               // a: x offset
        put(dst + a_ * kRD, (1.0f - fx) * v[a_] + fx * v[a_ + 1]);
    }
    __syncthreads();
    if (l % kPair == kPair - 1) {
      // each pixel's staged levels: 49 four-byte words of out
      const uint32_t* src = reinterpret_cast<const uint32_t*>(s.out);
      for (int k = t; k < kTile * 49; k += kThreads) {
        const int m = k / 49, gx = tx0 + m % tw, gy = ty0 + m / tw;
        if (gx < gw && gy < gh)
          reinterpret_cast<uint32_t*>(
              out + ((size_t)e * npix + (size_t)gy * gw + gx) * kOut
              + (l - kPair + 1) * kRD * kRD)[k % 49] = src[k];
      }
    }
  }
}

template <int L, typename OutT>
int launch(const void* f1, const Levels<L>& lv, const void* iis,
           const void* jjs, const void* coords, void* out, int E, int npix,
           int gw, int tw, void* stream) {
  const int smem = (int)sizeof(Smem<L, OutT>);
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        lookup_feats_kernel<L, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int th = kTile / tw, gh = npix / gw;
  dim3 grid(((gw + tw - 1) / tw) * ((gh + th - 1) / th), E);
  lookup_feats_kernel<L, OutT><<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f1), lv,
      static_cast<const int*>(iis), static_cast<const int*>(jjs),
      static_cast<const float*>(coords), static_cast<OutT*>(out), npix, gw,
      tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int glorie_lookup_pyramid(
    const void* f1, const void* f2_0, const void* f2_1, const void* f2_2,
    const void* f2_3, int h0, int w0, int h1, int w1, int h2, int w2,
    int h3, int w3, const void* iis, const void* jjs, const void* coords,
    void* out, int E, int npix, void* stream) {
  if (E <= 0 || npix <= 0) return 0;
  Levels<4> lv;
  lv.f2[0] = static_cast<const __nv_bfloat16*>(f2_0);
  lv.f2[1] = static_cast<const __nv_bfloat16*>(f2_1);
  lv.f2[2] = static_cast<const __nv_bfloat16*>(f2_2);
  lv.f2[3] = static_cast<const __nv_bfloat16*>(f2_3);
  lv.h[0] = h0; lv.w[0] = w0; lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2; lv.h[3] = h3; lv.w[3] = w3;
  // 8x8 pixel tiles of the h0 x w0 grid (h0 * w0 == npix)
  return launch<4, __nv_bfloat16>(f1, lv, iis, jjs, coords, out, E, npix,
                                  w0, kSide, stream);
}

// The box rule's constants, which ops/cuda_corr.py restates for its host
// copy of the rule (TILE, RUN, MARGIN in tile_box_spans / tile_box_stats)
// and checks against these when it loads the library: the 8x8 tile's
// rows and columns, the cells per run, the coordinate clamp margin.
extern "C" void glorie_lookup_geometry(int* v) {
  v[0] = kTile / kSide;
  v[1] = kSide;
  v[2] = kRun;
  v[3] = (int)kMargin;
}

// Kernel C: f2 is the level's (N, hl*wl, 128) store, coords (E, npix, 2)
// are in level units, out is (E, npix, 49) float32.
extern "C" int glorie_lookup_level(
    const void* f1, const void* f2, int hl, int wl, const void* iis,
    const void* jjs, const void* coords, void* out, int E, int npix,
    void* stream) {
  if (E <= 0 || npix <= 0) return 0;
  Levels<1> lv;
  lv.f2[0] = static_cast<const __nv_bfloat16*>(f2);
  lv.h[0] = hl;
  lv.w[0] = wl;
  // the pixel grid is (hl << k) x (wl << k) where that covers npix (level
  // k of a pyramid with even sizes); otherwise raster runs of 64 pixels
  int gw = npix, tw = kTile;
  for (int k = 0; hl > 0 && wl > 0 && k < 16; ++k) {
    const long long gy = (long long)hl << k, gx = (long long)wl << k;
    if (gy * gx == npix) {
      gw = (int)gx;
      tw = kSide;
      break;
    }
    if (gy * gx > npix) break;
  }
  return launch<1, float>(f1, lv, iis, jjs, coords, out, E, npix, gw, tw,
                          stream);
}
