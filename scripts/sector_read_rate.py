#!/usr/bin/env python3
"""How fast the card reads scattered 32-byte sectors: the rate that bounds
kernels D and E (``csrc/lookup_plane.cu``).

    python3 scripts/sector_read_rate.py

Builds a small reader with ``nvcc`` into ``glorie_slam_tpu_torch/_build/``
and times it with CUDA events over a 1.97 GB bf16 buffer (the size of
chip_smoke's kernels-phase volume, (96, 40, 80, 3200)):

* contiguous: 191 MB read in order;
* random 32-byte sectors and random 64-byte segments, 191 MB each, their
  positions hashed from the thread index;
* the sectors that kernel D reads on chip_smoke's kernels-phase inputs
  (``cuda_corr.plane_sector_stats``'s set: each 16-pixel group's touched
  cells), in three orders: the kernel's (edge, group, cell); cell-major
  within runs of 8 groups (edge, 128-pixel run, cell, group), so that
  a cell's sectors for neighbouring groups share a request; and sorted by
  address. These read a 4-byte sector index per 32-byte sector besides,
  which the rates leave out.

Each lane loads 16 bytes with 8 loads in flight; two lanes read a
sector. Prints one line per case (ms, TB/s of sector bytes) and the
card's name and power limit. Needs one card.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU;
  return x ^ (x >> 16);
}

// mode 0: piece i; mode 1: random segments of `seg` 16-byte pieces;
// mode 2: sector idx[i / 2], piece i % 2
__global__ void reader(const uint4* __restrict__ buf, long long n_pieces,
                       const int* __restrict__ idx, long long n,
                       int mode, int seg, uint4* out) {
  uint4 acc = make_uint4(0, 0, 0, 0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  // 8 loads in flight per thread
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i0 < n; i0 += 8 * stride) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long i = i0 + u * stride;
      long long p;
      if (mode == 0) {
        p = i;
      } else if (mode == 1) {
        const long long s = mix((uint32_t)(i / seg)) % (n_pieces / seg);
        p = s * seg + i % seg;
      } else {
        p = i < n ? (long long)idx[i >> 1] * 2 + (i & 1) : 0;
      }
      v[u] = i < n ? __ldcs(buf + p) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc.x ^= v[u].x; acc.y ^= v[u].y; acc.z ^= v[u].z; acc.w ^= v[u].w;
    }
  }
  out[(long long)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int read_rate(const void* buf, long long n_pieces,
                         const void* idx, long long n, int mode, int seg,
                         void* out, int blocks, void* stream) {
  reader<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)buf, n_pieces, (const int*)idx, n, mode, seg,
      (uint4*)out);
  return (int)cudaGetLastError();
}
"""


def build_reader():
    from glorie_slam_tpu_torch import build
    out_dir = os.path.join(build.BUILD_ROOT, "sector_read_rate")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "reader.cu")
    so = os.path.join(out_dir, "libreader.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", src,
                    "-o", so], check=True)
    lib = ctypes.CDLL(so)
    lib.read_rate.restype = ctypes.c_int
    lib.read_rate.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_void_p]
    return lib


def kernel_sectors(coords, hl, wl, group=16):
    """Sector indices (units of 32 bytes) of the (edge, group, cell)
    triples that kernel D reads over an (E, hl, wl, npix) bf16 volume, in
    the kernel's order."""
    import torch
    E, npix, _ = coords.shape
    c = torch.nan_to_num(coords)
    r = torch.arange(8, device=coords.device)
    gx = torch.floor(c[..., 0].clamp(-16, wl + 16)).long()[..., None] - 3 + r
    gy = torch.floor(c[..., 1].clamp(-16, hl + 16)).long()[..., None] - 3 + r
    ok = (((gy >= 0) & (gy < hl))[..., :, None]
          & ((gx >= 0) & (gx < wl))[..., None, :]).flatten(2)
    cell = (gy[..., :, None] * wl + gx[..., None, :]).flatten(2)
    cells, n_groups = hl * wl, npix // group
    gid = (torch.arange(npix, device=coords.device) // group).view(1, -1, 1)
    key = torch.where(ok, gid * (cells + 1) + cell, gid * (cells + 1) + cells)
    seen = torch.zeros((E, n_groups * (cells + 1)), dtype=torch.bool,
                       device=coords.device)
    seen.scatter_(1, key.flatten(1), True)
    seen = seen.view(E, n_groups, cells + 1)[..., :cells]
    e_i, g_i, c_i = seen.nonzero(as_tuple=True)
    elem = (e_i * cells + c_i) * npix + g_i * group       # bf16 element
    return (elem // group).to(torch.int32)


def main():
    import torch
    if not torch.cuda.is_available():
        print("sector_read_rate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    lib = build_reader()
    dev = torch.device("cuda")
    E, hl, wl, npix = 96, 40, 80, 3200
    buf = torch.empty(E * hl * wl * npix, dtype=torch.bfloat16,
                      device=dev).normal_()
    n_pieces = buf.numel() * 2 // 16
    blocks = 132 * 16
    out = torch.empty(blocks * 256 * 16, dtype=torch.uint8, device=dev)
    nbytes = 191_356_128
    empty = torch.zeros(1, dtype=torch.int32, device=dev)

    def rate(label, mode, n, seg=1, idx=empty, sector_bytes=nbytes):
        def run():
            err = lib.read_rate(buf.data_ptr(), n_pieces, idx.data_ptr(), n,
                                mode, seg, out.data_ptr(), blocks,
                                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"reader: CUDA error {err}")
        ms = chip_smoke.cuda_ms(run, 20)
        print(f"{label}: {ms:.4f} ms, {sector_bytes / ms / 1e9:.3f} TB/s",
              flush=True)

    rate("contiguous 191 MB", 0, nbytes // 16)
    rate("random 32-byte sectors", 1, nbytes // 16, seg=2)
    rate("random 64-byte segments", 1, nbytes // 16, seg=4)
    _, _, _, coords = chip_smoke.edge_inputs(dev)
    sec = kernel_sectors(coords, hl, wl)
    n = 2 * sec.numel()
    rate("kernel D's sectors, kernel order", 2, n, idx=sec,
         sector_bytes=32 * sec.numel())
    per_edge = npix // 16                   # groups per edge
    e, rest = sec.long() // (hl * wl * per_edge), sec.long() % (
        hl * wl * per_edge)
    cell, grp = rest // per_edge, rest % per_edge
    run_major = ((e * (per_edge // 8) + grp // 8) * (hl * wl) + cell) * 8 \
        + grp % 8
    rate("kernel D's sectors, cell-major in runs of 8 groups", 2, n,
         idx=sec[run_major.argsort()], sector_bytes=32 * sec.numel())
    rate("kernel D's sectors, sorted by address", 2, n,
         idx=sec.sort().values, sector_bytes=32 * sec.numel())
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
