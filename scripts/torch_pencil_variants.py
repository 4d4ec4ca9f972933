#!/usr/bin/env python3
"""Variants of K2/K3's float4 form (apply_w_pencil_kernel in
admm_optim_tpu_torch/csrc/stencil.cu) timed against each other on one
GPU: the block's columns T, the stage's buffers NB, the shared-memory
carveout, and two diagnostics that change the result (so they are timed,
not checked): every slot reads x at the site itself (no neighbour reads
from L2), and no W is staged at all (x and the sums alone).

    python3 scripts/torch_pencil_variants.py

Builds stencil.cu with the variant kernel below appended into
admm_optim_tpu_torch/_build/ (nvcc, sm_90a), then prints per lattice
(9^3 and 17^3 x 224) and lane count (1, 5) each variant's median device
time with the L2 emptied by zeroing (ms), by reading (clean) and left warm,
as chip_smoke.py times the kernels, beside the shipped kernel's."""
import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from admm_optim_tpu_torch import _build  # noqa: E402
from admm_optim_tpu_torch.ops import patchstencil as st  # noqa: E402
from admm_optim_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

# The float4 form of apply_w_pencil_kernel with T columns a block, NB stage
# buffers in dynamic shared memory and DIAG: 0 none, 1 x read at the site
# itself for every slot, 2 no W staged (the sums of whatever the buffers
# hold).  Variant ids: 0-5 the (T, NB) of VARIANTS, 6 and 7 DIAG 1 and 2.
VARIANT_CU = r"""
namespace {
template <int B, int T, int NB, int DIAG>
__global__ void __launch_bounds__(T)
variant_pencil_kernel(const __nv_bfloat16* __restrict__ W, const float4* __restrict__ x,
                      float4* __restrict__ y, const SlotTable tab, int n0, int n1, int n2, int P) {
  extern __shared__ float4 stage_bytes[];
  uint2* wst = reinterpret_cast<uint2*>(stage_bytes);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(wst + NB * kPcRuns * T);
  const int row = n2 * P;
  const int r0 = blockIdx.x * T;
  const int r = r0 + threadIdx.x;
  const int rc = min(r, row - 1);
  const int j = blockIdx.y, i = blockIdx.z;
  const int t = (i * n1 + j) * row + rc;
  const size_t sp = static_cast<size_t>(n0) * n1 * row;
  const uint2* wp = reinterpret_cast<const uint2*>(W) + static_cast<size_t>(i * n1 + j) * kSlots * kBlock * row;
  const int live = min(T, row - r0);
  if (threadIdx.x == 0) {
    for (int b = 0; b < NB; ++b) mbarrier_init(&bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto stage_group = [&](int g) {
    uint2* buf = wst + (g % NB) * kPcRuns * T;
    if (DIAG != 2 && threadIdx.x < kPcRuns) {
      const unsigned bytes = live * sizeof(uint2);
      if (threadIdx.x == 0) mbarrier_expect(&bar[g % NB], kPcRuns * bytes);
      bulk_copy(buf + threadIdx.x * T, wp + static_cast<size_t>(g * kPcRuns + threadIdx.x) * row + r0,
                bytes, &bar[g % NB]);
    }
  };
  float4 acc[B][3];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[b][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int g = 0; g < NB - 1 && g < kPcGroups; ++g) stage_group(g);
#pragma unroll
  for (int g = 0; g < kPcGroups; ++g) {
    if (g + NB - 1 < kPcGroups) stage_group(g + NB - 1);
    if (DIAG != 2) mbarrier_wait(&bar[g % NB], (g / NB) & 1);
#pragma unroll
    for (int k = 0; k < kPcGroup; ++k) {
      const int q = g * kPcGroup + k;
      const Neighbour nb = neighbour_of(tab.row[q][0], tab.row[q][1], tab.row[q][2], i, j, rc, t,
                                        n0, n1, row, P);
      pencil_slot<B>(acc, wst + ((g % NB) * kPcRuns + k * kBlock) * T + threadIdx.x, T, nb.ok,
                     x + (DIAG == 1 ? t : nb.at), 3 * sp, sp);
    }
    if (g + NB < kPcGroups) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    }
  }
  if (r < row)
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) y[b * 3 * sp + c * sp + t] = acc[b][c];
}

template <int B, int T, int NB, int DIAG = 0>
int variant_launch(const void* W, const void* x, void* y, const int* slots, int n0, int n1, int n2, int Pv,
                   cudaStream_t s, int carveout) {
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, T);
  constexpr int bytes = NB * kPcRuns * T * 8 + NB * 8;
  const cudaError_t a = cudaFuncSetAttribute(variant_pencil_kernel<B, T, NB, DIAG>,
                                             cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  static const cudaError_t a2 = cudaFuncSetAttribute(variant_pencil_kernel<B, T, NB, DIAG>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)a; (void)a2;
  variant_pencil_kernel<B, T, NB, DIAG><<<g.grid, T, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(W), static_cast<const float4*>(x), static_cast<float4*>(y), g.tab,
      n0, n1, n2, Pv);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int variant_pencil(const void* W, const void* x, void* y, const int* slots, int n0, int n1, int n2,
                              int P, int lanes, int variant, int carveout, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Pv = P / 4;
#define V(B, T, NB, id) \
  if (lanes == B && variant == id) return variant_launch<B, T, NB>(W, x, y, slots, n0, n1, n2, Pv, s, carveout);
  V(1, 64, 2, 0) V(1, 64, 3, 1) V(1, 128, 2, 2) V(1, 256, 2, 3) V(1, 64, 5, 4) V(1, 128, 3, 5)
  V(5, 64, 2, 0) V(5, 64, 3, 1) V(5, 128, 2, 2) V(5, 256, 2, 3) V(5, 64, 5, 4) V(5, 128, 3, 5)
  if (lanes == 1 && variant == 6) return variant_launch<1, 64, 2, 1>(W, x, y, slots, n0, n1, n2, Pv, s, carveout);
  if (lanes == 1 && variant == 7) return variant_launch<1, 64, 2, 2>(W, x, y, slots, n0, n1, n2, Pv, s, carveout);
  if (lanes == 5 && variant == 6) return variant_launch<5, 64, 2, 1>(W, x, y, slots, n0, n1, n2, Pv, s, carveout);
  if (lanes == 5 && variant == 7) return variant_launch<5, 64, 2, 2>(W, x, y, slots, n0, n1, n2, Pv, s, carveout);
  return -1;
}
"""
# (id, label, carveout percent or -1 for the driver's choice)
VARIANTS = (
    (0, "T64 NB2 (shipped)", -1), (0, "T64 NB2 carveout 100", 100), (0, "T64 NB2 carveout 60", 60),
    (0, "T64 NB2 carveout 40", 40), (1, "T64 NB3", -1), (2, "T128 NB2", -1), (3, "T256 NB2", -1),
    (4, "T64 NB5", -1), (5, "T128 NB3", -1), (6, "x at the site (diagnostic)", -1),
    (7, "no W (diagnostic)", -1),
)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_pencil_variants: needs a GPU")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    src = _build.BUILD_DIR / "pencil_variants.cu"
    lib_path = _build.BUILD_DIR / "libpencil_variants.so"
    src.write_text(_build.SOURCE.read_text() + VARIANT_CU)
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(out.stdout + out.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.variant_pencil.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.variant_pencil.restype = ctypes.c_int
    ps = cs.stencil_patchset()
    tab = sk.stencil_tables(ps).packed("full")
    print(cs.nvidia_smi())
    for lat, P in (cs.NS_SHAPE, cs.FINE_SHAPE):
        g = torch.Generator(device="cuda").manual_seed(1)
        W = torch.randn((len(st.half_slots(ps)), 3, 3) + lat + (P,), generator=g, device="cuda")
        W_pc = sk.to_pencil_major(ps, W, torch.bfloat16)
        for B in (1, 5):
            x = torch.randn((B, 3) + lat + (P,), generator=g, device="cuda")
            ref = sk.apply_w_pencil_batched(ps, W_pc, x)
            shipped = cs.median_ms(lambda: sk.apply_w_pencil_batched(ps, W_pc, x))
            print(f"{lat[0]}^3 x {P} B={B} apply_w_pencil_batched as shipped: ms {shipped:.4f}", flush=True)
            for v, label, carveout in VARIANTS:
                y = torch.empty_like(x)

                def fn():
                    err = lib.variant_pencil(W_pc.data_ptr(), x.data_ptr(), y.data_ptr(), tab, *lat, P, B, v,
                                             carveout, 0, torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"{label}: launch failed ({err})")

                fn()
                torch.cuda.synchronize()
                same = "equal" if torch.equal(y, ref) else "differs"
                print(f"{lat[0]}^3 x {P} B={B} {label:28s} {same:7s} ms {cs.median_ms(fn):.4f} "
                      f"clean {cs.clean_ms(fn):.4f} warm {cs.warm_ms(fn):.4f}", flush=True)


if __name__ == "__main__":
    main()
