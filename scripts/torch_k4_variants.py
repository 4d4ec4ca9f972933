#!/usr/bin/env python3
"""K4 (apply_w_df_kernel in admm_optim_tpu_torch/csrc/stencil.cu) timed on
one GPU at each band width of its launch order, beside variants:

  - its row loop, as shipped (float4, 64 threads a block), in the natural
    order (band = n1: j within i, the order of every other kernel) and in
    bands of 2, 4, 8 and 16 j-rows (the port launches kDfBand = 8);
  - "x by L1": W alone staged by cp.async, xh and xl loaded by each thread
    into registers through L1 (the stage drops from 15 to 9 values a slot,
    90 to 54 KB a block, so four blocks fit an SM instead of two);
  - the shipped row loop at other widths: V = float2 or float (2 or 1
    sites a thread) and 32, 64 or 128 threads a block, whose smaller
    stages let more warps share an SM, in bands of kDfBand;
  - two diagnostics that change the result (so they are timed, not
    checked), the shipped stage and order with other sums: f32 sums of W
    xh (no conversion to f64 at all), and f64 sums of W xh (the 135
    conversions of W, none of xl);
  - K1 (apply_w_c3_kernel's row loop on one f32 field) in the natural
    order, as shipped, and in K4's bands, a measurement for K1's launch.

    python3 scripts/torch_k4_variants.py [--k1-against OTHER/stencil.cu]

With --k1-against, K1 (apply_w_c3_f32) of a library built from another
stencil.cu (another commit's) runs beside the shipped one at each lattice:
its result bit for bit against the shipped K1's, and both times, in turns
(other, shipped, shipped, other).

Builds stencil.cu with the variant kernels below appended into
admm_optim_tpu_torch/_build/ (nvcc, sm_90a), then prints per lattice
(33^3 x 224, the refs=5 fine level; 17^3 x 224; 17^3 x 112, one rank's
block; 9^3 x 224) each form's median device time with the L2 emptied by
zeroing a 512 MB buffer (ms, as chip_smoke.py times the kernels) and
whether its result equals the shipped kernel's bit for bit (the order of
the blocks and the place of x change no sum)."""
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

VARIANT_CU = r"""
namespace {
// K4 with W alone staged; xh and xl of a group loaded into registers
// through L1 before the wait for the group's W
__global__ void __launch_bounds__(kC3Threads)
variant_df_l1_kernel(const float4* __restrict__ W, const float4* __restrict__ xh,
                     const float4* __restrict__ xl, float4* __restrict__ yh, float4* __restrict__ yl,
                     const SlotTable tab, int n0, int n1, int n2, int P, int band) {
  constexpr int C = 3, T = kC3Threads, S = 9, L = 4;
  int i, j;
  banded_row(band, n0, n1, i, j);
  extern __shared__ float4 stage_bytes[];
  float4* stage = stage_bytes + threadIdx.x;
  const int row = n2 * P;
  const int r = blockIdx.x * T + threadIdx.x;
  if (r >= row) return;
  const int t = (i * n1 + j) * row + r;
  const size_t sp = static_cast<size_t>(n0) * n1 * row;
  unsigned inside = 0;
  int at[kSlots];
  auto stage_group = [&](int g) {
    float4* buf = stage + (g % 2) * kC3Group * S * T;
#pragma unroll
    for (int k = 0; k < kC3Group; ++k) {
      const int q = g * kC3Group + k;
      const Neighbour nb = neighbour_of(tab.row[q][0], tab.row[q][1], tab.row[q][2], i, j, r,
                                        t, n0, n1, row, P);
      const int code = tab.row[q][3];
      const bool direct = code >= 0;
      const float4* w = W + static_cast<size_t>(direct ? code : -1 - code) * C * C * sp +
                        (direct ? t : nb.at);
      const size_t sc = direct ? C * sp : sp;
      const size_t sd = direct ? sp : C * sp;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d)
          __pipeline_memcpy_async(buf + (k * S + c * C + d) * T, w + c * sc + d * sd, sizeof(float4));
      inside |= static_cast<unsigned>(nb.ok) << q;
      at[q] = nb.at;
    }
    __pipeline_commit();
  };
  double acc[C][L];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int l = 0; l < L; ++l) acc[c][l] = 0.0;
  stage_group(0);
#pragma unroll
  for (int g = 0; g < kC3Groups; ++g) {
    float4 xv[kC3Group][2 * C];
#pragma unroll
    for (int k = 0; k < kC3Group; ++k)
#pragma unroll
      for (int d = 0; d < C; ++d) {
        xv[k][d] = __ldg(xh + d * sp + at[g * kC3Group + k]);
        xv[k][C + d] = __ldg(xl + d * sp + at[g * kC3Group + k]);
      }
    if (g + 1 < kC3Groups) {
      stage_group(g + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    const float4* buf = stage + (g % 2) * kC3Group * S * T;
#pragma unroll
    for (int k = 0; k < kC3Group; ++k) {
      const bool ok = (inside >> (g * kC3Group + k)) & 1u;
      double x[C][L];
#pragma unroll
      for (int d = 0; d < C; ++d)
#pragma unroll
        for (int l = 0; l < L; ++l)
          x[d][l] = static_cast<double>(lane(xv[k][d], l)) + static_cast<double>(lane(xv[k][C + d], l));
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d) {
          const float4 w = keep_if(ok, buf[(k * S + c * C + d) * T]);
#pragma unroll
          for (int l = 0; l < L; ++l) acc[c][l] = fma(static_cast<double>(lane(w, l)), x[d][l], acc[c][l]);
        }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float4 hi, lo;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      lane(hi, l) = static_cast<float>(acc[c][l]);
      lane(lo, l) = static_cast<float>(acc[c][l] - static_cast<double>(lane(hi, l)));
    }
    yh[c * sp + t] = hi;
    yl[c * sp + t] = lo;
  }
}

// diagnostics: K4's stage with f32 sums of W xh (DIAG 1) or f64 sums of
// W xh (DIAG 2); yl is written 0
template <int DIAG>
struct DiagSums {
  static constexpr int T = kC3Threads;
  float4 f[3];
  double d[3][4];
  __device__ __forceinline__ DiagSums() {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int l = 0; l < 4; ++l) d[c][l] = 0.0;
    }
  }
  template <int TT>
  __device__ __forceinline__ void add(bool ok, const float4* slot) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float4 w = keep_if(ok, slot[(c * 3 + e) * TT]), x = slot[(9 + e) * TT];
        if (DIAG == 1) {
          fma_into(f[c], w, x);
        } else {
#pragma unroll
          for (int l = 0; l < 4; ++l)
            d[c][l] = fma(static_cast<double>(lane(w, l)), static_cast<double>(lane(x, l)), d[c][l]);
        }
      }
  }
  __device__ __forceinline__ void store(float4* yh, float4* yl, size_t sp, int t) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float4 v = f[c];
      if (DIAG == 2)
#pragma unroll
        for (int l = 0; l < 4; ++l) lane(v, l) = static_cast<float>(d[c][l]);
      yh[c * sp + t] = v;
      yl[c * sp + t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

template <int DIAG>
__global__ void __launch_bounds__(kC3Threads)
variant_df_diag_kernel(const float4* __restrict__ W, const float4* __restrict__ xh,
                       const float4* __restrict__ xl, float4* __restrict__ yh, float4* __restrict__ yl,
                       const SlotTable tab, int n0, int n1, int n2, int P, int band) {
  int i, j;
  banded_row(band, n0, n1, i, j);
  c3_row<float4, 2, kC3Threads, DiagSums<DIAG>>(W, xh, xl, yh, yl, tab, i, j, n0, n1, n2, P);
}

template <int DIAG>
int variant_diag_launch(const void* W, const void* xh, const void* xl, void* yh, void* yl, const int* slots,
                        int n0, int n1, int n2, int P, int band, cudaStream_t s) {
  const int Pv = P / 4;
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, kC3Threads);
  constexpr size_t bytes = c3_stage_bytes<float4, 2>();
  static const cudaError_t allowed = allow_stage(variant_df_diag_kernel<DIAG>, bytes);
  if (allowed != cudaSuccess) return allowed;
  variant_df_diag_kernel<DIAG><<<g.grid, kC3Threads, bytes, s>>>(
      static_cast<const float4*>(W), static_cast<const float4*>(xh), static_cast<const float4*>(xl),
      static_cast<float4*>(yh), static_cast<float4*>(yl), g.tab, n0, n1, n2, Pv, band < n1 ? band : n1);
  return static_cast<int>(cudaGetLastError());
}

// K4's row loop at other widths V and block sizes T
template <typename V, int T>
__global__ void __launch_bounds__(T)
variant_df_kernel(const V* __restrict__ W, const V* __restrict__ xh, const V* __restrict__ xl,
                  V* __restrict__ yh, V* __restrict__ yl, const SlotTable tab, int n0, int n1, int n2,
                  int P, int band) {
  int i, j;
  banded_row(band, n0, n1, i, j);
  c3_row<V, 2, T>(W, xh, xl, yh, yl, tab, i, j, n0, n1, n2, P);
}

template <typename V, int T>
int variant_df_launch(const void* W, const void* xh, const void* xl, void* yh, void* yl, const int* slots,
                      int n0, int n1, int n2, int P, int band, cudaStream_t s) {
  const int Pv = P / static_cast<int>(sizeof(V) / sizeof(float));
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, T);
  constexpr size_t bytes = c3_stage_bytes<V, 2, T>();
  static const cudaError_t allowed = allow_stage(variant_df_kernel<V, T>, bytes);
  if (allowed != cudaSuccess) return allowed;
  variant_df_kernel<V, T><<<g.grid, T, bytes, s>>>(
      static_cast<const V*>(W), static_cast<const V*>(xh), static_cast<const V*>(xl), static_cast<V*>(yh),
      static_cast<V*>(yl), g.tab, n0, n1, n2, Pv, band < n1 ? band : n1);
  return static_cast<int>(cudaGetLastError());
}

// K1's row loop in K4's bands
__global__ void __launch_bounds__(kC3Threads)
variant_c3_banded_kernel(const float4* __restrict__ W, const float4* __restrict__ x,
                         float4* __restrict__ y, const SlotTable tab, int n0, int n1, int n2, int P,
                         int band) {
  int i, j;
  banded_row(band, n0, n1, i, j);
  c3_row<float4, 1>(W, x, nullptr, y, nullptr, tab, i, j, n0, n1, n2, P);
}
}  // namespace

extern "C" int variant_df_l1(const void* W, const void* xh, const void* xl, void* yh, void* yl,
                             const int* slots, int n0, int n1, int n2, int P, int band, int device,
                             void* stream) {
  cudaSetDevice(device);
  const int Pv = P / 4;
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, kC3Threads);
  constexpr int bytes = 2 * kC3Group * 9 * kC3Threads * 16;
  static const cudaError_t allowed = allow_stage(variant_df_l1_kernel, bytes);
  if (allowed != cudaSuccess) return allowed;
  variant_df_l1_kernel<<<g.grid, kC3Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(W), static_cast<const float4*>(xh), static_cast<const float4*>(xl),
      static_cast<float4*>(yh), static_cast<float4*>(yl), g.tab, n0, n1, n2, Pv, band < n1 ? band : n1);
  return static_cast<int>(cudaGetLastError());
}

// form: 0 float4 x 64 (as shipped), 1 float4 x 32, 2 float2 x 32, 3 float2 x 64, 4 float2 x 128,
// 5 float x 64, 6 float x 128; 7 and 8 the diagnostics DIAG 1 and 2
extern "C" int variant_df(const void* W, const void* xh, const void* xl, void* yh, void* yl, const int* slots,
                          int n0, int n1, int n2, int P, int band, int form, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return variant_df_launch<float4, 64>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
    case 1: return variant_df_launch<float4, 32>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
    case 2: return variant_df_launch<float2, 32>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
    case 3: return variant_df_launch<float2, 64>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
    case 4: return variant_df_launch<float2, 128>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
    case 5: return variant_df_launch<float, 64>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
    case 6: return variant_df_launch<float, 128>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
    case 7: return variant_diag_launch<1>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
    case 8: return variant_diag_launch<2>(W, xh, xl, yh, yl, slots, n0, n1, n2, P, band, s);
  }
  return -1;
}

extern "C" int variant_c3_banded(const void* W, const void* x, void* y, const int* slots, int n0, int n1,
                                 int n2, int P, int band, int device, void* stream) {
  cudaSetDevice(device);
  const int Pv = P / 4;
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, kC3Threads);
  constexpr int bytes = c3_stage_bytes<float4, 1>();
  static const cudaError_t allowed = allow_stage(variant_c3_banded_kernel, bytes);
  if (allowed != cudaSuccess) return allowed;
  variant_c3_banded_kernel<<<g.grid, kC3Threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(W), static_cast<const float4*>(x), static_cast<float4*>(y), g.tab, n0, n1, n2,
      Pv, band < n1 ? band : n1);
  return static_cast<int>(cudaGetLastError());
}
"""
BANDS = (0, 2, 4, 8, 16)  # 0: the natural order (band = n1)
SHIPPED_BAND = 8  # kDfBand in csrc/stencil.cu
FORMS = ("float4 x 64", "float4 x 32", "float2 x 32", "float2 x 64", "float2 x 128", "float x 64", "float x 128",
         "f32 sums of W xh (diagnostic)", "f64 sums of W xh (diagnostic)")
SHAPES = (((33, 33, 33), 224), cs.FINE_SHAPE, cs.SHARD_FINE_SHAPE, cs.NS_SHAPE)


def compile_library(source, name):
    """source (text) built with the port's nvcc flags into _build/name;
    returns (the loaded library, nvcc's output)."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    src = _build.BUILD_DIR / f"{name}.cu"
    lib_path = _build.BUILD_DIR / f"lib{name}.so"
    src.write_text(source)
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(out.stdout + out.stderr)
    return ctypes.CDLL(str(lib_path)), out.stdout + out.stderr


def build():
    lib, log = compile_library(_build.SOURCE.read_text() + VARIANT_CU, "k4_variants")
    for line in log.splitlines():
        if "variant_" in line or ("registers" in line and "Used" in line):
            print("[ptxas]", line.strip())
    lib.variant_df_l1.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.variant_c3_banded.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.variant_df.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.variant_df_l1.restype = lib.variant_c3_banded.restype = lib.variant_df.restype = ctypes.c_int
    return lib


def checked(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: launch failed ({_build.error_string(err)})")


def k1_against(other, ps, W, xh, lat, P, label):
    """K1 of the library other beside the shipped K1 on (W, xh): bit for
    bit, and both median times in turns."""
    tab = sk.stencil_tables(ps).packed("sym")
    y = torch.empty_like(xh)

    def fn():
        checked(other.apply_w_c3_f32(W.data_ptr(), xh.data_ptr(), y.data_ptr(), tab, *lat, P, 0,
                                     torch.cuda.current_stream().cuda_stream), "K1 of the other library")

    fn()
    torch.cuda.synchronize()
    same = torch.equal(y, sk.apply_w_sym(ps, W, xh))
    shipped = lambda: sk.apply_w_sym(ps, W, xh)  # noqa: E731
    times = [cs.median_ms(f) for f in (fn, shipped, shipped, fn)]
    print(f"{label} K1 of the other library: {'equal' if same else 'DIFFERS'} bit for bit; ms other "
          f"{times[0]:.4f}, {times[3]:.4f}, shipped {times[1]:.4f}, {times[2]:.4f}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_variants: needs a GPU")
    other = None
    if sys.argv[1:2] == ["--k1-against"]:
        other = compile_library(pathlib.Path(sys.argv[2]).read_text(), "k1_other")[0]
        other.apply_w_c3_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        other.apply_w_c3_f32.restype = ctypes.c_int
    lib = build()
    ps = cs.stencil_patchset()
    tab = sk.stencil_tables(ps).packed("sym")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    print(cs.nvidia_smi(), flush=True)
    for lat, P in SHAPES:
        label = f"{lat[0]}^3 x {P}"
        g = torch.Generator(device="cuda").manual_seed(1)
        W = torch.randn((len(st.half_slots(ps)), 3, 3) + lat + (P,), generator=g, device="cuda")
        x64 = torch.randn((3,) + lat + (P,), generator=g, device="cuda", dtype=torch.float64)
        xh = x64.float()
        xl = (x64 - xh.double()).float()
        del x64
        moved = cs.nbytes(W, xh, xl, xh, xl)
        bound_ms = moved / (cs.H100_SXM_GBPS * 1e9) * 1e3
        ref = sk.apply_w_df_sym(ps, W, xh, xl)
        ms = cs.median_ms(lambda: sk.apply_w_df_sym(ps, W, xh, xl))
        print(f"{label} K4 bound {bound_ms:.4f} ms ({moved / 1e9:.3f} GB); K4 as shipped ms {ms:.4f} "
              f"({100 * bound_ms / ms:.1f}% of bound)", flush=True)
        yh, yl = torch.empty_like(xh), torch.empty_like(xh)

        def timed(what, launch):
            launch()
            torch.cuda.synchronize()
            same = torch.equal(yh, ref[0]) and torch.equal(yl, ref[1])
            ms = cs.median_ms(launch)
            print(f"{label} K4 {what}: {'equal' if same else 'differs'} ms {ms:.4f} "
                  f"({100 * bound_ms / ms:.1f}% of bound)", flush=True)

        def form(f, band):
            return lambda: checked(lib.variant_df(W.data_ptr(), xh.data_ptr(), xl.data_ptr(), yh.data_ptr(),
                                                  yl.data_ptr(), tab, *lat, P, band, f, 0, stream()), FORMS[f])

        def by_l1(band):
            return lambda: checked(lib.variant_df_l1(W.data_ptr(), xh.data_ptr(), xl.data_ptr(), yh.data_ptr(),
                                                     yl.data_ptr(), tab, *lat, P, band, 0, stream()), "x by L1")

        for band in BANDS:
            name = f"band {band or 'natural':>7}"
            timed(f"row loop {FORMS[0]:12s}, {name}", form(0, band or lat[1]))
            timed(f"x by L1,              {name}", by_l1(band or lat[1]))
        for f in range(1, len(FORMS)):
            timed(f"row loop {FORMS[f]:12s}, band {SHIPPED_BAND}", form(f, SHIPPED_BAND))
        del ref, yh, yl, xl
        y1 = sk.apply_w_sym(ps, W, xh)
        k1_bound = cs.nbytes(W, xh, y1) / (cs.H100_SXM_GBPS * 1e9) * 1e3
        ms = cs.median_ms(lambda: sk.apply_w_sym(ps, W, xh))
        print(f"{label} K1 shipped (natural order): ms {ms:.4f} ({100 * k1_bound / ms:.1f}% of its bound "
              f"{k1_bound:.4f})", flush=True)
        if other is not None:
            k1_against(other, ps, W, xh, lat, P, label)
        y = torch.empty_like(xh)
        for band in BANDS[1:]:
            def k1():
                checked(lib.variant_c3_banded(W.data_ptr(), xh.data_ptr(), y.data_ptr(), tab, *lat, P, band, 0,
                                              stream()), "K1 banded")

            k1()
            torch.cuda.synchronize()
            ms = cs.median_ms(k1)
            print(f"{label} K1 in bands of {band:2d}: {'equal' if torch.equal(y, y1) else 'DIFFERS'} "
                  f"ms {ms:.4f} ({100 * k1_bound / ms:.1f}% of bound)", flush=True)
        del W, xh, y, y1
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
