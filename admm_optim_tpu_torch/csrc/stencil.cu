// Brick-patch stencil applies for Hopper (sm_90a): the CUDA counterparts
// of the Pallas TPU kernels in admm_optim_tpu/ops/pallas_stencil.py.
//
// Layouts (ops/stencil_kernels.py): fields x, y are (C, n0, n1, n2, P) f32
// with C = 3; W is symmetric half storage (H, C, C, n0, n1, n2, P) f32 or
// pencil-major (n0, n1, O, C, C, n2, P) bf16.  y is additive: per-patch
// partial sums, made consistent by the exchange that follows.
//
// Every kernel runs one thread per lattice site (i, j, k, p) with p the
// fastest thread index, so each W and x load of a warp is one contiguous
// run along the patch axis.  All three are bound by device-memory
// bandwidth: ~1 flop per byte of W, and W is 90% of the bytes.  A
// neighbour outside the lattice contributes nothing, which is what the
// JAX forms' zero halo of x gives; so no padded copy of x is made and no
// W is read beyond the lattice edge (the Pallas kernels read edge-clamped
// W blocks and rely on the zero halo instead).
//
// The slot table `stab` (n_slots x 4 int32, built by
// stencil_kernels._slot_table) gives per stencil slot its offset (o0, o1,
// o2) and a code: h >= 0 reads stored slot h at the site itself;
// -1 - h reads the transpose of stored slot h at the neighbour s + o
// (operator symmetry: A[s, s+o] = W[h](s+o)^T for o = -offset(h)).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 3;
constexpr int kThreads = 256;

struct Site {
  int i, j, k, p;
};

__device__ __forceinline__ Site site_of(long long t, int n1, int n2, int P) {
  Site s;
  s.p = static_cast<int>(t % P);
  long long r = t / P;
  s.k = static_cast<int>(r % n2);
  r /= n2;
  s.j = static_cast<int>(r % n1);
  s.i = static_cast<int>(r / n1);
  return s;
}

// Flat index of the neighbour site s + (o0, o1, o2), or -1 outside.
__device__ __forceinline__ long long neighbour(const Site& s, const int* e,
                                               int n0, int n1, int n2, int P) {
  const int ii = s.i + e[0], jj = s.j + e[1], kk = s.k + e[2];
  if (ii < 0 || ii >= n0 || jj < 0 || jj >= n1 || kk < 0 || kk >= n2) return -1;
  return ((static_cast<long long>(ii) * n1 + jj) * n2 + kk) * P + s.p;
}

// K1, replaces pallas_stencil.py _kernel_sym / _apply_w_pallas_3d_sym
// (:140-277).  Streams the 8 stored slots once at the site and reads the
// 7 missing ones as transposes at the neighbour (same 15 block reads per
// site as the Pallas kernel, from half the stored bytes).
__global__ void apply_w_sym_kernel(const float* __restrict__ W,
                                   const float* __restrict__ x,
                                   float* __restrict__ y,
                                   const int* __restrict__ stab, int n_slots,
                                   int n0, int n1, int n2, int P) {
  const long long sp = static_cast<long long>(n0) * n1 * n2 * P;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= sp) return;
  const Site s = site_of(t, n1, n2, P);
  float acc[C] = {0.f, 0.f, 0.f};
  for (int q = 0; q < n_slots; ++q) {
    const int* e = stab + 4 * q;
    const long long nb = neighbour(s, e, n0, n1, n2, P);
    if (nb < 0) continue;
    float xv[C];
#pragma unroll
    for (int d = 0; d < C; ++d) xv[d] = x[d * sp + nb];
    if (e[3] >= 0) {
      const float* w = W + static_cast<long long>(e[3]) * C * C * sp + t;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d) acc[c] += w[(c * C + d) * sp] * xv[d];
    } else {
      const float* w = W + static_cast<long long>(-1 - e[3]) * C * C * sp + nb;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d) acc[c] += w[(d * C + c) * sp] * xv[d];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) y[c * sp + t] = acc[c];
}

// K2, replaces pallas_stencil.py _kernel_pc / _apply_w_pallas_3d_pc
// (:280-304, :369-396).  Full 15-slot apply from pencil-major bf16 W:
// weights are upcast in registers, x and the sums stay f32, so the
// dominant W stream is half the bytes of f32.
__global__ void apply_w_pencil_bf16_kernel(const __nv_bfloat16* __restrict__ W,
                                           const float* __restrict__ x,
                                           float* __restrict__ y,
                                           const int* __restrict__ stab,
                                           int n_slots, int n0, int n1, int n2,
                                           int P) {
  const long long sp = static_cast<long long>(n0) * n1 * n2 * P;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= sp) return;
  const Site s = site_of(t, n1, n2, P);
  const long long cd_stride = static_cast<long long>(n2) * P;  // one (c, d) block
  const long long pencil =
      (static_cast<long long>(s.i) * n1 + s.j) * n_slots * C * C * cd_stride +
      static_cast<long long>(s.k) * P + s.p;
  float acc[C] = {0.f, 0.f, 0.f};
  for (int q = 0; q < n_slots; ++q) {
    const int* e = stab + 4 * q;
    const long long nb = neighbour(s, e, n0, n1, n2, P);
    if (nb < 0) continue;
    float xv[C];
#pragma unroll
    for (int d = 0; d < C; ++d) xv[d] = x[d * sp + nb];
    const __nv_bfloat16* w = W + pencil + static_cast<long long>(q) * C * C * cd_stride;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int d = 0; d < C; ++d)
        acc[c] += __bfloat162float(w[(c * C + d) * cd_stride]) * xv[d];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) y[c * sp + t] = acc[c];
}

// K4, replaces pallas_stencil.py _kernel_sym_df / _apply_w_df_pallas_3d_sym
// (:509-658).  The TPU has no FP64, so the Pallas kernel folds Dekker
// products into a compensated f32 pair.  Hopper has native FP64 and the
// kernel is bound by W bandwidth, so each site accumulates in f64 from
// (double)xh + (double)xl (exact for a renormalized pair, whose bits fit
// in a double's 53)
// and splits the sum into hi = (float)acc, lo = (float)(acc - hi), a
// renormalized pair.  Error: ~45 f64 roundings plus the lo rounding,
// ~1e-15 of sum |W||x|; no compiler contraction can break it (an FMA only
// removes a rounding).
__global__ void apply_w_df_sym_kernel(const float* __restrict__ W,
                                      const float* __restrict__ xh,
                                      const float* __restrict__ xl,
                                      float* __restrict__ yh,
                                      float* __restrict__ yl,
                                      const int* __restrict__ stab, int n_slots,
                                      int n0, int n1, int n2, int P) {
  const long long sp = static_cast<long long>(n0) * n1 * n2 * P;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= sp) return;
  const Site s = site_of(t, n1, n2, P);
  double acc[C] = {0.0, 0.0, 0.0};
  for (int q = 0; q < n_slots; ++q) {
    const int* e = stab + 4 * q;
    const long long nb = neighbour(s, e, n0, n1, n2, P);
    if (nb < 0) continue;
    double xv[C];
#pragma unroll
    for (int d = 0; d < C; ++d)
      xv[d] = static_cast<double>(xh[d * sp + nb]) + static_cast<double>(xl[d * sp + nb]);
    if (e[3] >= 0) {
      const float* w = W + static_cast<long long>(e[3]) * C * C * sp + t;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d)
          acc[c] += static_cast<double>(w[(c * C + d) * sp]) * xv[d];
    } else {
      const float* w = W + static_cast<long long>(-1 - e[3]) * C * C * sp + nb;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d)
          acc[c] += static_cast<double>(w[(d * C + c) * sp]) * xv[d];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float hi = static_cast<float>(acc[c]);
    yh[c * sp + t] = hi;
    yl[c * sp + t] = static_cast<float>(acc[c] - static_cast<double>(hi));
  }
}

unsigned int blocks_for(int n0, int n1, int n2, int P) {
  const long long sp = static_cast<long long>(n0) * n1 * n2 * P;
  return static_cast<unsigned int>((sp + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int apply_w_sym_f32(const void* W, const void* x, void* y, const void* stab,
                    int n_slots, int n0, int n1, int n2, int P, int device,
                    void* stream) {
  const unsigned int blocks = blocks_for(n0, n1, n2, P);
  if (blocks == 0) return 0;
  cudaSetDevice(device);
  apply_w_sym_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<const int*>(stab), n_slots, n0, n1,
      n2, P);
  return static_cast<int>(cudaGetLastError());
}

int apply_w_pencil_bf16(const void* W, const void* x, void* y, const void* stab,
                        int n_slots, int n0, int n1, int n2, int P, int device,
                        void* stream) {
  const unsigned int blocks = blocks_for(n0, n1, n2, P);
  if (blocks == 0) return 0;
  cudaSetDevice(device);
  apply_w_pencil_bf16_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(W), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<const int*>(stab), n_slots, n0, n1,
      n2, P);
  return static_cast<int>(cudaGetLastError());
}

int apply_w_df_sym_f32(const void* W, const void* xh, const void* xl, void* yh,
                       void* yl, const void* stab, int n_slots, int n0, int n1,
                       int n2, int P, int device, void* stream) {
  const unsigned int blocks = blocks_for(n0, n1, n2, P);
  if (blocks == 0) return 0;
  cudaSetDevice(device);
  apply_w_df_sym_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(xh),
      static_cast<const float*>(xl), static_cast<float*>(yh),
      static_cast<float*>(yl), static_cast<const int*>(stab), n_slots, n0, n1,
      n2, P);
  return static_cast<int>(cudaGetLastError());
}

const char* stencil_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
