// Brick-patch stencil applies for Hopper (sm_90a): the CUDA counterparts
// of the Pallas TPU kernels in admm_optim_tpu/ops/pallas_stencil.py.
//
// Layouts (ops/stencil_kernels.py): fields x, y are (C, n0, n1, n2, P) f32
// with C = 3 (C = 1 too for the full-stencil apply and its transpose: the
// scalar pressure operators of the PCD Schur block), or
// (lanes, C, n0, n1, n2, P) for the lane forms; W is
// symmetric half storage (H, C, C, n0, n1, n2, P) f32, full slot-major
// (O, C, C, n0, n1, n2, P) f32, or pencil-major (n0, n1, O, C, C, n2, P)
// bf16, shared by all lanes.  y is additive: per-patch partial sums, made
// consistent by the exchange that follows.
//
// Every kernel runs one thread per lattice site (i, j, k, p) with p the
// fastest thread index, so each W and x load of a warp is one contiguous
// run along the patch axis.  All of them are bound by device-memory
// bandwidth: ~1 flop per byte of W, and W is 90% of the bytes.  A
// neighbour outside the lattice contributes nothing, which is what the
// JAX forms' zero halo of x gives; so no padded copy of x is made and no
// W is read beyond the lattice edge (the Pallas kernels read edge-clamped
// W blocks and rely on the zero halo instead).
//
// The slot table `stab` (n_slots x 4 int32, built by
// stencil_kernels._slot_table / _transpose_table) gives per table row an
// offset (o0, o1, o2) and a code: h >= 0 reads stored slot h at the site
// itself; -1 - h reads the transpose of stored slot h at the neighbour
// s + o.  K1's table mixes both (operator symmetry: A[s, s+o] =
// W[h](s+o)^T for o = -offset(h)); K5's table reads every slot directly,
// and K5^T's table reads every slot transposed at the opposite offset.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// One thread per site applies every row of the slot table: a direct
// read W[h](s) x[s+o] or a transposed one W[h](s+o)^T x[s+o].
//
// K1, replaces pallas_stencil.py _kernel_sym / _apply_w_pallas_3d_sym
// (:140-277): symmetric half storage, the 8 stored slots read once at the
// site and the 7 missing ones as transposes at the neighbour (same 15
// block reads per site as the Pallas kernel, from half the stored bytes).
// With lanes > 1 (what jax.vmap makes of the Pallas call) the lane is the
// fastest part of the block index, so the blocks of one site range run
// back to back and all but the first read W from L2 rather than device
// memory.
//
// K5, replaces pallas_stencil.py _kernel / _apply_w_pallas_3d (:59-137):
// full slot-major W (15, C, C, n0, n1, n2, P) of a nonsymmetric operator,
// y[s] = sum_o W[o](s) x[s+o], every row direct.
//
// K5^T, the exact transpose of K5, y[t] = sum_o W[o](t-o)^T x[t-o]: a
// gather (no atomics), every row transposed at offset -o.  It replaces the
// jax.vjp of K5 that ns_solver.transpose_M takes through the NS velocity
// V-cycle.  Each W element is still read once per launch, from the site
// that stores it, by the thread of the site it acts on.
//
// K5 and K5^T stream twice K1's W bytes (all 15 slots stored: 88 MB at
// the NS V-cycle's 9^3 x 224 fine level, 594 MB at 17^3 x 224) for the
// same flops, so they are bound by device memory like K1; the warp's W
// and x loads stay contiguous along the patch axis in both directions.
//
// The kernel is templated on the component count C.  C = 3 serves K1, K5
// and K5^T on vector fields.  C = 1 is K5 and K5^T on a scalar field, W
// (15, 1, 1, n0, n1, n2, P): the pressure convection-diffusion stencil
// and every sweep, residual and restriction of the pressure-Laplacian
// V-cycle of the PCD Schur block (pallas_stencil.py _apply_w_pallas_3d is
// generic in C the same way, C = y_ref.shape[0]).  A 1x1 block is its own
// transpose, so at C = 1 the transposed rows differ from the direct ones
// only in where W is read (at the neighbour) and in the sign of the
// offset.  The scalar lattices are small (5^3 x 224 at refs=2 moves 1.9
// MB), so there the launch itself, not the memory traffic, sets the time.
template <int C>
__global__ void apply_w_slots_kernel(const float* __restrict__ W,
                                   const float* __restrict__ x,
                                   float* __restrict__ y,
                                   const int* __restrict__ stab, int n_slots,
                                   int n0, int n1, int n2, int P, int lanes) {
  const long long sp = static_cast<long long>(n0) * n1 * n2 * P;
  const long long t =
      static_cast<long long>(blockIdx.x / lanes) * blockDim.x + threadIdx.x;
  if (t >= sp) return;
  const long long lane_off = static_cast<long long>(blockIdx.x % lanes) * C * sp;
  x += lane_off;
  y += lane_off;
  const Site s = site_of(t, n1, n2, P);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
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

// K2 and K3: full 15-slot apply from pencil-major bf16 W for B lanes that
// share W.  B = 1 is K2, replacing pallas_stencil.py _kernel_pc /
// _apply_w_pallas_3d_pc (:280-304, :369-396); B = 2..8 is K3, replacing
// _kernel_pc_b / _apply_w_pallas_3d_pc_batched (:307-366), the V-cycle
// smoother of the ADMM x-update's 1+m simultaneous solves.  Weights are
// widened in registers, x and the sums stay f32.
//
// Bound: device-memory bandwidth at ~1 flop per byte.  W is the dominant
// stream (297 MB of bf16 at the refs=4 fine shape 17^3 x 224, against
// 2 x 13 MB of f32 x and y per lane), so B launches of K2 would move
// ~B x 323 MB.  The TPU kernel keeps a pencil's W block resident in VMEM
// while its grid walks the lanes; here one thread per site loads each
// W[q, c, d] once and applies it to every lane's x at the neighbour, with
// B x 3 f32 accumulators in registers (the kernel is templated on B so
// they stay registers).  One launch moves W once plus B x (x + y): ~427 MB
// at B = 5.  The per-lane sum order is K2's, so each lane equals K2 on
// that lane's field.
template <int B>
__global__ void apply_w_pencil_bf16_kernel(const __nv_bfloat16* __restrict__ W,
                                           const float* __restrict__ x,
                                           float* __restrict__ y,
                                           const int* __restrict__ stab,
                                           int n_slots, int n0, int n1, int n2,
                                           int P) {
  constexpr int C = 3;
  const long long sp = static_cast<long long>(n0) * n1 * n2 * P;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= sp) return;
  const Site s = site_of(t, n1, n2, P);
  const long long cd_stride = static_cast<long long>(n2) * P;  // one (c, d) block
  const long long pencil =
      (static_cast<long long>(s.i) * n1 + s.j) * n_slots * C * C * cd_stride +
      static_cast<long long>(s.k) * P + s.p;
  const long long lane = C * sp;
  float acc[B][C];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[b][c] = 0.f;
  for (int q = 0; q < n_slots; ++q) {
    const int* e = stab + 4 * q;
    const long long nb = neighbour(s, e, n0, n1, n2, P);
    if (nb < 0) continue;
    const __nv_bfloat16* w = W + pencil + static_cast<long long>(q) * C * C * cd_stride;
    float wv[C][C];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int d = 0; d < C; ++d) wv[c][d] = __bfloat162float(w[(c * C + d) * cd_stride]);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float xv[C];
#pragma unroll
      for (int d = 0; d < C; ++d) xv[d] = x[b * lane + d * sp + nb];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d) acc[b][c] += wv[c][d] * xv[d];
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int c = 0; c < C; ++c) y[b * lane + c * sp + t] = acc[b][c];
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
  constexpr int C = 3;
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

struct Pencil {
  const __nv_bfloat16* W;
  const float* x;
  float* y;
  const int* stab;
  int n_slots, n0, n1, n2, P;
  unsigned int blocks;
  cudaStream_t stream;
};

template <int B>
void launch_pencil(const Pencil& a) {
  apply_w_pencil_bf16_kernel<B><<<a.blocks, kThreads, 0, a.stream>>>(
      a.W, a.x, a.y, a.stab, a.n_slots, a.n0, a.n1, a.n2, a.P);
}

// K5 (table of direct rows) and K5^T (table of transposed rows): one
// field of ncomp = 3 or 1 components, full slot-major W; any other count
// is refused
template <int C>
void launch_slots(const void* W, const void* x, void* y, const void* stab,
                  int n_slots, int n0, int n1, int n2, int P,
                  unsigned int blocks, void* stream) {
  apply_w_slots_kernel<C><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<const int*>(stab), n_slots, n0, n1,
      n2, P, 1);
}

int launch_full(const void* W, const void* x, void* y, const void* stab,
                int n_slots, int n0, int n1, int n2, int P, int ncomp,
                int device, void* stream) {
  if (ncomp != 1 && ncomp != 3) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = blocks_for(n0, n1, n2, P);
  if (blocks == 0) return 0;
  cudaSetDevice(device);
  if (ncomp == 3)
    launch_slots<3>(W, x, y, stab, n_slots, n0, n1, n2, P, blocks, stream);
  else
    launch_slots<1>(W, x, y, stab, n_slots, n0, n1, n2, P, blocks, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int apply_w_sym_f32(const void* W, const void* x, void* y, const void* stab,
                    int n_slots, int n0, int n1, int n2, int P, int lanes,
                    int device, void* stream) {
  const unsigned int blocks = blocks_for(n0, n1, n2, P);
  if (blocks == 0) return 0;
  cudaSetDevice(device);
  apply_w_slots_kernel<3><<<blocks * lanes, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<const int*>(stab), n_slots, n0, n1,
      n2, P, lanes);
  return static_cast<int>(cudaGetLastError());
}

// lanes = 1 is K2, 2..8 K3; any other count is refused
int apply_w_pencil_bf16(const void* W, const void* x, void* y, const void* stab,
                        int n_slots, int n0, int n1, int n2, int P, int lanes,
                        int device, void* stream) {
  const unsigned int blocks = blocks_for(n0, n1, n2, P);
  if (blocks == 0) return 0;
  cudaSetDevice(device);
  const Pencil args{static_cast<const __nv_bfloat16*>(W), static_cast<const float*>(x),
                    static_cast<float*>(y), static_cast<const int*>(stab),
                    n_slots, n0, n1, n2, P, blocks, static_cast<cudaStream_t>(stream)};
  switch (lanes) {
    case 1: launch_pencil<1>(args); break;
    case 2: launch_pencil<2>(args); break;
    case 3: launch_pencil<3>(args); break;
    case 4: launch_pencil<4>(args); break;
    case 5: launch_pencil<5>(args); break;
    case 6: launch_pencil<6>(args); break;
    case 7: launch_pencil<7>(args); break;
    case 8: launch_pencil<8>(args); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

int apply_w_full_f32(const void* W, const void* x, void* y, const void* stab,
                     int n_slots, int n0, int n1, int n2, int P, int ncomp,
                     int device, void* stream) {
  return launch_full(W, x, y, stab, n_slots, n0, n1, n2, P, ncomp, device, stream);
}

int apply_w_full_t_f32(const void* W, const void* x, void* y, const void* stab,
                       int n_slots, int n0, int n1, int n2, int P, int ncomp,
                       int device, void* stream) {
  return launch_full(W, x, y, stab, n_slots, n0, n1, n2, P, ncomp, device, stream);
}

const char* stencil_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
