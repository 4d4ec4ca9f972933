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
// Every kernel runs one thread per lattice site (i, j, k, p), or per four
// consecutive p in the kernels that load float4, with p the fastest thread
// index, so
// each W and x load of a warp is one contiguous run along the patch axis.
// All of them are bound by device-memory bandwidth: ~1 flop per byte of
// W, and W is 90% of the bytes.  A neighbour outside the lattice
// contributes nothing, which is what the JAX forms' zero halo of x gives;
// so no padded copy of x is made and no W is read beyond the lattice edge
// (the Pallas kernels read edge-clamped W blocks and rely on the zero halo
// instead).
//
// The slot table (15 x 4 ints, the rows of stencil_kernels._slot_rows /
// _transpose_rows) gives per table row an offset (o0, o1, o2) and a
// code: h >= 0 reads stored slot h at the site itself; -1 - h reads the
// transpose of stored slot h at the neighbour s + o.  K1's table mixes
// both (operator symmetry: A[s, s+o] = W[h](s+o)^T for o = -offset(h));
// K5's table reads every slot directly, and K5^T's table reads every slot
// transposed at the opposite offset: K5^T is a gather (no atomics), and
// each W element is still read once per launch, from the site that stores
// it, by the thread of the site it acts on.  Every kernel takes the table
// by value (SlotTable, in the kernel's parameters); K4 takes K1's.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// The build (_build.py) compiles this file once per part, -DSTENCIL_PART=1,
// 2 and 3, all at once, and links the three objects: part 1 holds every
// entry point but K2/K3's, part 2 K2/K3 on 1 to 4 lanes, part 3 K3 on 5 to
// 8 (the templates are instantiated only where an entry point uses them).
// Without STENCIL_PART the file is the whole library.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

#ifdef STENCIL_PART
#define STENCIL_IN_PART(k) (STENCIL_PART == (k))
#else
#define STENCIL_IN_PART(k) 1
#endif

namespace {

constexpr int kThreads = 256;

// The slot table by value: the rows of stencil_kernels._slot_rows or
// _transpose_rows for the 15-slot Kuhn stencil, in the kernel's
// parameters.  The slot loop then has a compile-time length and unrolls,
// and a row costs no memory round trip.
constexpr int kSlots = 15;

struct SlotTable {
  int row[kSlots][4];
};

// What the kernels with a by-value table share.  The grid is (blocks along
// one (i, j) pencil row, n1, n0): a thread knows i and j from its block and
// its place r along the row of n2 * P sites, which is also its place in
// memory, so no index is ever divided.  The neighbour at offset (o0, o1, o2) lies
// ((o0 * n1 + o1) * n2 + o2) * P sites further on; it is inside the
// lattice when i + o0 and j + o1 are (the same answer for the whole block)
// and r + o2 * P stays inside the row.  Site indices are 32-bit: the
// entry points refuse n0 * n1 * n2 * P >= 2^31.
//
// A neighbour outside the lattice is not branched around: its address is
// clamped to the site itself, so nothing is read beyond the lattice, and
// the loaded weight is replaced by 0.  Every load of a thread is then
// independent of every other and of every branch, so many can be in
// flight at once.
struct Neighbour {
  int at;   // flat site index of the neighbour, or of the site itself
  bool ok;  // inside the lattice
};

__device__ __forceinline__ Neighbour neighbour_of(int o0, int o1, int o2, int i, int j,
                                                  int r, int t, int n0, int n1,
                                                  int row, int P) {
  Neighbour nb;
  nb.ok = static_cast<unsigned>(i + o0) < static_cast<unsigned>(n0) &&
          static_cast<unsigned>(j + o1) < static_cast<unsigned>(n1) &&
          static_cast<unsigned>(r + o2 * P) < static_cast<unsigned>(row);
  nb.at = nb.ok ? t + (o0 * n1 + o1) * row + o2 * P : t;
  return nb;
}

__device__ __forceinline__ float zero_like(float) { return 0.f; }
__device__ __forceinline__ float2 zero_like(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ float4 zero_like(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <typename V>
__device__ __forceinline__ V keep_if(bool ok, V v) {
  return ok ? v : zero_like(v);
}
__device__ __forceinline__ void mul_add(float& acc, float w, float x) { acc += w * x; }
__device__ __forceinline__ void mul_add(float4& acc, float4 w, float4 x) {
  acc.x += w.x * x.x;
  acc.y += w.y * x.y;
  acc.z += w.z * x.z;
  acc.w += w.w * x.w;
}

// K5 and K5^T on a scalar field, C = 1: W (15, 1, 1, n0, n1, n2, P), the
// pressure convection-diffusion stencil and every sweep, residual and
// restriction of the pressure-Laplacian V-cycle of the PCD Schur block.
// Replaces pallas_stencil.py _kernel / _apply_w_pallas_3d (:59-137) at
// C = y_ref.shape[0] = 1, and its jax.vjp.  A 1x1 block is its own
// transpose, so a transposed row differs from a direct one only in where
// W is read (at the neighbour) and in the sign of the offset; one kernel
// serves both tables.
//
// Bound: device memory at 17^3 x 224 (75 MB, one multiply-add per 4 bytes
// of W); at the PCD path's 5^3 x 224 (1.9 MB) the launch and the latency
// of one round of loads.  A thread has 15 multiply-adds and nothing else
// to hide a load behind, so the design is about that latency.  V = float4
// takes 4 consecutive p per thread (a neighbour has the same p, so direct
// and transposed reads stay aligned; it needs P % 4 == 0 and 16-byte
// aligned bases, else V = float).  All 30 loads of a thread go out as
// asynchronous copies into the thread's own column of shared memory
// (cp.async: no register waits for a load, so none is held back behind a
// multiply-add, which is what the compiler did to 30 loads into
// registers), one wait, then the sum in table order out of shared memory.
// The stage is 2 x 15 x blockDim.x values of V: 30 KB at 64 threads of
// float4, so seven blocks fit an SM, and 5^3 x 224, 7,000 threads of
// float4, spreads over 125 blocks.
template <typename V>
__global__ void __launch_bounds__(256)
apply_w_scalar_kernel(const V* __restrict__ W, const V* __restrict__ x,
                      V* __restrict__ y, const SlotTable tab, int n0, int n1,
                      int n2, int P) {  // P in units of V
  extern __shared__ float4 stage_bytes[];
  V* stage = reinterpret_cast<V*>(stage_bytes) + threadIdx.x;
  const int row = n2 * P;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= row) return;  // no thread waits for another: each reads only its own column
  const int j = blockIdx.y, i = blockIdx.z;
  const int t = (i * n1 + j) * row + r;
  const size_t sp = static_cast<size_t>(n0) * n1 * row;
  unsigned inside = 0;  // bit q: slot q's neighbour lies inside the lattice
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const Neighbour nb = neighbour_of(tab.row[q][0], tab.row[q][1], tab.row[q][2], i, j, r,
                                      t, n0, n1, row, P);
    const int code = tab.row[q][3];
    const bool direct = code >= 0;
    const V* wq = W + static_cast<size_t>(direct ? code : -1 - code) * sp;
    __pipeline_memcpy_async(stage + 2 * q * blockDim.x, wq + (direct ? t : nb.at), sizeof(V));
    __pipeline_memcpy_async(stage + (2 * q + 1) * blockDim.x, x + nb.at, sizeof(V));
    inside |= static_cast<unsigned>(nb.ok) << q;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  V acc = zero_like(V());
#pragma unroll
  for (int q = 0; q < kSlots; ++q)
    mul_add(acc, keep_if((inside >> q) & 1u, stage[2 * q * blockDim.x]),
            stage[(2 * q + 1) * blockDim.x]);
  y[t] = acc;
}

// K1 on a lane axis: B lanes (B, 3, n0, n1, n2, P) that share one
// symmetric-half W, the operator and the assembled Hessian of the ADMM
// x-update's 1+m simultaneous Krylov solves.  Replaces jax.vmap of
// pallas_stencil.py _apply_w_pallas_3d_sym (:140-277).
//
// Bound: device memory.  W is 317 MB at 17^3 x 224 and a lane's x and y
// 13 MB each, so the design is K3's: each 3x3 block of W is loaded once
// into registers, at the site for a direct row and at the neighbour for a
// transposed one, and applied to every lane's x at the neighbour, with the
// B x 3 sums in registers (B is a template parameter so that they stay
// there).  One launch moves W once plus B x (x + y).  Direct and
// transposed rows differ only in the two strides of the block, chosen
// without a branch.  The per-lane sum order is that of apply_w_c3_kernel
// on K1's table, so each lane equals K1 on that lane's field bit for bit.
template <int B>
__global__ void __launch_bounds__(256)
apply_w_sym_lanes_kernel(const float* __restrict__ W, const float* __restrict__ x,
                         float* __restrict__ y, const SlotTable tab, int n0,
                         int n1, int n2, int P) {
  constexpr int C = 3;
  const int row = n2 * P;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= row) return;
  const int j = blockIdx.y, i = blockIdx.z;
  const int t = (i * n1 + j) * row + r;
  const size_t sp = static_cast<size_t>(n0) * n1 * row;
  const size_t lane = C * sp;
  float acc[B][C];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[b][c] = 0.f;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const Neighbour nb = neighbour_of(tab.row[q][0], tab.row[q][1], tab.row[q][2], i, j, r,
                                      t, n0, n1, row, P);
    const int code = tab.row[q][3];
    const bool direct = code >= 0;
    const float* w = W + static_cast<size_t>(direct ? code : -1 - code) * C * C * sp +
                     (direct ? t : nb.at);
    const size_t sc = direct ? C * sp : sp;  // stride of the sum's component c
    const size_t sd = direct ? sp : C * sp;  // stride of x's component d
    float wv[C][C];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int d = 0; d < C; ++d) wv[c][d] = keep_if(nb.ok, w[c * sc + d * sd]);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float xv[C];
#pragma unroll
      for (int d = 0; d < C; ++d) xv[d] = x[b * lane + d * sp + nb.at];
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

// K1, K5 and K5^T on one field of C = 3 components: K1's table (its half
// storage), K5's (direct rows) and K5^T's (transposed rows), by value.
// Replaces pallas_stencil.py _kernel_sym / _apply_w_pallas_3d_sym
// (:140-277) on one field, _kernel / _apply_w_pallas_3d (:59-137) at
// C = 3, and the jax.vjp of the latter.  K4 below is the same row loop
// with sums of another kind.
//
// K1 reads the 8 stored slots of symmetric half storage at the site and the
// 7 missing ones as transposes at the neighbour (the same 15 block reads
// per site as the Pallas kernel, from half the stored bytes); K5 reads
// full slot-major W (15, 3, 3, n0, n1, n2, P) of a nonsymmetric operator,
// y[s] = sum_o W[o](s) x[s+o]; K5^T, its exact transpose, y[t] = sum_o
// W[o](t-o)^T x[t-o].
//
// Bound: device memory.  A site reads 15 x 9 W values (8 x 9 stored for
// K1) and 15 x 3 x values (cached: each x is read by 15 sites) for 135
// multiply-adds.  The NS velocity V-cycle runs it on 9^3 x 224 (88 MB of
// K5's W) and on its coarse levels 5^3 and 3^3 x 224 (15 MB, 3.3 MB),
// where there are too few sites (28,000 and 6,048) to hide a memory round
// trip behind each slot, as one thread per site with a serial slot loop
// did.  So every thread keeps its loads in flight itself: V = float4 takes
// 4 consecutive p (a neighbour has the same p, so direct and transposed
// reads stay aligned; it needs P % 4 == 0 and 16-byte aligned bases, else
// V = float), and the 15 slots go in kC3Groups groups of kC3Group slots
// through a double-buffered stage in shared memory: the cp.async copies of
// group g + 1 are issued before the sum of group g, so a thread always has
// one group in flight while it sums the other.  The stage holds per slot
// the 3x3 block of W, then x[0..2] of each of the F fields the sums read:
// 2 x 3 x 12 values of V a thread for K1, 72 KB for the block of 64
// float4 threads, three blocks an SM.  Each thread reads only what it
// copied, so no barrier is needed.  The per-component sum order is q
// ascending, d ascending, one multiply-add each: that of
// apply_w_sym_lanes_kernel, so K1 on lanes equals this kernel on each
// lane's field bit for bit.
constexpr int kC3Threads = 64;
constexpr int kC3Group = 3;  // slots per stage group
constexpr int kC3Groups = kSlots / kC3Group;

// values of V staged per slot: the 3x3 block of W, then x[0..2] of each of F fields
template <int F>
__host__ __device__ constexpr int c3_slot_values() {
  return 9 + 3 * F;
}

template <typename V, int F, int T = kC3Threads>
constexpr size_t c3_stage_bytes() {
  return 2 * kC3Group * c3_slot_values<F>() * T * sizeof(V);
}

__device__ __forceinline__ void fma_into(float& acc, float w, float x) { acc = fmaf(w, x, acc); }
__device__ __forceinline__ void fma_into(float4& acc, float4 w, float4 x) {
  acc.x = fmaf(w.x, x.x, acc.x);
  acc.y = fmaf(w.y, x.y, acc.y);
  acc.z = fmaf(w.z, x.z, acc.z);
  acc.w = fmaf(w.w, x.w, acc.w);
}

// The sums of one thread over the staged slots: F = 1, f32 sums of W x
// (K1, K5, K5^T); F = 2, f64 sums of W (xh + xl) split into an f32 pair
// (K4).  add<T>() takes one slot's stage (value v at slot[v * T], T the
// threads of the block), dropped unless ok.
template <typename V, int F>
struct C3Sums;

template <typename V>
struct C3Sums<V, 1> {
  V acc[3];
  __device__ __forceinline__ C3Sums() {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = zero_like(V());
  }
  template <int T>
  __device__ __forceinline__ void add(bool ok, const V* slot) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) fma_into(acc[c], keep_if(ok, slot[(c * 3 + d) * T]), slot[(9 + d) * T]);
  }
  __device__ __forceinline__ void store(V* y, V*, size_t sp, int t) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c * sp + t] = acc[c];
  }
};

// lane l of a float or a float4 (l a constant once unrolled)
template <typename V>
__device__ __forceinline__ float lane(const V& v, int l) {
  return reinterpret_cast<const float*>(&v)[l];
}
template <typename V>
__device__ __forceinline__ float& lane(V& v, int l) {
  return reinterpret_cast<float*>(&v)[l];
}

template <typename V>
struct C3Sums<V, 2> {
  static constexpr int L = sizeof(V) / sizeof(float);  // sites a thread sums
  double acc[3][L];
  __device__ __forceinline__ C3Sums() {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int l = 0; l < L; ++l) acc[c][l] = 0.0;
  }
  template <int T>
  __device__ __forceinline__ void add(bool ok, const V* slot) {
    double x[3][L];  // xh + xl, exact for a renormalized pair
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const V h = slot[(9 + d) * T], lo = slot[(12 + d) * T];
#pragma unroll
      for (int l = 0; l < L; ++l)
        x[d][l] = static_cast<double>(lane(h, l)) + static_cast<double>(lane(lo, l));
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const V w = keep_if(ok, slot[(c * 3 + d) * T]);
#pragma unroll
        for (int l = 0; l < L; ++l) acc[c][l] = fma(static_cast<double>(lane(w, l)), x[d][l], acc[c][l]);
      }
  }
  __device__ __forceinline__ void store(V* yh, V* yl, size_t sp, int t) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      V hi, lo;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        lane(hi, l) = static_cast<float>(acc[c][l]);
        lane(lo, l) = static_cast<float>(acc[c][l] - static_cast<double>(lane(hi, l)));
      }
      yh[c * sp + t] = hi;
      yl[c * sp + t] = lo;
    }
  }
};

// The row loop the C = 3 kernels share: the thread at column r of pencil
// row (i, j) stages its 15 slots (W and the F fields x0, x1 at the
// neighbour) group by group and sums them (Sums) into y0 (and y1).
template <typename V, int F, int T = kC3Threads, typename Sums = C3Sums<V, F>>
__device__ __forceinline__ void c3_row(const V* __restrict__ W, const V* __restrict__ x0,
                                       const V* __restrict__ x1, V* __restrict__ y0,
                                       V* __restrict__ y1, const SlotTable& tab, int i, int j,
                                       int n0, int n1, int n2, int P) {  // P in units of V
  constexpr int C = 3;
  constexpr int S = c3_slot_values<F>();
  extern __shared__ float4 stage_bytes[];
  V* stage = reinterpret_cast<V*>(stage_bytes) + threadIdx.x;
  const int row = n2 * P;
  const int r = blockIdx.x * T + threadIdx.x;
  if (r >= row) return;  // no thread waits for another: each reads only its own column
  const int t = (i * n1 + j) * row + r;
  const size_t sp = static_cast<size_t>(n0) * n1 * row;
  unsigned inside = 0;  // bit q: slot q's neighbour lies inside the lattice
  // copies of group g's slots into buffer g % 2, committed as one batch
  auto stage_group = [&](int g) {
    V* buf = stage + (g % 2) * kC3Group * S * T;
#pragma unroll
    for (int k = 0; k < kC3Group; ++k) {
      const int q = g * kC3Group + k;
      const Neighbour nb = neighbour_of(tab.row[q][0], tab.row[q][1], tab.row[q][2], i, j, r,
                                        t, n0, n1, row, P);
      const int code = tab.row[q][3];
      const bool direct = code >= 0;
      const V* w = W + static_cast<size_t>(direct ? code : -1 - code) * C * C * sp +
                   (direct ? t : nb.at);
      const size_t sc = direct ? C * sp : sp;  // stride of the sum's component c
      const size_t sd = direct ? sp : C * sp;  // stride of x's component d
      V* slot = buf + k * S * T;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d)
          __pipeline_memcpy_async(slot + (c * C + d) * T, w + c * sc + d * sd, sizeof(V));
#pragma unroll
      for (int f = 0; f < F; ++f)
#pragma unroll
        for (int d = 0; d < C; ++d)
          __pipeline_memcpy_async(slot + (C * C + f * C + d) * T, (f ? x1 : x0) + d * sp + nb.at,
                                  sizeof(V));
      inside |= static_cast<unsigned>(nb.ok) << q;
    }
    __pipeline_commit();
  };
  Sums sums;
  stage_group(0);
#pragma unroll
  for (int g = 0; g < kC3Groups; ++g) {
    if (g + 1 < kC3Groups) {
      stage_group(g + 1);
      __pipeline_wait_prior(1);  // group g has landed, group g + 1 is in flight
    } else {
      __pipeline_wait_prior(0);
    }
    const V* buf = stage + (g % 2) * kC3Group * S * T;
#pragma unroll
    for (int k = 0; k < kC3Group; ++k)
      sums.template add<T>((inside >> (g * kC3Group + k)) & 1u, buf + k * S * T);
  }
  sums.store(y0, y1, sp, t);
}

template <typename V>
__global__ void __launch_bounds__(kC3Threads)
apply_w_c3_kernel(const V* __restrict__ W, const V* __restrict__ x, V* __restrict__ y,
                  const SlotTable tab, int n0, int n1, int n2, int P) {  // P in units of V
  c3_row<V, 1>(W, x, nullptr, y, nullptr, tab, blockIdx.z, blockIdx.y, n0, n1, n2, P);
}

// K4, replaces pallas_stencil.py _kernel_sym_df / _apply_w_df_pallas_3d_sym
// (:509-658): (yh, yl) = A (xh + xl) from symmetric half storage, K1's
// table, as a renormalized f32 pair.  The TPU has no FP64, so the Pallas
// kernel folds Dekker products into a compensated f32 pair.  Hopper has
// FP64: each site sums in f64, from (double)xh + (double)xl (exact for a
// renormalized pair, whose bits fit in a double's 53), and splits the sum
// into hi = (float)acc, lo = (float)(acc - hi).  Error: ~45 f64 roundings
// plus the lo rounding, ~1e-15 of sum |W||x|; no compiler contraction can
// break it (an FMA only removes a rounding).  It is the IR true residual,
// two launches a solve.
//
// Bound: device memory, 336 bytes a site (288 of W, 48 of xh, xl, yh and
// yl), 0.807 ms at 33^3 x 224.  Beside it the f64 side: a site converts
// 135 W and 90 x values to f64 (cvt.f64.f32, 16 a clock per SM, ~0.45 ms
// at 33^3) for 135 DFMA, so the conversions have to overlap the loads,
// not follow them.  The design is K1's row loop (by-value table, clamp
// and drop at the edge, float4 along p, every load of a group of three
// slots in flight as cp.async before any sum) with a stage of 15 values a
// slot (W, xh, xl): 90 KB for the block of 64 float4 threads, two blocks
// an SM.
//
// Block order.  The 7 transposed rows read stored slots at s + o, four of
// them at o0 = +1.  In the natural order (j within i) plane i's read of
// plane i + 1's W and plane i + 1's own direct read of it are one i-plane
// of W apart: 70.2 MB at 33^3 x 224, more than the 50 MB L2, so those
// bytes came twice from device memory.  K4 launches its rows in bands of
// kDfBand j-rows (banded_row).  A row's o0 = +1 neighbour is then kDfBand
// rows later (kDfBand x 2.13 MB at 33^3), its o1 = +1 neighbour the next
// row, except at the band's edge.
//
// Measured on the H100 (PERF.md; scripts/torch_k4_variants.py): at 33^3 x
// 224 the natural order takes 1.39 ms and bands of 2, 4, 8 and 16 rows
// 1.21, 1.10, 1.09 and 1.37 ms; at 17^3 (an i-plane of 18.6 MB fits the
// L2) every order is within 10% of the natural one.  Bands of 8: 74% of
// the bound at 33^3, 67% at 17^3 x 224.  What holds it there is the stage, not the f64 side: the
// same stage and order with f32 sums of W xh and no conversion at all
// take 1.03 and 0.153 ms (79% and 72%).  The stage moves 2.7 times the
// device-memory bytes from L2 (x of 15 neighbours, W of 7 again) and
// leaves two blocks an SM.  Narrower V (float2, float: more blocks, more
// instructions a site) was 20-35% slower, and xh, xl read through L1
// instead of staged (four blocks an SM) 5-20% slower.
constexpr int kDfBand = 8;

// The row (i, j) that the block of launch rank blockIdx.z * n1 + blockIdx.y
// takes when the rows are launched in bands of `band` j-rows (1 <= band):
// band by band, within a band i by i, j fastest.
__device__ __forceinline__ void banded_row(int band, int n0, int n1, int& i, int& j) {
  const int rank = blockIdx.z * n1 + blockIdx.y;
  const int j0 = rank / (band * n0) * band;  // the band's first j
  const int width = min(band, n1 - j0);
  const int in_band = rank - j0 * n0;
  i = in_band / width;
  j = j0 + in_band % width;
}

template <typename V>
__global__ void __launch_bounds__(kC3Threads)
apply_w_df_kernel(const V* __restrict__ W, const V* __restrict__ xh, const V* __restrict__ xl,
                  V* __restrict__ yh, V* __restrict__ yl, const SlotTable tab, int n0, int n1,
                  int n2, int P) {  // P in units of V
  int i, j;
  banded_row(kDfBand, n0, n1, i, j);
  c3_row<V, 2>(W, xh, xl, yh, yl, tab, i, j, n0, n1, n2, P);
}

#if STENCIL_IN_PART(1)
// Nothing: its device time is the floor under every one-launch time.
__global__ void empty_kernel() {}
#endif

// K2 and K3: full 15-slot apply from pencil-major bf16 W for B lanes that
// share W.  B = 1 is K2, replacing pallas_stencil.py _kernel_pc /
// _apply_w_pallas_3d_pc (:280-304, :369-396), the V-cycle smoother of the
// deformation solve; B = 2..8 is K3, replacing _kernel_pc_b /
// _apply_w_pallas_3d_pc_batched (:307-366), the smoother of the ADMM
// x-update's 1+m simultaneous solves:
//   y_b[c, s] = sum_q sum_d W[i, j, q, c, d, k, p] x_b[d, s + o_q],
// bf16 W widened exactly to f32, f32 x and f32 sums.
//
// Bound: device memory.  A site reads 135 bf16 weights (270 bytes) and
// 12 bytes of x and writes 12 of y per lane, for 135 multiply-adds per
// lane: about one operation per byte of W, far below the ~295 per byte at
// which the tensor cores (wgmma) would pay, so none are used.  One launch
// reads W once for all B lanes and moves W plus B x (x + y).
//
// Design.  The grid is the pencil-row grid of the other by-value kernels
// (no index division), with the slot table by value (the 15 slots unroll)
// and clamp and drop at the lattice edge.  A block of kPcThreads threads
// owns kPcThreads columns of one (i, j) pencil row, and the pencil-major
// layout makes its W 135 contiguous runs, one per (q, c, d).  V = float4
// takes 4 consecutive p per thread: an 8-byte load of 4 bf16 weights,
// float4 x and y (P % 8 == 0 and 16-byte aligned bases, so that every run
// is 16-byte aligned; else V = float, one site per thread, whose W and x
// loads go straight to registers: a 2-byte element fits no asynchronous
// copy).  With float4 the slots go through a double-buffered stage in
// shared memory (27 KB a block) in kPcGroups groups of kPcGroup slots: the
// Pallas kernel's one contiguous DMA per pencil, in Hopper's form.  27
// threads of warp 0 issue one cp.async.bulk each, a run of kPcThreads x 8
// bytes, completing on the buffer's mbarrier, so group g + 1 is in flight
// while group g is summed.  After the sum of group g every thread fences
// its reads of the buffer (generic proxy) against the bulk copy that will
// overwrite it (async proxy), and a __syncthreads frees the buffer for
// group g + 2: a thread past the row's end stays to the end, on the row's
// last site, and stores nothing.  x comes through registers and L1: each x
// is read by 15 sites, and staging it for 5 lanes would take ~117 KB a
// block.  Each 3x3 block of W is widened once and applied to every lane,
// with the B x 3 sums in registers (B is a template parameter so that they
// stay there).  The sum order per lane and component is q ascending, d
// ascending, one fmaf each, so lane b of K3 equals K2 on lane b bit for
// bit, and a dropped neighbour adds fmaf(0, x, acc) = acc.
//
// Measured on the H100 (PERF.md): per-thread cp.async copies of the same
// stage were 5-10% slower at 9^3 and 17^3 x 224; a third buffer, 128 or
// 256 columns a block and other shared-memory carveouts moved neither K2
// nor K3 by more than 3%.  K2 is bound by its W stream; K3 at B = 5 by x:
// 15 reads of each x from L2 per lane, 3.3x W's bytes.
constexpr int kPcThreads = 64;
constexpr int kPcGroup = 3;  // slots per stage group
constexpr int kPcGroups = kSlots / kPcGroup;
constexpr int kBlock = 9;  // (c, d) entries of a slot's 3x3 block
constexpr int kPcRuns = kPcGroup * kBlock;  // W runs of a group

// bf16 to f32 is exact: the bf16 bits are the f32's high half
__device__ __forceinline__ float widen(__nv_bfloat16 w) { return __bfloat162float(w); }
__device__ __forceinline__ float4 widen(uint2 w) {  // four bf16, p ascending
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// One slot into the B x 3 sums: the 3x3 block w, entry (c, d) at
// w[(c * 3 + d) * ws], dropped unless ok, applied to every lane's x at the
// neighbour, component d of lane b at x[b * xl + d * xd].
template <int B, typename V, typename WV>
__device__ __forceinline__ void pencil_slot(V (&acc)[B][3], const WV* w, int ws, bool ok,
                                            const V* x, size_t xl, size_t xd) {
  V wv[kBlock];
#pragma unroll
  for (int cd = 0; cd < kBlock; ++cd) wv[cd] = keep_if(ok, widen(w[cd * ws]));
#pragma unroll
  for (int b = 0; b < B; ++b) {
    V xv[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) xv[d] = x[b * xl + d * xd];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) fma_into(acc[b][c], wv[c * 3 + d], xv[d]);
  }
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier of one arrival a phase: its arrival also announces the bytes
// the phase's bulk copies will bring.
__device__ __forceinline__ void mbarrier_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_addr(bar)), "r"(1u) : "memory");
}

__device__ __forceinline__ void mbarrier_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

template <int B, typename V>
__global__ void __launch_bounds__(kPcThreads)
apply_w_pencil_kernel(const __nv_bfloat16* __restrict__ W, const V* __restrict__ x,
                      V* __restrict__ y, const SlotTable tab, int n0, int n1, int n2,
                      int P) {  // P in units of V
  constexpr bool vec = std::is_same<V, float4>::value;
  using WV = typename std::conditional<vec, uint2, __nv_bfloat16>::type;  // 4 or 1 weights
  constexpr int T = kPcThreads;
  // the stage, static so that ptxas reports its size
  __shared__ __align__(16) uint2 wst[vec ? 2 * kPcRuns * T : 1];  // [2][kPcGroup][9][T]
  __shared__ unsigned long long bar[2];
  const int row = n2 * P;
  const int r0 = blockIdx.x * T;
  const int r = r0 + threadIdx.x;
  if (!vec && r >= row) return;  // only the float4 form has a block-wide barrier
  const int rc = min(r, row - 1);
  const int j = blockIdx.y, i = blockIdx.z;
  const int t = (i * n1 + j) * row + rc;
  const size_t sp = static_cast<size_t>(n0) * n1 * row;
  // the pencil's W: run (q, c, d) at (q * 9 + c * 3 + d) * row
  const WV* wp = reinterpret_cast<const WV*>(W) + static_cast<size_t>(i * n1 + j) * kSlots * kBlock * row;
  const int live = min(T, row - r0);  // the block's columns inside the row
  if constexpr (vec) {
    if (threadIdx.x == 0) {
      mbarrier_init(&bar[0]);
      mbarrier_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // group g's slots into buffer g % 2: run (g * kPcGroup + k, c, d) is the
  // buffer's run k * 9 + c * 3 + d
  auto stage_group = [&](int g) {
    if (vec && threadIdx.x < kPcRuns) {
      const unsigned bytes = live * sizeof(WV);
      if (threadIdx.x == 0) mbarrier_expect(&bar[g % 2], kPcRuns * bytes);
      bulk_copy(wst + ((g % 2) * kPcRuns + threadIdx.x) * T,
                wp + static_cast<size_t>(g * kPcRuns + threadIdx.x) * row + r0, bytes, &bar[g % 2]);
    }
  };
  V acc[B][3];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[b][c] = zero_like(V());
  stage_group(0);
#pragma unroll
  for (int g = 0; g < kPcGroups; ++g) {
    if (g + 1 < kPcGroups) stage_group(g + 1);
    if constexpr (vec) mbarrier_wait(&bar[g % 2], (g / 2) & 1);
#pragma unroll
    for (int k = 0; k < kPcGroup; ++k) {
      const int q = g * kPcGroup + k;
      const Neighbour nb = neighbour_of(tab.row[q][0], tab.row[q][1], tab.row[q][2], i, j, rc, t,
                                        n0, n1, row, P);
      if constexpr (vec)
        pencil_slot<B>(acc, wst + ((g % 2) * kPcRuns + k * kBlock) * T + threadIdx.x, T, nb.ok,
                       x + nb.at, 3 * sp, sp);
      else
        pencil_slot<B>(acc, wp + static_cast<size_t>(q * kBlock) * row + r, row, nb.ok, x + nb.at,
                       3 * sp, sp);
    }
    if constexpr (vec)
      if (g + 2 < kPcGroups) {
        // buffer g % 2 is free for group g + 2: every thread's reads of it
        // (generic proxy) ordered before the bulk copy (async proxy)
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

// What the kernels with a by-value table take: the table's 15 x 4 ints in
// host memory, and a lattice whose pencil grid (blocks along a row, n1,
// n0) and 32-bit site indices hold it.
struct RowGrid {
  SlotTable tab;
  dim3 grid;
  bool ok;
};

RowGrid row_grid(const int* slots, int n0, int n1, int n2, int P, int threads) {
  RowGrid g;
  const long long row = static_cast<long long>(n2) * P;
  g.ok = threads >= 32 && threads <= 256 && threads % 32 == 0 && n0 <= 65535 &&
         n1 <= 65535 && row * n0 * n1 < (1LL << 31);
  if (!g.ok) return g;
  for (int q = 0; q < kSlots; ++q)
    for (int v = 0; v < 4; ++v) g.tab.row[q][v] = slots[4 * q + v];
  g.grid = dim3(static_cast<unsigned int>((row + threads - 1) / threads), n1, n0);
  return g;
}

struct Lanes {
  const float* W;
  const float* x;
  float* y;
  int n0, n1, n2, P;
  cudaStream_t stream;
};

template <int B>
void launch_lanes(const Lanes& a, const RowGrid& g) {
  apply_w_sym_lanes_kernel<B><<<g.grid, kThreads, 0, a.stream>>>(
      a.W, a.x, a.y, g.tab, a.n0, a.n1, a.n2, a.P);
}

// The scalar kernel with its stage of 2 x 15 x threads values of V in
// dynamic shared memory; above 48 KB a kernel has to be allowed it first.
template <typename V>
void launch_scalar(const V* W, const V* x, V* y, const RowGrid& g, int n0, int n1,
                   int n2, int Pv, int threads, cudaStream_t stream) {
  const size_t stage = 2 * kSlots * static_cast<size_t>(threads) * sizeof(V);
  if (stage > 48 * 1024)
    cudaFuncSetAttribute(apply_w_scalar_kernel<V>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(stage));
  apply_w_scalar_kernel<V><<<g.grid, threads, stage, stream>>>(W, x, y, g.tab, n0, n1,
                                                              n2, Pv);
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// A kernel allowed its stage of dynamic shared memory and the largest
// shared-memory carveout (once per kernel: the callers keep the result).
template <typename Kernel>
cudaError_t allow_stage(Kernel* kernel, size_t stage) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(stage));
  return e != cudaSuccess ? e
                          : cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

// The C = 3 kernel with its stage of 2 x kC3Group x 12 x kC3Threads values
// of V in dynamic shared memory (72 KB for float4), so that three blocks
// fit an SM.
template <typename V>
cudaError_t launch_c3(const V* W, const V* x, V* y, const RowGrid& g, int n0, int n1, int n2,
                      int Pv, cudaStream_t stream) {
  constexpr size_t stage = c3_stage_bytes<V, 1>();
  static const cudaError_t allowed = allow_stage(apply_w_c3_kernel<V>, stage);
  if (allowed != cudaSuccess) return allowed;
  apply_w_c3_kernel<V><<<g.grid, kC3Threads, stage, stream>>>(W, x, y, g.tab, n0, n1, n2, Pv);
  return cudaGetLastError();
}

// K4 with its stage of 2 x kC3Group x 15 x kC3Threads values of V (90 KB
// for float4, two blocks an SM).
template <typename V>
cudaError_t launch_df(const V* W, const V* xh, const V* xl, V* yh, V* yl, const RowGrid& g, int n0,
                      int n1, int n2, int Pv, cudaStream_t stream) {
  constexpr size_t stage = c3_stage_bytes<V, 2>();
  static const cudaError_t allowed = allow_stage(apply_w_df_kernel<V>, stage);
  if (allowed != cudaSuccess) return allowed;
  apply_w_df_kernel<V><<<g.grid, kC3Threads, stage, stream>>>(W, xh, xl, yh, yl, g.tab, n0, n1, n2,
                                                              Pv);
  return cudaGetLastError();
}

// K2/K3 on B lanes, the float4 form where vec, else the float form.
template <int B>
void launch_pencil(const void* W, const void* x, void* y, const RowGrid& g, int n0, int n1, int n2,
                   int Pv, bool vec, cudaStream_t s) {
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  if (vec)
    apply_w_pencil_kernel<B, float4><<<g.grid, kPcThreads, 0, s>>>(
        w, static_cast<const float4*>(x), static_cast<float4*>(y), g.tab, n0, n1, n2, Pv);
  else
    apply_w_pencil_kernel<B, float><<<g.grid, kPcThreads, 0, s>>>(
        w, static_cast<const float*>(x), static_cast<float*>(y), g.tab, n0, n1, n2, Pv);
}

// launch_pencil<lanes> for Lo <= lanes <= Hi
template <int Lo, int Hi>
void launch_pencil_for(int lanes, const void* W, const void* x, void* y, const RowGrid& g, int n0,
                       int n1, int n2, int Pv, bool vec, cudaStream_t s) {
  if (lanes == Lo)
    launch_pencil<Lo>(W, x, y, g, n0, n1, n2, Pv, vec, s);
  else if constexpr (Lo < Hi)
    launch_pencil_for<Lo + 1, Hi>(lanes, W, x, y, g, n0, n1, n2, Pv, vec, s);
}

// K2/K3 on B = lanes lanes for Lo <= B <= Hi, checked as apply_w_pencil_bf16 says.
template <int Lo, int Hi>
int pencil_entry(const void* W, const void* x, void* y, const int* slots, int n0, int n1, int n2,
                 int P, int lanes, int device, void* stream) {
  if (static_cast<long long>(n0) * n1 * n2 * P == 0) return 0;
  const bool vec = P % 8 == 0 && aligned16(W) && aligned16(x) && aligned16(y);
  const int Pv = vec ? P / 4 : P;
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, kPcThreads);
  if (!g.ok || lanes < Lo || lanes > Hi || static_cast<long long>(n0) * n1 * n2 * P >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_pencil_for<Lo, Hi>(lanes, W, x, y, g, n0, n1, n2, Pv, vec, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#if STENCIL_IN_PART(1)
// K1 (its half-storage table), K5 (the table of direct rows) and K5^T
// (the table of transposed rows) on one field of 3 components; slots is
// the table (15 x 4 ints, host memory).  float4 along p where P and the
// bases allow it.  A lattice of 2^31 sites or more is refused.
int apply_w_c3_f32(const void* W, const void* x, void* y, const int* slots, int n0, int n1,
                   int n2, int P, int device, void* stream) {
  if (static_cast<long long>(n0) * n1 * n2 * P == 0) return 0;
  const bool vec = P % 4 == 0 && aligned16(W) && aligned16(x) && aligned16(y);
  const int Pv = vec ? P / 4 : P;
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, kC3Threads);
  if (!g.ok || static_cast<long long>(n0) * n1 * n2 * P >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_c3(static_cast<const float4*>(W), static_cast<const float4*>(x),
                      static_cast<float4*>(y), g, n0, n1, n2, Pv, s)
          : launch_c3(static_cast<const float*>(W), static_cast<const float*>(x),
                      static_cast<float*>(y), g, n0, n1, n2, Pv, s));
}

// K1 on 2..8 lanes; slots is K1's table (15 x 4 ints, host memory).  Any
// other lane count, or a lattice of 2^31 sites or more, is refused.
int apply_w_sym_lanes_f32(const void* W, const void* x, void* y, const int* slots,
                          int n0, int n1, int n2, int P, int lanes, int device,
                          void* stream) {
  if (static_cast<long long>(n0) * n1 * n2 * P == 0) return 0;
  const RowGrid g = row_grid(slots, n0, n1, n2, P, kThreads);
  if (!g.ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const Lanes args{static_cast<const float*>(W), static_cast<const float*>(x),
                   static_cast<float*>(y), n0, n1, n2, P,
                   static_cast<cudaStream_t>(stream)};
  switch (lanes) {
    case 2: launch_lanes<2>(args, g); break;
    case 3: launch_lanes<3>(args, g); break;
    case 4: launch_lanes<4>(args, g); break;
    case 5: launch_lanes<5>(args, g); break;
    case 6: launch_lanes<6>(args, g); break;
    case 7: launch_lanes<7>(args, g); break;
    case 8: launch_lanes<8>(args, g); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif

// K3 on 5..8 lanes: part 3 of the build, called by apply_w_pencil_bf16.
int apply_w_pencil_bf16_wide(const void* W, const void* x, void* y, const int* slots, int n0,
                             int n1, int n2, int P, int lanes, int device, void* stream);

#if STENCIL_IN_PART(2)
// K2 (lanes = 1) and K3 (lanes = 2..8); slots is K5's direct table (15 x 4
// ints, host memory), of which the kernel reads the offsets.  float4 along
// p where P % 8 == 0 and the bases are 16-byte aligned.  Any other lane
// count, or a lattice of 2^31 sites or more, is refused.
int apply_w_pencil_bf16(const void* W, const void* x, void* y, const int* slots, int n0, int n1,
                        int n2, int P, int lanes, int device, void* stream) {
  return lanes > 4 ? apply_w_pencil_bf16_wide(W, x, y, slots, n0, n1, n2, P, lanes, device, stream)
                   : pencil_entry<1, 4>(W, x, y, slots, n0, n1, n2, P, lanes, device, stream);
}
#endif

#if STENCIL_IN_PART(3)
int apply_w_pencil_bf16_wide(const void* W, const void* x, void* y, const int* slots, int n0,
                             int n1, int n2, int P, int lanes, int device, void* stream) {
  return pencil_entry<5, 8>(W, x, y, slots, n0, n1, n2, P, lanes, device, stream);
}
#endif

#if STENCIL_IN_PART(1)
// K4: (yh, yl) = A (xh + xl); slots is K1's table (15 x 4 ints, host
// memory).  float4 along p where P and the bases allow it.  A lattice of
// 2^31 sites or more is refused.
int apply_w_df_sym_f32(const void* W, const void* xh, const void* xl, void* yh, void* yl,
                       const int* slots, int n0, int n1, int n2, int P, int device, void* stream) {
  if (static_cast<long long>(n0) * n1 * n2 * P == 0) return 0;
  const bool vec = P % 4 == 0 && aligned16(W) && aligned16(xh) && aligned16(xl) &&
                   aligned16(yh) && aligned16(yl);
  const int Pv = vec ? P / 4 : P;
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, kC3Threads);
  if (!g.ok || static_cast<long long>(n0) * n1 * n2 * P >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_df(static_cast<const float4*>(W), static_cast<const float4*>(xh),
                      static_cast<const float4*>(xl), static_cast<float4*>(yh),
                      static_cast<float4*>(yl), g, n0, n1, n2, Pv, s)
          : launch_df(static_cast<const float*>(W), static_cast<const float*>(xh),
                      static_cast<const float*>(xl), static_cast<float*>(yh),
                      static_cast<float*>(yl), g, n0, n1, n2, Pv, s));
}

// K5 and K5^T on a scalar field; slots is the direct or the transposed
// table (15 x 4 ints, host memory), threads the block size (a multiple of
// 32 up to 256).  float4 along p where P and the bases allow it.  A
// lattice of 2^31 sites or more is refused.
int apply_w_scalar_f32(const void* W, const void* x, void* y, const int* slots,
                       int n0, int n1, int n2, int P, int threads, int device,
                       void* stream) {
  if (static_cast<long long>(n0) * n1 * n2 * P == 0) return 0;
  const bool vec = P % 4 == 0 && aligned16(W) && aligned16(x) && aligned16(y);
  const int Pv = vec ? P / 4 : P;
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, threads);
  if (!g.ok || static_cast<long long>(n0) * n1 * n2 * P >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    launch_scalar(static_cast<const float4*>(W), static_cast<const float4*>(x),
                  static_cast<float4*>(y), g, n0, n1, n2, Pv, threads, s);
  else
    launch_scalar(static_cast<const float*>(W), static_cast<const float*>(x),
                  static_cast<float*>(y), g, n0, n1, n2, Pv, threads, s);
  return static_cast<int>(cudaGetLastError());
}

// one launch of a kernel that does nothing
int launch_empty(int device, void* stream) {
  cudaSetDevice(device);
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* stencil_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif

}  // extern "C"
