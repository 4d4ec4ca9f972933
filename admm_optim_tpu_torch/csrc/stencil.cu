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
// The slot table (n_slots x 4 int32, built by stencil_kernels._slot_table
// / _transpose_table) gives per table row an offset (o0, o1, o2) and a
// code: h >= 0 reads stored slot h at the site itself; -1 - h reads the
// transpose of stored slot h at the neighbour s + o.  K1's table mixes
// both (operator symmetry: A[s, s+o] = W[h](s+o)^T for o = -offset(h));
// K5's table reads every slot directly, and K5^T's table reads every slot
// transposed at the opposite offset: K5^T is a gather (no atomics), and
// each W element is still read once per launch, from the site that stores
// it, by the thread of the site it acts on.  K4 reads the table (`stab`)
// from device memory; K1, K2, K3, K5 and K5^T take it by value (SlotTable,
// the same rows, in the kernel's parameters).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// The slot table by value: the rows of stencil_kernels._slot_table or
// _transpose_table for the 15-slot Kuhn stencil, in the kernel's
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
// C = 3, and the jax.vjp of the latter.
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
// through a double-buffered stage in shared memory: the 36 cp.async
// copies of group g + 1 are issued before the sum of group g, so a thread
// always has one group in flight while it sums the other.  The stage is
// 2 x 3 x 12 values of V a thread (the 3x3 block of W, then x[0..2], per
// slot), 72 KB for the block of 64 float4 threads: three blocks an SM.
// Each thread reads only what it copied, so no barrier is needed.  The
// per-component sum order is q ascending, d ascending, one multiply-add
// each: that of apply_w_sym_lanes_kernel, so K1 on lanes equals this
// kernel on each lane's field bit for bit.
constexpr int kC3Threads = 64;
constexpr int kC3Group = 3;  // slots per stage group
constexpr int kC3Groups = kSlots / kC3Group;
constexpr int kC3Slot = 12;  // values of V staged per slot

__device__ __forceinline__ void fma_into(float& acc, float w, float x) { acc = fmaf(w, x, acc); }
__device__ __forceinline__ void fma_into(float4& acc, float4 w, float4 x) {
  acc.x = fmaf(w.x, x.x, acc.x);
  acc.y = fmaf(w.y, x.y, acc.y);
  acc.z = fmaf(w.z, x.z, acc.z);
  acc.w = fmaf(w.w, x.w, acc.w);
}

template <typename V>
__global__ void __launch_bounds__(kC3Threads)
apply_w_c3_kernel(const V* __restrict__ W, const V* __restrict__ x, V* __restrict__ y,
                  const SlotTable tab, int n0, int n1, int n2, int P) {  // P in units of V
  constexpr int C = 3;
  constexpr int T = kC3Threads;
  extern __shared__ float4 stage_bytes[];
  V* stage = reinterpret_cast<V*>(stage_bytes) + threadIdx.x;
  const int row = n2 * P;
  const int r = blockIdx.x * T + threadIdx.x;
  if (r >= row) return;  // no thread waits for another: each reads only its own column
  const int j = blockIdx.y, i = blockIdx.z;
  const int t = (i * n1 + j) * row + r;
  const size_t sp = static_cast<size_t>(n0) * n1 * row;
  unsigned inside = 0;  // bit q: slot q's neighbour lies inside the lattice
  // copies of group g's slots into buffer g % 2, committed as one batch
  auto stage_group = [&](int g) {
    V* buf = stage + (g % 2) * kC3Group * kC3Slot * T;
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
      V* slot = buf + k * kC3Slot * T;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d)
          __pipeline_memcpy_async(slot + (c * C + d) * T, w + c * sc + d * sd, sizeof(V));
#pragma unroll
      for (int d = 0; d < C; ++d)
        __pipeline_memcpy_async(slot + (C * C + d) * T, x + d * sp + nb.at, sizeof(V));
      inside |= static_cast<unsigned>(nb.ok) << q;
    }
    __pipeline_commit();
  };
  V acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = zero_like(V());
  stage_group(0);
#pragma unroll
  for (int g = 0; g < kC3Groups; ++g) {
    if (g + 1 < kC3Groups) {
      stage_group(g + 1);
      __pipeline_wait_prior(1);  // group g has landed, group g + 1 is in flight
    } else {
      __pipeline_wait_prior(0);
    }
    const V* buf = stage + (g % 2) * kC3Group * kC3Slot * T;
#pragma unroll
    for (int k = 0; k < kC3Group; ++k) {
      const bool ok = (inside >> (g * kC3Group + k)) & 1u;
      const V* slot = buf + k * kC3Slot * T;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < C; ++d)
          fma_into(acc[c], keep_if(ok, slot[(c * C + d) * T]), slot[(C * C + d) * T]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) y[c * sp + t] = acc[c];
}

// Nothing: its device time is the floor under every one-launch time.
__global__ void empty_kernel() {}

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

// The C = 3 kernel with its stage of 2 x kC3Group x 12 x kC3Threads values
// of V in dynamic shared memory (72 KB for float4).  Allowed the stage and
// the largest shared-memory carveout once per V, so that three blocks fit
// an SM; then launched.
template <typename V>
cudaError_t launch_c3(const V* W, const V* x, V* y, const RowGrid& g, int n0, int n1, int n2,
                      int Pv, cudaStream_t stream) {
  constexpr size_t stage = 2 * kC3Group * kC3Slot * kC3Threads * sizeof(V);
  static const cudaError_t allowed = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        apply_w_c3_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(stage));
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(apply_w_c3_kernel<V>,
                                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }();
  if (allowed != cudaSuccess) return allowed;
  apply_w_c3_kernel<V><<<g.grid, kC3Threads, stage, stream>>>(W, x, y, g.tab, n0, n1, n2, Pv);
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

}  // namespace

extern "C" {

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

// K2 (lanes = 1) and K3 (lanes = 2..8); slots is K5's direct table (15 x 4
// ints, host memory), of which the kernel reads the offsets.  float4 along
// p where P % 8 == 0 and the bases are 16-byte aligned.  Any other lane
// count, or a lattice of 2^31 sites or more, is refused.
int apply_w_pencil_bf16(const void* W, const void* x, void* y, const int* slots, int n0, int n1,
                        int n2, int P, int lanes, int device, void* stream) {
  if (static_cast<long long>(n0) * n1 * n2 * P == 0) return 0;
  const bool vec = P % 8 == 0 && aligned16(W) && aligned16(x) && aligned16(y);
  const int Pv = vec ? P / 4 : P;
  const RowGrid g = row_grid(slots, n0, n1, n2, Pv, kPcThreads);
  if (!g.ok || static_cast<long long>(n0) * n1 * n2 * P >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: launch_pencil<1>(W, x, y, g, n0, n1, n2, Pv, vec, s); break;
    case 2: launch_pencil<2>(W, x, y, g, n0, n1, n2, Pv, vec, s); break;
    case 3: launch_pencil<3>(W, x, y, g, n0, n1, n2, Pv, vec, s); break;
    case 4: launch_pencil<4>(W, x, y, g, n0, n1, n2, Pv, vec, s); break;
    case 5: launch_pencil<5>(W, x, y, g, n0, n1, n2, Pv, vec, s); break;
    case 6: launch_pencil<6>(W, x, y, g, n0, n1, n2, Pv, vec, s); break;
    case 7: launch_pencil<7>(W, x, y, g, n0, n1, n2, Pv, vec, s); break;
    case 8: launch_pencil<8>(W, x, y, g, n0, n1, n2, Pv, vec, s); break;
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

}  // extern "C"
