// One step of the coupled vector Chebyshev filter recurrence, for Hopper (sm_90a):
// periodic entries on a whole field (vec_pass_f32/f64) and windowed local
// entries on a halo-extended shard block (vec_local_pass_f32/f64, below); and
// the fused passes of several steps per launch on either (vec_fused_pass_*,
// vec_local_fused_pass_*, on the tiles of vec_tile.cuh).
//
// The periodic entries replace the two TPU kernels built by
// gcm_filters_tpu/ops/pallas/vec_pass.py::_build_coupled_pass (kernel body
// `kernel`):
//   - build_vec_pass  (B-grid, contraction `_bgrid_lap`), op = BGRID;
//   - build_ctap_pass (C-grid 18-tap form, contraction `_ctap_lap`), op = CTAP.
// This file ports WHAT that kernel computes, not its TPU layout (no packed
// (nb, n_ext, win, wx) coefficient stream, no lane-tail wrap, no DMA windows,
// no block planner).
//
// The state is the stacked pair (batch, 2, ny, nx): u at component 0, v at
// component 1. Coefficients are one (n_coef, ny, nx) array shared by every
// batch entry, pre-scaled on the host by -2*lap_scale:
//   BGRID, 10 planes: cc dun dus due duw (diffusion) dmc dmn dms dme dmw (mixing)
//     lap'(t)_u = S_diff(g_u) + S_mix(g_v),  lap'(t)_v = S_diff(g_v) + S_mix(g_u)
//     S(f) = c*f + n*f[j+1,i] + s*f[j-1,i] + e*f[j,i+1] + w*f[j,i-1]
//   CTAP, 18 planes in ops/ctaps.py CTAPS order:
//     lap'_u = CU_c u + CU_w u[j,i-1] + CU_e u[j,i+1] + CU_s u[j-1,i] + CU_n u[j+1,i]
//            + DU_c v + DU_s v[j-1,i] + DU_e v[j,i+1] + DU_se v[j-1,i+1]
//     lap'_v = CV_c v + CV_w v[j,i-1] + CV_e v[j,i+1] + CV_s v[j-1,i] + CV_n v[j+1,i]
//            + DV_c u + DV_w u[j,i-1] + DV_n u[j+1,i] + DV_nw u[j+1,i-1]
// with g = zap ? nan_to_num(t) : t, periodic in x and in y (vector grids have
// no fold, no mask and no area). One launch computes, for both components:
//   FIRST  : T1 = -w + 0.5*lap'(w); acc = p_a*w + p_b*T1; writes T1 (t_next), acc
//   MIDDLE : t_next = -2t + lap'(t) - t_prev; acc += p_a*t_next
//            t_next may be the t_prev buffer (updated in place), acc is
//            updated in place
//   LAST   : acc += p_a*(-2t + lap'(t) - t_prev); acc holds the result
// nan_to_num applies to the contraction's input only: -2t and -t_prev use
// the raw values, so a NaN cell stays NaN while its neighbours see zero.
//
// Design: one thread per cell computes both the u and the v output, so each
// neighbour load serves both components' contractions and each coefficient
// is read once per cell. One template step kernel, instantiated for the two
// contraction functors (BGridLap, CTapLap in vec_step.cuh, shared with the
// ring step kernels of ring_pass.cu, as is the recurrence vec_step_cell()),
// three step kinds, float and double. Batch rides
// gridDim.z. Neighbour reads come through L1/L2.
//
// Bound: memory. A MIDDLE step of the 2400x3600 float32 headline reads t,
// t_prev, acc (2 planes each) and the coefficients, and writes t_next and acc
// (2 planes each): 20 planes of 34.6 MB for the B-grid (~0.21 ms at
// 3.35 TB/s), 28 for the C-grid taps (~0.29 ms). ~2 flops per coefficient
// and cell plus 8 for the recurrence are ~2-3 us at 67 TFLOP/s. The whole
// filter needs only one read of u, v and the coefficients and one write of
// the result (14 planes, ~0.14 ms, B-grid; 22 planes, ~0.23 ms, C-grid);
// closing that gap is the job of temporal blocking, the fused entries below.
//
// Fused entries vec_fused_pass_f32/f64: S <= 16 of these steps per launch on
// shared-memory tiles (vec_tile.cuh: a (by+2H) x (bx+2H) window of the raw
// state of both components and of every coefficient plane, periodic in both
// axes with its corners, step j on the window shrunk by j, acc of the own
// tile in shared memory; the contraction and zap are compile-time modes;
// batch in gridDim.z, one coefficient tensor for every batch entry), as the
// TPU kernel does in VMEM. One launch computes steps start+1 .. start+n_ops of
// the filter: the first pass reads w, a later one t, t_prev and acc; a pass
// that does not end the filter writes t_out, t_prev_out (never t or t_prev:
// tiles read their neighbours' cells) and acc, the last one only acc. A
// filter of n steps is then one launch per planned pass
// (ops/cuda/vec_pass.py::plan_vec_fused_passes), and each result equals the
// chain of the step entry's launches bit for bit. Bound of a fused pass:
// issue (vec_tile.cuh); per pass device memory moves the n_coef coefficient
// planes and 2 (first) or 6 (later) state planes in, 6
// (or, last, 2) out, plus the halos. The step entry stays for fields smaller
// than a tile and its halo, and as what the fused pass is checked against.
//
// Windowed local entries (vec_local_pass_f32/f64): the same step on a
// halo-extended shard block, the per-shard compute of the sharded vector
// engine. They replace the local use of the same two TPU kernels
// (gcm_filters_tpu/parallel/sharded.py::make_sharded_vector_apply builds
// build_vec_pass / build_ctap_pass over the extended, padded local block). A
// rank holds an (ly, lx) core block; one halo exchange per round extends the
// carries by `c` cells on each side to (ey, ex) = (ly+2c, lx+2c); the halos
// carry the periodic wrap, so the block has no wrap: every neighbour offset is
// a constant of the pitch (n = +ex, s = -ex, e = +1, w = -1, nw = +ex-1,
// se = -ex+1). The diagonal taps read the halo's corner cells from the first
// step on. Step j of a round (j = 1..n_ops <= c) computes only the WINDOW of
// the block shrunk by `w0 = j` cells on each side, reads one cell further out
// and never outside the block; nothing outside the window is written. No row
// or lane padding, and no periodic roll that lets garbage creep into the halo
// as the TPU version does. State and t_next are extended (batch, 2, ey, ex),
// the coefficients (n_coef, ey, ex), acc is core-shaped (batch, 2, ly, lx)
// with its own pitch:
//   FIRST  : w is the extended input T_0 (vector grids have no mask, area or
//            pre, so there is no separate T_0 output); on the window (w0 = 1)
//            t_next = T1 = -w + 0.5*lap'(w); on the core acc = p_a*w + p_b*T1
//   MIDDLE : on the window t_next = -2t + lap'(t) - t_prev (t_next may be the
//            t_prev buffer); on the core acc += p_a*t_next
//   LAST   : the window is the core (w0 = c): acc += p_a*(-2t + lap'(t) - t_prev)
// Bound: memory, as for the periodic entries, on windows of up to
// (1 + 2c/ly)(1 + 2c/lx) cells per core cell: a MIDDLE step of the headline on
// one rank (c = 11, block 2422x3622) moves ~20 (B-grid) or ~28 (C-grid)
// planes of 34.6-35.1 MB.
//
// Fused local entries (vec_local_fused_pass_f32/f64): a whole round, or a
// part of it, per launch on the shared-memory tiles of vec_tile.cuh, with the
// geometry RoundGeo in place of the periodic wrap; they replace the local use
// of the TPU kernels as one call per round (gcm_filters_tpu/parallel/
// sharded.py::_local_pallas_2d builds build_vec_pass / build_ctap_pass over
// the extended block with plan.steps = rounds). One launch runs steps
// start+1 .. start+n_ops of the filter, round steps s-n_ops+1 .. s where s is
// its `shrink`: tiles cover the block shrunk by s, a tile's window reaches
// n_ops cells further, onto the block shrunk by s - n_ops, on which the
// carries it reads are exact; the window's corners come from the exchange's
// second phase. A round of n steps is then one launch (s = c) or several
// with no exchange between them (s = c - the round's steps still to run
// after this launch), as ops/cuda/vec_local_pass.py::plan_vec_local_rounds
// plans it. Cells outside the core step the carries and touch no acc. Each
// result equals the chain of the windowed local step launches bit for bit.
// Bound, as for the periodic fused pass: issue; per launch device memory
// moves the n_coef coefficient planes and 2 (first) or 6
// (later) state planes of the window in, 6 (or, last, 2) out, on a block
// (1 + 2(c-s)/ly)(1 + 2(c-s)/lx) times the core.
//
// Build without --use_fast_math: it breaks the NaN test in nan_to_num.

#include "vec_tile.cuh"

namespace {

template <typename T, typename OP, int KIND>
__global__ void vec_pass_kernel(const VecArgs<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny;
  const int64_t P = (int64_t)ny * nx;
  const int64_t bu = (int64_t)blockIdx.z * 2 * P;  // this entry's u plane
  const int64_t bv = bu + P;                       // and its v plane

  const int jn = j + 1 < ny ? j + 1 : 0;
  const int js = j > 0 ? j - 1 : ny - 1;
  const int ie = i + 1 < nx ? i + 1 : 0;
  const int iw = i > 0 ? i - 1 : nx - 1;
  Nbr x;
  x.c = (int64_t)j * nx + i;
  x.n = (int64_t)jn * nx + i;
  x.s = (int64_t)js * nx + i;
  x.e = (int64_t)j * nx + ie;
  x.w = (int64_t)j * nx + iw;
  x.nw = (int64_t)jn * nx + iw;
  x.se = (int64_t)js * nx + ie;

  T lu, lv;
  OP::apply(a.coef, P, x, Gather<T>{(KIND == FIRST ? a.w : a.t) + bu, P, a.zap}, lu, lv);
  vec_step_cell<T, KIND>(a, bu + x.c, bv + x.c, bu + x.c, bv + x.c, true, lu, lv);
}

template <typename T, typename OP>
void launch_kind(int kind, dim3 grid, dim3 block, cudaStream_t st, const VecArgs<T>& a) {
  switch (kind) {
    case FIRST: vec_pass_kernel<T, OP, FIRST><<<grid, block, 0, st>>>(a); break;
    case MIDDLE: vec_pass_kernel<T, OP, MIDDLE><<<grid, block, 0, st>>>(a); break;
    default: vec_pass_kernel<T, OP, LAST><<<grid, block, 0, st>>>(a); break;
  }
}

template <typename T>
int launch(int op, int kind, int batch, int ny, int nx, const T* w, const T* t,
           const T* t_prev, T* t_next, T* acc, const T* coef, double p_a, double p_b,
           int zap, void* stream) {
  cudaGetLastError();  // clear a stale error so the result below is this launch's
  if (batch < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  if (kind != FIRST && kind != MIDDLE && kind != LAST) return (int)cudaErrorInvalidValue;
  if (op != BGRID && op != CTAP) return (int)cudaErrorInvalidValue;
  VecArgs<T> a;
  a.ny = ny; a.nx = nx;
  a.w = w; a.t = t; a.t_prev = t_prev; a.t_next = t_next; a.acc = acc; a.coef = coef;
  a.p_a = T(p_a); a.p_b = T(p_b);
  a.zap = zap;
  const dim3 block(32, 8);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == BGRID) launch_kind<T, BGridLap>(kind, grid, block, st, a);
  else launch_kind<T, CTapLap>(kind, grid, block, st, a);
  return (int)cudaGetLastError();
}

template <typename T>
struct LocalArgs {
  int ey, ex;       // extended block
  int c;            // halo cells: the core is [c, ey-c) x [c, ex-c)
  int w0;           // the window is [w0, ey-w0) x [w0, ex-w0)
  const T* w;       // T_0, the extended stacked input (FIRST)
  const T* t;       // T_k, extended (MIDDLE, LAST)
  const T* t_prev;  // T_{k-1}, extended (MIDDLE, LAST)
  T* t_next;        // T_{k+1}, extended (FIRST, MIDDLE); may alias t_prev
  T* acc;           // running sum, core-shaped, updated in place
  const T* coef;    // (n_coef, ey, ex), extended and pre-scaled
  T p_a, p_b;
  int zap;
};

template <typename T, typename OP, int KIND>
__global__ void vec_local_pass_kernel(const LocalArgs<T> a) {
  const int i = a.w0 + blockIdx.x * blockDim.x + threadIdx.x;
  const int j = a.w0 + blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.ex - a.w0 || j >= a.ey - a.w0) return;
  const int ex = a.ex, ey = a.ey, c = a.c;
  const int64_t P = (int64_t)ey * ex;
  const int64_t bu = (int64_t)blockIdx.z * 2 * P;  // this entry's extended u plane
  const int64_t bv = bu + P;                       // and its v plane

  // inside the window (w0 >= 1) every neighbour lies inside the block: no wrap
  Nbr x;
  x.c = (int64_t)j * ex + i;
  x.n = x.c + ex;
  x.s = x.c - ex;
  x.e = x.c + 1;
  x.w = x.c - 1;
  x.nw = x.c + ex - 1;
  x.se = x.c - ex + 1;

  T lu, lv;
  OP::apply(a.coef, P, x, Gather<T, true>{(KIND == FIRST ? a.w : a.t) + bu, P, a.zap}, lu,
            lv);
  const int64_t k = x.c;

  const bool in_core = i >= c && i < ex - c && j >= c && j < ey - c;  // LAST: the window is the core
  const int lx = ex - 2 * c;
  const int64_t Pc = (int64_t)(ey - 2 * c) * lx;
  const int64_t ku = (int64_t)blockIdx.z * 2 * Pc + (int64_t)(j - c) * lx + (i - c);
  vec_step_cell<T, KIND>(a, bu + k, bv + k, ku, ku + Pc, in_core, lu, lv);
}

template <typename T, typename OP>
void launch_local_kind(int kind, dim3 grid, dim3 block, cudaStream_t st,
                       const LocalArgs<T>& a) {
  switch (kind) {
    case FIRST: vec_local_pass_kernel<T, OP, FIRST><<<grid, block, 0, st>>>(a); break;
    case MIDDLE: vec_local_pass_kernel<T, OP, MIDDLE><<<grid, block, 0, st>>>(a); break;
    default: vec_local_pass_kernel<T, OP, LAST><<<grid, block, 0, st>>>(a); break;
  }
}

template <typename T>
int launch_local(int op, int kind, int batch, int ey, int ex, int cells, int shrink,
                 const T* w, const T* t, const T* t_prev, T* t_next, T* acc,
                 const T* coef, double p_a, double p_b, int zap, void* stream) {
  cudaGetLastError();  // clear a stale error so the result below is this launch's
  if (batch < 1 || cells < 1 || shrink < 1 || shrink > cells) return (int)cudaErrorInvalidValue;
  if (ey <= 2 * cells || ex <= 2 * cells) return (int)cudaErrorInvalidValue;
  if (kind != FIRST && kind != MIDDLE && kind != LAST) return (int)cudaErrorInvalidValue;
  if (op != BGRID && op != CTAP) return (int)cudaErrorInvalidValue;
  LocalArgs<T> a;
  a.ey = ey; a.ex = ex; a.c = cells;
  a.w0 = kind == FIRST ? 1 : kind == LAST ? cells : shrink;
  a.w = w; a.t = t; a.t_prev = t_prev; a.t_next = t_next; a.acc = acc; a.coef = coef;
  a.p_a = T(p_a); a.p_b = T(p_b);
  a.zap = zap;
  const int wy = ey - 2 * a.w0, wx = ex - 2 * a.w0;
  const dim3 block(32, 8);
  const dim3 grid((wx + 31) / 32, (wy + 7) / 8, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == BGRID) launch_local_kind<T, BGridLap>(kind, grid, block, st, a);
  else launch_local_kind<T, CTapLap>(kind, grid, block, st, a);
  return (int)cudaGetLastError();
}

}  // namespace

#define VEC_PASS_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(int op, int kind, int batch, int ny, int nx, const T* w,       \
                      const T* t, const T* t_prev, T* t_next, T* acc, const T* coef, \
                      double p_a, double p_b, int zap, void* stream) {               \
    return launch<T>(op, kind, batch, ny, nx, w, t, t_prev, t_next, acc, coef, p_a,  \
                     p_b, zap, stream);                                              \
  }

VEC_PASS_ENTRY(vec_pass_f32, float)
VEC_PASS_ENTRY(vec_pass_f64, double)

#define VEC_LOCAL_PASS_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(int op, int kind, int batch, int ey, int ex, int cells,          \
                      int shrink, const T* w, const T* t, const T* t_prev, T* t_next,  \
                      T* acc, const T* coef, double p_a, double p_b, int zap,          \
                      void* stream) {                                                  \
    return launch_local<T>(op, kind, batch, ey, ex, cells, shrink, w, t, t_prev,       \
                           t_next, acc, coef, p_a, p_b, zap, stream);                  \
  }

VEC_LOCAL_PASS_ENTRY(vec_local_pass_f32, float)
VEC_LOCAL_PASS_ENTRY(vec_local_pass_f64, double)

// One fused pass: steps start+1 .. start+n_ops of the filter, where the
// caller says whether the pass begins with FIRST (`first`: reads w) and ends
// with LAST (`last`: writes only acc_out). pa[i] is p_a of the pass's i-th
// step, p_b that of FIRST. acc_in may be acc_out.
#define VEC_FUSED_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(int op, int batch, int ny, int nx, int by, int bx, int n_ops,       \
                      int first, int last, const double* pa, double p_b, const T* w,      \
                      const T* t, const T* t_prev, const T* acc_in, T* t_out,             \
                      T* t_prev_out, T* acc_out, const T* coef, int zap, void* stream) {  \
    cudaGetLastError();                                                                   \
    const VecFusedArgs<T> a = vec_fused_args<T>(by, bx, n_ops, first, last, pa, p_b, w,   \
                                                t, t_prev, acc_in, t_out, t_prev_out,     \
                                                acc_out, coef);                           \
    const WrapGeo g{ny, nx, 0};                                                           \
    return launch_vec_fused<T>(op, zap, a, g, ny, nx, batch,                              \
                               static_cast<cudaStream_t>(stream));                        \
  }

VEC_FUSED_ENTRY(vec_fused_pass_f32, float)
VEC_FUSED_ENTRY(vec_fused_pass_f64, double)

// One fused launch of the sharded engine's local round: steps start+1 ..
// start+n_ops of the filter on the extended block (ly+2*cells, lx+2*cells),
// on tiles of by x bx cells of the block shrunk by `shrink` (n_ops <= shrink
// <= cells; cells the core). It reads w (first) or t and t_prev, extended and
// exact on the block shrunk by shrink - n_ops, and acc_in (core-shaped);
// unless `last`, it writes the carries on the block shrunk by `shrink` into
// the extended t_out and t_prev_out, which must not alias t or t_prev, and
// acc_out (core-shaped; acc_in may be acc_out).
#define VEC_LOCAL_FUSED_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(int op, int batch, int ly, int lx, int cells, int shrink, int by, \
                      int bx, int n_ops, int first, int last, const double* pa,          \
                      double p_b, const T* w, const T* t, const T* t_prev,               \
                      const T* acc_in, T* t_out, T* t_prev_out, T* acc_out,              \
                      const T* coef, int zap, void* stream) {                            \
    cudaGetLastError();                                                                  \
    if (ly < 1 || lx < 1 || n_ops < 1 || shrink < n_ops || shrink > cells)               \
      return (int)cudaErrorInvalidValue;                                                 \
    const VecFusedArgs<T> a = vec_fused_args<T>(by, bx, n_ops, first, last, pa, p_b, w,  \
                                                t, t_prev, acc_in, t_out, t_prev_out,    \
                                                acc_out, coef);                          \
    const RoundGeo g{ly, lx, cells, shrink};                                             \
    return launch_vec_fused<T>(op, zap, a, g, g.rows(), g.cols(), batch,                 \
                               static_cast<cudaStream_t>(stream));                       \
  }

VEC_LOCAL_FUSED_ENTRY(vec_local_fused_pass_f32, float)
VEC_LOCAL_FUSED_ENTRY(vec_local_fused_pass_f64, double)

extern "C" const char* vec_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
