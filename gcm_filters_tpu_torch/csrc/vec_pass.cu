// One step of the coupled vector Chebyshev filter recurrence, for Hopper (sm_90a):
// periodic entries on a whole field (vec_pass_f32/f64) and windowed local
// entries on a halo-extended shard block (vec_local_pass_f32/f64, below).
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
// the result; closing that gap is the job of temporal blocking (several steps
// per launch on shared-memory tiles with a halo), which is later work.
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
// Build without --use_fast_math: it breaks isnan/isinf in nan_to_num.

#include "vec_step.cuh"

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
  OP::apply(a.coef, P, x, Gather<T>{(KIND == FIRST ? a.w : a.t) + bu, P, a.zap}, lu, lv);
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

extern "C" const char* vec_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
