// One step of the scalar Chebyshev recurrence on a halo-extended local block,
// for Hopper (sm_90a): the per-shard compute of the sharded engine.
//
// Replaces the TPU kernel gcm_filters_tpu/ops/pallas/cheb_pass.py::build_local_pass
// (the `_build_pass_call` kernel body with runtime coefficients, no fold and
// fused ends, as parallel/sharded.py::local_pallas_rounds_scalar drives it).
// This file ports WHAT that kernel computes, not its TPU layout: no row
// padding to a block height, no lane padding, no packed coefficient stream,
// and no periodic roll that lets garbage creep into the halo.
//
// A rank holds an (ly, lx) core block. One halo exchange per round extends the
// carries by `c` cells on each side to (ey, ex) = (ly+2c, lx+2c); the halos
// carry the periodic wrap and the tripolar seam, so the block has no wrap and
// no fold. Step j of a round (j = 1..n_ops <= c) computes only the WINDOW of
// the block shrunk by `w0 = j` cells on each side, reading t one cell further
// out (valid: the exchange for j = 1, step j-1 for j > 1) and never outside
// the block. After the round the core [c, c+ly) x [c, c+lx) is exact.
//
// Extended planes (pitch ex): field (FIRST), t, t_prev, t_next, h, the
// coefficient planes c,n,s,e,w (pre-scaled, X' = -2*lap_scale*X; null ->
// immediate) and pre, post, area. Core planes (pitch lx): acc, and the
// caller's own raw field (LAST). With
//   g       = [pre *] (zap ? nan_to_num(t) : t)
//   lap'(t) = [post *] (c'g + n'g_N + s'g_S + e'g_E + w'g_W)
// one launch computes:
//   FIRST  : on the WHOLE block h = T_0 = drop_pre ? post*nan_to_num(field*area)
//            : field*area; on the window (w0 = 1) T1 = -h + 0.5*lap'(h), where
//            the neighbours' T_0 are recomputed from field; on the core
//            acc = p_a*h + p_b*T1. Writes h, T1 (t_next) and acc.
//   MIDDLE : on the window t_next = -2t + lap'(t) - t_prev; on the core
//            acc += p_a*t_next. t_next may be the t_prev buffer (each cell
//            reads t_prev only at itself).
//   LAST   : the window is the core (w0 = c):
//            acc += p_a*(-2t + lap'(t) - t_prev); then, under drop_pre, with
//            fbar = field*area, acc = post == 0 ? land_gain*fbar : acc + 0*fbar
//            (the 0*fbar keeps a NaN at a wet cell NaN); then acc /= area.
//
// Design: one thread per window cell, one launch per step; the four neighbour
// reads come through L1/L2. Batch rides gridDim.z; the coefficient planes are
// shared by every batch entry. The per-cell arithmetic is the value functions
// of cheb_step.cuh, with every rounding spelled out, as in the unsharded step
// kernel.
//
// Bound: memory. A MIDDLE step of the 2400x3600 float32 tripolar headline on
// one rank (c = 11, block 2422x3622) reads t, t_prev, c', post on the window,
// acc on the core, and writes t_next and acc: 7 planes of ~35 MB, ~73 us at
// 3.35 TB/s; ~15 flops per cell are ~2 us at 67 TFLOP/s. The shrinking
// windows are the redundant trapezoid work of wide halos: (1 + 2c/l)^2 cells
// per core cell at most.
//
// The fused entries local_fused_pass_f32/f64 run a whole round (n_ops <= c
// steps) in one launch on shared-memory tiles of the core (cheb_tile.cuh,
// BlockGeo: no wrap, no fold), reading the extended planes and writing the
// carries into the core of extended output buffers, so the next round's
// exchange reads them as it reads the step chain's. Their result equals the
// chain of this file's step launches bit for bit.
//
// Build without --use_fast_math: it breaks the NaN test in nan_to_num and the
// 0*fbar NaN poison.

#include "cheb_tile.cuh"

namespace {

template <typename T>
struct LocalArgs {
  int ey, ex;       // extended block
  int c;            // halo cells: the core is [c, ey-c) x [c, ex-c)
  int w0;           // the window is [w0, ey-w0) x [w0, ex-w0)
  const T* field;   // FIRST: raw extended field; LAST: raw core field
  const T* t;       // T_k, extended (MIDDLE, LAST)
  const T* t_prev;  // T_{k-1}, extended (MIDDLE, LAST)
  T* t_next;        // T_{k+1}, extended (FIRST, MIDDLE); may alias t_prev
  T* acc;           // running sum, core-shaped, updated in place
  T* h;             // T_0 output, extended (FIRST)
  const T* coef[5]; // c, n, s, e, w (pre-scaled), extended; null -> cval
  T cval[5];
  const T* pre;     // extended
  const T* post;    // extended
  const T* area;    // extended
  T p_a, p_b, land_gain;
  int zap, drop_pre;
};

// T_0 at extended plane offset `k` (batch base `b`), from the raw field.
template <typename T>
__device__ __forceinline__ T local_t0(const LocalArgs<T>& a, int64_t b, int64_t k) {
  return t0_value(a.field[b + k], a.area != nullptr, at(a.area, k), a.drop_pre != 0,
                  at(a.post, k));
}

// The value the stencil contracts over at extended plane offset `k`.
template <typename T, int KIND>
__device__ __forceinline__ T local_gathered(const LocalArgs<T>& a, int64_t b, int64_t k) {
  const T x = KIND == FIRST ? local_t0(a, b, k) : a.t[b + k];
  return gather_value(x, a.zap != 0, a.pre != nullptr, at(a.pre, k));
}

template <typename T>
__device__ __forceinline__ T local_coef(const LocalArgs<T>& a, int m, int64_t k) {
  return a.coef[m] ? a.coef[m][k] : a.cval[m];
}

template <typename T, int KIND>
__global__ void local_pass_kernel(const LocalArgs<T> a) {
  // FIRST covers the whole block (h is needed everywhere); the other kinds
  // cover the window only.
  const int org = KIND == FIRST ? 0 : a.w0;
  const int i = org + blockIdx.x * blockDim.x + threadIdx.x;
  const int j = org + blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.ex - org || j >= a.ey - org) return;
  const int ex = a.ex, ey = a.ey, c = a.c;
  const int64_t b = (int64_t)blockIdx.z * ey * ex;
  const int64_t k = (int64_t)j * ex + i;

  T h = T(0);
  if (KIND == FIRST) {
    h = local_t0(a, b, k);
    a.h[b + k] = h;
    if (i < a.w0 || i >= ex - a.w0 || j < a.w0 || j >= ey - a.w0) return;
  }

  // inside the window every neighbour lies inside the block: no wrap. The
  // five gathered values are loaded first, then the arithmetic runs.
  const T g = local_gathered<T, KIND>(a, b, k);
  const T gn = local_gathered<T, KIND>(a, b, k + ex);
  const T gs = local_gathered<T, KIND>(a, b, k - ex);
  const T ge = local_gathered<T, KIND>(a, b, k + 1);
  const T gw = local_gathered<T, KIND>(a, b, k - 1);
  const T lap = lap_value(local_coef(a, 0, k), local_coef(a, 1, k), local_coef(a, 2, k),
                          local_coef(a, 3, k), local_coef(a, 4, k), g, gn, gs, ge, gw,
                          a.post != nullptr, at(a.post, k));

  const bool in_core = i >= c && i < ex - c && j >= c && j < ey - c;
  const int lx = ex - 2 * c;
  const int64_t kc = (int64_t)blockIdx.z * (ey - 2 * c) * lx + (int64_t)(j - c) * lx + (i - c);

  if (KIND == FIRST) {
    const T t1 = t1_value(lap, h);
    a.t_next[b + k] = t1;
    if (in_core) a.acc[kc] = acc_first(a.p_a, a.p_b, h, t1);
    return;
  }

  const T nxt = next_value(a.t[b + k], lap, a.t_prev[b + k]);
  if (KIND == MIDDLE) {
    a.t_next[b + k] = nxt;  // in place over t_prev: only this cell read it
    if (in_core) a.acc[kc] = acc_add(a.p_a, nxt, a.acc[kc]);
    return;
  }
  // LAST: the window is the core; the result goes over acc in place
  a.acc[kc] = finish_value(acc_add(a.p_a, nxt, a.acc[kc]), at(a.field, kc),
                           a.area != nullptr, at(a.area, k), a.drop_pre != 0,
                           at(a.post, k), a.land_gain);
}

template <typename T>
int launch(int kind, int batch, int ey, int ex, int cells, int shrink,
           const T* field, const T* t, const T* t_prev, T* t_next, T* acc, T* h,
           const T* c, const T* n, const T* s, const T* e, const T* w, double cv,
           double nv, double sv, double ev, double wv, const T* pre, const T* post,
           const T* area, double p_a, double p_b, double land_gain, int zap,
           int drop_pre, void* stream) {
  cudaGetLastError();  // clear a stale error so the result below is this launch's
  if (batch < 1 || cells < 1 || shrink < 1 || shrink > cells) return (int)cudaErrorInvalidValue;
  if (ey <= 2 * cells || ex <= 2 * cells) return (int)cudaErrorInvalidValue;
  LocalArgs<T> a;
  a.ey = ey; a.ex = ex; a.c = cells;
  a.w0 = kind == LAST ? cells : shrink;
  a.field = field; a.t = t; a.t_prev = t_prev; a.t_next = t_next; a.acc = acc; a.h = h;
  a.coef[0] = c; a.coef[1] = n; a.coef[2] = s; a.coef[3] = e; a.coef[4] = w;
  a.cval[0] = T(cv); a.cval[1] = T(nv); a.cval[2] = T(sv); a.cval[3] = T(ev); a.cval[4] = T(wv);
  a.pre = pre; a.post = post; a.area = area;
  a.p_a = T(p_a); a.p_b = T(p_b); a.land_gain = T(land_gain);
  a.zap = zap; a.drop_pre = drop_pre;
  const int org = kind == FIRST ? 0 : a.w0;
  const int wy = ey - 2 * org, wx = ex - 2 * org;
  const dim3 block(32, 8);
  const dim3 grid((wx + 31) / 32, (wy + 7) / 8, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case FIRST: local_pass_kernel<T, FIRST><<<grid, block, 0, st>>>(a); break;
    case MIDDLE: local_pass_kernel<T, MIDDLE><<<grid, block, 0, st>>>(a); break;
    case LAST: local_pass_kernel<T, LAST><<<grid, block, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define LOCAL_PASS_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(int kind, int batch, int ey, int ex, int cells, int shrink,  \
                      const T* field, const T* t, const T* t_prev, T* t_next,      \
                      T* acc, T* h, const T* c, const T* n, const T* s,            \
                      const T* e, const T* w, double cv, double nv, double sv,     \
                      double ev, double wv, const T* pre, const T* post,           \
                      const T* area, double p_a, double p_b, double land_gain,     \
                      int zap, int drop_pre, void* stream) {                       \
    return launch<T>(kind, batch, ey, ex, cells, shrink, field, t, t_prev, t_next, \
                     acc, h, c, n, s, e, w, cv, nv, sv, ev, wv, pre, post, area,   \
                     p_a, p_b, land_gain, zap, drop_pre, stream);                  \
  }

LOCAL_PASS_ENTRY(local_pass_f32, float)
LOCAL_PASS_ENTRY(local_pass_f64, double)

// One fused round on the extended block: steps start+1 .. start+n_ops of the
// filter (n_ops <= cells) on tiles of by x bx core cells. `first`: the round
// begins with FIRST and reads the raw extended field; `last`: it ends with
// LAST, reconstructs land from the caller's core-shaped field_own, and writes
// only the result into acc_out (core-shaped). Otherwise the carries go into
// the core of the extended t_out and t_prev_out, which must not alias t or
// t_prev; acc_in may be acc_out.
#define LOCAL_FUSED_ENTRY(NAME, T)                                                       \
  extern "C" int NAME(int batch, int ly, int lx, int cells, int by, int bx, int n_ops,   \
                      int first, int last, const double* pa, double p_b, const T* field, \
                      const T* field_own, const T* t, const T* t_prev, const T* acc_in,  \
                      T* t_out, T* t_prev_out, T* acc_out, const T* c, const T* n,       \
                      const T* s, const T* e, const T* w, double cv, double nv,          \
                      double sv, double ev, double wv, const T* pre, const T* post,      \
                      const T* area, double land_gain, int zap, int drop_pre,            \
                      void* stream) {                                                    \
    cudaGetLastError();                                                                  \
    if (ly < 1 || lx < 1 || n_ops > cells) return (int)cudaErrorInvalidValue;           \
    const FusedArgs<T> a = fused_args<T>(by, bx, n_ops, first, last, pa, p_b, field,     \
                                         field_own, t, t_prev, acc_in, t_out,            \
                                         t_prev_out, acc_out, c, n, s, e, w, cv, nv, sv, \
                                         ev, wv, pre, post, area, land_gain, zap,        \
                                         drop_pre);                                      \
    const BlockGeo g{ly, lx, cells};                                                     \
    return launch_fused<T>(a, g, ly, lx, batch, static_cast<cudaStream_t>(stream));      \
  }

LOCAL_FUSED_ENTRY(local_fused_pass_f32, float)
LOCAL_FUSED_ENTRY(local_fused_pass_f64, double)

extern "C" const char* local_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
