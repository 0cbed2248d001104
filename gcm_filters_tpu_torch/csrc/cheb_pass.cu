// One step of the scalar Chebyshev filter recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel gcm_filters_tpu/ops/pallas/cheb_pass.py::_build_pass_call
// (kernel body `kernel`, built by build_cheb_pass): the fused, end-fused
// scalar Chebyshev pass. This file ports WHAT that kernel computes, not its
// TPU layout (no lane-tail wrap, no VMEM blocks, no strip views).
//
// With coefficients pre-scaled on the host, X' = -2*lap_scale*X, and
//   g       = [pre *] (zap ? nan_to_num(t) : t)
//   lap'(t) = [post *] (c'g + n'g_N + s'g_S + e'g_E + w'g_W)
// (x periodic; y periodic, or with `fold` the north neighbour of the top
// row at column i is the top row at column nx-1-i), one launch computes:
//   FIRST  : fbar = field[*area]; h = drop_pre ? post*nan_to_num(fbar) : fbar
//            T1 = -h + 0.5*lap'(h); acc = p_a*h + p_b*T1
//            writes h, T1 (t_next) and acc
//   MIDDLE : t_next = -2t + lap'(t) - t_prev; acc += p_a*t_next
//            t_next may be the t_prev buffer (updated in place), acc is
//            updated in place
//   LAST   : acc += p_a*(-2t + lap'(t) - t_prev); then, under drop_pre,
//            acc = post == 0 ? land_gain*fbar : acc + 0*fbar (the 0*fbar
//            keeps a NaN at a wet cell NaN); then acc /= area.
//            acc is updated in place and holds the result.
//
// Design: one thread per cell, one launch per Chebyshev step; the four
// neighbour reads come through L1/L2. The per-cell arithmetic (gathered(),
// step_cell()) lives in cheb_step.cuh, shared with the ring step kernel
// (ring_pass.cu); a thread gathers its five values first, then steps. Batch rides gridDim.z; coefficients
// are shared by every batch entry. Constant coefficients arrive as
// immediates (null pointer + value).
//
// Bound of a step: memory. A middle step of the 2400x3600 float32 tripolar headline
// reads t, t_prev, acc, c', post and writes t_next, acc: 7 arrays of 34.6 MB,
// about 72 us at 3.35 TB/s; ~15 flops per cell are ~2 us at 67 TFLOP/s.
// The whole 11-step filter needs only one read of field, c, post, area and
// one write of the result (~173 MB, ~0.05 ms); closing that gap is the job of
// temporal blocking, the fused entries below.
//
// The fused entries cheb_fused_pass_f32/f64 run S <= 16 of these steps per
// launch on shared-memory tiles (cheb_tile.cuh, WrapGeo: x periodic, y
// periodic or folded, batch in gridDim.z, constant coefficients as
// immediates), as the TPU kernel does in VMEM. A filter of n steps is then a
// few launches, one per planned pass (ops/cuda/cheb_pass.py::
// plan_fused_passes), and each result equals the chain of the step entry's
// launches bit for bit. Bound of a fused pass: issue in its steps (see
// cheb_tile.cuh); the step entry stays for fields smaller than a tile and its
// halo, and as what the fused pass is checked against.
//
// Build without --use_fast_math: it breaks the NaN test in nan_to_num and the
// 0*fbar NaN poison.

#include "cheb_tile.cuh"

namespace {

template <typename T, int KIND>
__global__ void cheb_pass_kernel(const Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny;
  const int64_t b = (int64_t)blockIdx.z * ny * nx;
  const int64_t k = (int64_t)j * nx + i;

  int64_t kn;
  if (j + 1 < ny) kn = k + nx;
  else if (a.fold) kn = (int64_t)j * nx + (nx - 1 - i);
  else kn = i;
  const int64_t ks = j > 0 ? k - nx : (int64_t)(ny - 1) * nx + i;
  const int64_t ke = i + 1 < nx ? k + 1 : (int64_t)j * nx;
  const int64_t kw = i > 0 ? k - 1 : (int64_t)j * nx + nx - 1;

  step_cell<T, KIND>(a, b, k, gathered<T, KIND>(a, b, k), gathered<T, KIND>(a, b, kn),
                     gathered<T, KIND>(a, b, ks), gathered<T, KIND>(a, b, ke),
                     gathered<T, KIND>(a, b, kw));
}

template <typename T>
int launch(int kind, int batch, int ny, int nx, const T* field, const T* t,
           const T* t_prev, T* t_next, T* acc, T* h, const T* c, const T* n,
           const T* s, const T* e, const T* w, double cv, double nv, double sv,
           double ev, double wv, const T* pre, const T* post, const T* area,
           double p_a, double p_b, double land_gain, int zap, int fold,
           int drop_pre, void* stream) {
  cudaGetLastError();  // clear a stale error so the result below is this launch's
  if (batch < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.ny = ny; a.nx = nx;
  a.field = field; a.t = t; a.t_prev = t_prev; a.t_next = t_next; a.acc = acc; a.h = h;
  a.coef[0] = c; a.coef[1] = n; a.coef[2] = s; a.coef[3] = e; a.coef[4] = w;
  a.cval[0] = T(cv); a.cval[1] = T(nv); a.cval[2] = T(sv); a.cval[3] = T(ev); a.cval[4] = T(wv);
  a.pre = pre; a.post = post; a.area = area;
  a.p_a = T(p_a); a.p_b = T(p_b); a.land_gain = T(land_gain);
  a.zap = zap; a.fold = fold; a.drop_pre = drop_pre;
  const dim3 block(32, 8);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case FIRST: cheb_pass_kernel<T, FIRST><<<grid, block, 0, st>>>(a); break;
    case MIDDLE: cheb_pass_kernel<T, MIDDLE><<<grid, block, 0, st>>>(a); break;
    case LAST: cheb_pass_kernel<T, LAST><<<grid, block, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define CHEB_PASS_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(int kind, int batch, int ny, int nx, const T* field,        \
                      const T* t, const T* t_prev, T* t_next, T* acc, T* h,       \
                      const T* c, const T* n, const T* s, const T* e, const T* w, \
                      double cv, double nv, double sv, double ev, double wv,      \
                      const T* pre, const T* post, const T* area, double p_a,     \
                      double p_b, double land_gain, int zap, int fold,            \
                      int drop_pre, void* stream) {                               \
    return launch<T>(kind, batch, ny, nx, field, t, t_prev, t_next, acc, h, c, n, \
                     s, e, w, cv, nv, sv, ev, wv, pre, post, area, p_a, p_b,      \
                     land_gain, zap, fold, drop_pre, stream);                     \
  }

CHEB_PASS_ENTRY(cheb_pass_f32, float)
CHEB_PASS_ENTRY(cheb_pass_f64, double)

// One fused pass: steps start+1 .. start+n_ops of the filter, where the
// caller says whether the pass begins with FIRST (`first`: reads the raw
// field) and ends with LAST (`last`: writes only the result into acc_out).
// pa[i] is p_a of the pass's i-th step, p_b that of FIRST. The carries of a
// pass that does not end the filter go to t_out and t_prev_out, which must
// not alias t or t_prev (tiles read their neighbours' cells); acc_in may be
// acc_out. `regs`: the pass takes the register steps where they fit
// (cheb_tile.cuh, reg_path).
#define CHEB_FUSED_ENTRY(NAME, T)                                                       \
  extern "C" int NAME(int batch, int ny, int nx, int by, int bx, int n_ops, int first,  \
                      int last, const double* pa, double p_b, const T* field,           \
                      const T* t, const T* t_prev, const T* acc_in, T* t_out,           \
                      T* t_prev_out, T* acc_out, const T* c, const T* n, const T* s,    \
                      const T* e, const T* w, double cv, double nv, double sv,          \
                      double ev, double wv, const T* pre, const T* post, const T* area, \
                      double land_gain, int zap, int fold, int drop_pre, int regs,       \
                      void* stream) {                                                   \
    cudaGetLastError();                                                                 \
    if (ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;                           \
    const FusedArgs<T> a = fused_args<T>(by, bx, n_ops, first, last, pa, p_b, field,    \
                                         field, t, t_prev, acc_in, t_out, t_prev_out,   \
                                         acc_out, c, n, s, e, w, cv, nv, sv, ev, wv,    \
                                         pre, post, area, land_gain, zap, drop_pre,     \
                                         regs);                                         \
    const WrapGeo g{ny, nx, fold};                                                      \
    return launch_fused<T>(a, g, ny, nx, batch, static_cast<cudaStream_t>(stream));     \
  }

CHEB_FUSED_ENTRY(cheb_fused_pass_f32, float)
CHEB_FUSED_ENTRY(cheb_fused_pass_f64, double)

extern "C" const char* cheb_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
