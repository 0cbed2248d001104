// One step of the coupled vector Chebyshev filter recurrence, for Hopper (sm_90a).
//
// Replaces the two TPU kernels built by
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
// contraction functors, three step kinds, float and double. Batch rides
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
// Build without --use_fast_math: it breaks isnan/isinf in nan_to_num.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Kind { FIRST = 0, MIDDLE = 1, LAST = 2 };
enum Op { BGRID = 0, CTAP = 1 };

template <typename T> struct Lim;
template <> struct Lim<float> { static __device__ __forceinline__ float max() { return FLT_MAX; } };
template <> struct Lim<double> { static __device__ __forceinline__ double max() { return DBL_MAX; } };

// torch.nan_to_num / jnp.nan_to_num: NaN -> 0, +-inf -> +-largest finite.
template <typename T>
__device__ __forceinline__ T nan_to_num(T x) {
  if (isnan(x)) return T(0);
  if (isinf(x)) return x > T(0) ? Lim<T>::max() : -Lim<T>::max();
  return x;
}

template <typename T>
struct Args {
  int ny, nx;
  const T* w;       // T_0, the stacked input (FIRST)
  const T* t;       // T_k (MIDDLE, LAST)
  const T* t_prev;  // T_{k-1} (MIDDLE, LAST)
  T* t_next;        // T_{k+1} (FIRST, MIDDLE); may alias t_prev
  T* acc;           // running sum, updated in place
  const T* coef;    // (n_coef, ny, nx), pre-scaled
  T p_a, p_b;
  int zap;
};

// Plane offsets of a cell's neighbours, periodic on both axes.
struct Nbr {
  int64_t c, n, s, e, w, nw, se;
};

// The contraction input of component `comp` at plane offset `k`.
template <typename T>
struct Gather {
  const T* src;  // this batch entry's u plane; v follows one plane later
  int64_t plane;
  int zap;
  __device__ __forceinline__ T operator()(int comp, int64_t k) const {
    const T x = src[comp * plane + k];
    return zap ? nan_to_num(x) : x;
  }
};

// B-grid (_bgrid_lap): diffusion 5-point set on each component plus the
// mixing 5-point set of the other component.
struct BGridLap {
  template <typename T, typename G>
  static __device__ __forceinline__ void apply(const T* c, int64_t P, const Nbr& x,
                                               const G& g, T& lu, T& lv) {
    const T u0 = g(0, x.c), uN = g(0, x.n), uS = g(0, x.s), uE = g(0, x.e), uW = g(0, x.w);
    const T v0 = g(1, x.c), vN = g(1, x.n), vS = g(1, x.s), vE = g(1, x.e), vW = g(1, x.w);
    const T cc = c[0 * P + x.c], dn = c[1 * P + x.c], ds = c[2 * P + x.c],
            de = c[3 * P + x.c], dw = c[4 * P + x.c];
    const T mc = c[5 * P + x.c], mn = c[6 * P + x.c], ms = c[7 * P + x.c],
            me = c[8 * P + x.c], mw = c[9 * P + x.c];
    const T diff_u = cc * u0 + dn * uN + ds * uS + de * uE + dw * uW;
    const T diff_v = cc * v0 + dn * vN + ds * vS + de * vE + dw * vW;
    const T mix_u = mc * u0 + mn * uN + ms * uS + me * uE + mw * uW;
    const T mix_v = mc * v0 + mn * vN + ms * vS + me * vE + mw * vW;
    lu = diff_u + mix_v;  // u picks up S_mix(v)
    lv = diff_v + mix_u;  // v picks up S_mix(u)
  }
};

// C-grid taps (_ctap_lap), coefficient planes in CTAPS order.
struct CTapLap {
  template <typename T, typename G>
  static __device__ __forceinline__ void apply(const T* c, int64_t P, const Nbr& x,
                                               const G& g, T& lu, T& lv) {
    const T u0 = g(0, x.c), uW = g(0, x.w), uE = g(0, x.e), uS = g(0, x.s), uN = g(0, x.n);
    const T uNW = g(0, x.nw);  // u[j+1, i-1]
    const T v0 = g(1, x.c), vW = g(1, x.w), vE = g(1, x.e), vS = g(1, x.s), vN = g(1, x.n);
    const T vSE = g(1, x.se);  // v[j-1, i+1]
    const int64_t k = x.c;
    lu = c[0 * P + k] * u0 + c[1 * P + k] * uW + c[2 * P + k] * uE + c[3 * P + k] * uS +
         c[4 * P + k] * uN + c[5 * P + k] * v0 + c[6 * P + k] * vS + c[7 * P + k] * vE +
         c[8 * P + k] * vSE;
    lv = c[9 * P + k] * v0 + c[10 * P + k] * vW + c[11 * P + k] * vE + c[12 * P + k] * vS +
         c[13 * P + k] * vN + c[14 * P + k] * u0 + c[15 * P + k] * uW + c[16 * P + k] * uN +
         c[17 * P + k] * uNW;
  }
};

template <typename T, typename OP, int KIND>
__global__ void vec_pass_kernel(const Args<T> a) {
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
  const int64_t k = x.c;

  if (KIND == FIRST) {
    const T u0 = a.w[bu + k], v0 = a.w[bv + k];  // raw values
    const T tu = -u0 + T(0.5) * lu;
    const T tv = -v0 + T(0.5) * lv;
    a.t_next[bu + k] = tu;
    a.t_next[bv + k] = tv;
    a.acc[bu + k] = a.p_a * u0 + a.p_b * tu;
    a.acc[bv + k] = a.p_a * v0 + a.p_b * tv;
    return;
  }
  const T nu = T(-2) * a.t[bu + k] + lu - a.t_prev[bu + k];
  const T nv = T(-2) * a.t[bv + k] + lv - a.t_prev[bv + k];
  if (KIND == MIDDLE) {
    // in place over t_prev: only this cell read it
    a.t_next[bu + k] = nu;
    a.t_next[bv + k] = nv;
  }
  a.acc[bu + k] = a.acc[bu + k] + a.p_a * nu;  // in place
  a.acc[bv + k] = a.acc[bv + k] + a.p_a * nv;
}

template <typename T, typename OP>
void launch_kind(int kind, dim3 grid, dim3 block, cudaStream_t st, const Args<T>& a) {
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
  Args<T> a;
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

extern "C" const char* vec_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
