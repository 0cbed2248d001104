// The per-cell arithmetic of one coupled vector Chebyshev step, shared by the
// periodic and windowed local step kernels (vec_pass.cu), the ring step
// kernels (ring_pass.cu) and the fused passes of vec_tile.cuh: the two
// contraction functors, and the recurrence, on values (the scalar
// pass's t1_value, acc_first, next_value and acc_add of cheb_step.cuh, which
// round alike). The step kernels differ only in where a neighbour's value
// comes from (the gather functor `G` and the offsets in `Nbr`), the fused
// passes read them from shared memory; what is done with them is written in
// the explicitly rounded arithmetic of common.cuh, so all of them round alike.
#pragma once

#include "cheb_step.cuh"

namespace {

enum Op { BGRID = 0, CTAP = 1 };

template <typename T>
struct VecArgs {
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

// Plane offsets of a cell's neighbours: periodic on both axes in the global
// entries, constants of the pitch in the windowed local entries, and in the
// ring entries offsets below 0 or past the plane for the two halo rows.
struct Nbr {
  int64_t c, n, s, e, w, nw, se;
};

// The contraction inputs of one component around a cell: its own value and
// its north (j+1), south (j-1), east (i+1) and west (i-1) neighbours, and the
// diagonal ones the C-grid taps read (u at j+1, i-1; v at j-1, i+1).
template <typename T>
struct Nb {
  T c, n, s, e, w, nw, se;
};

// The contraction input of component `comp` at plane offset `k`. FAST picks
// the shorter NaN scrub (cheb_step.cuh's scrub), which the windowed local
// kernels run faster with and the periodic and ring kernels slower.
template <typename T, bool FAST = false>
struct Gather {
  const T* src;  // this batch entry's u plane; v follows one plane later
  int64_t plane;
  int zap;
  __device__ __forceinline__ T operator()(int comp, int64_t k) const {
    const T x = src[comp * plane + k];
    return zap ? scrub<FAST>(x) : x;
  }
};

// Each contraction has two forms. `lap` is the arithmetic, on values: the
// gathered neighbour values of both components and an accessor `cf(m)` for
// the cell's m-th coefficient (from shared memory or registers in the fused
// passes). `apply` feeds it from device memory in the one-step kernels: the
// values through the gather functor `g` at the offsets `x`, the coefficients
// from planes of pitch P, read where `lap` uses them (the order the step
// kernels were tuned with).

// B-grid (_bgrid_lap): diffusion 5-point set on each component plus the
// mixing 5-point set of the other component. Coefficients 0..9: cc dun dus
// due duw (diffusion), dmc dmn dms dme dmw (mixing).
struct BGridLap {
  static constexpr int N_COEF = 10;

  // c*f0 + n*fN + s*fS + e*fE + w*fW, summed left to right: the first product
  // is fused onto the second one, which is rounded (as nvcc contracts the plain
  // sum, and 2% faster here than rounding the first)
  template <typename T>
  static __device__ __forceinline__ T s5(T c, T n, T s, T e, T w, T f0, T fN, T fS, T fE,
                                         T fW) {
    return fmad(w, fW, fmad(e, fE, fmad(s, fS, fmad(c, f0, mul(n, fN)))));
  }

  template <typename T, typename CF>
  static __device__ __forceinline__ void lap(const CF& cf, const Nb<T>& u, const Nb<T>& v,
                                             T& lu, T& lv) {
    const T cc = cf(0), dn = cf(1), ds = cf(2), de = cf(3), dw = cf(4);
    const T mc = cf(5), mn = cf(6), ms = cf(7), me = cf(8), mw = cf(9);
    const T diff_u = s5(cc, dn, ds, de, dw, u.c, u.n, u.s, u.e, u.w);
    const T diff_v = s5(cc, dn, ds, de, dw, v.c, v.n, v.s, v.e, v.w);
    const T mix_u = s5(mc, mn, ms, me, mw, u.c, u.n, u.s, u.e, u.w);
    const T mix_v = s5(mc, mn, ms, me, mw, v.c, v.n, v.s, v.e, v.w);
    lu = add(diff_u, mix_v);  // u picks up S_mix(v)
    lv = add(diff_v, mix_u);  // v picks up S_mix(u)
  }

  template <typename T, typename G>
  static __device__ __forceinline__ void apply(const T* c, int64_t P, const Nbr& x,
                                               const G& g, T& lu, T& lv) {
    const Nb<T> u{g(0, x.c), g(0, x.n), g(0, x.s), g(0, x.e), g(0, x.w), T(0), T(0)};
    const Nb<T> v{g(1, x.c), g(1, x.n), g(1, x.s), g(1, x.e), g(1, x.w), T(0), T(0)};
    lap([&](int m) { return c[m * P + x.c]; }, u, v, lu, lv);
  }
};

// C-grid taps (_ctap_lap), coefficients 0..17 in CTAPS order.
struct CTapLap {
  static constexpr int N_COEF = 18;

  template <typename T, typename CF>
  static __device__ __forceinline__ void lap(const CF& cf, const Nb<T>& u, const Nb<T>& v,
                                             T& lu, T& lv) {
    // each sum left to right, in CTAPS order, its first product fused onto
    // the second one (as in BGridLap::s5)
    lu = fmad(cf(0), u.c, mul(cf(1), u.w));
    lu = fmad(cf(2), u.e, lu);
    lu = fmad(cf(3), u.s, lu);
    lu = fmad(cf(4), u.n, lu);
    lu = fmad(cf(5), v.c, lu);
    lu = fmad(cf(6), v.s, lu);
    lu = fmad(cf(7), v.e, lu);
    lu = fmad(cf(8), v.se, lu);  // v[j-1, i+1]
    lv = fmad(cf(9), v.c, mul(cf(10), v.w));
    lv = fmad(cf(11), v.e, lv);
    lv = fmad(cf(12), v.s, lv);
    lv = fmad(cf(13), v.n, lv);
    lv = fmad(cf(14), u.c, lv);
    lv = fmad(cf(15), u.w, lv);
    lv = fmad(cf(16), u.n, lv);
    lv = fmad(cf(17), u.nw, lv);  // u[j+1, i-1]
  }

  template <typename T, typename G>
  static __device__ __forceinline__ void apply(const T* c, int64_t P, const Nbr& x,
                                               const G& g, T& lu, T& lv) {
    Nb<T> u, v;
    u.c = g(0, x.c); u.w = g(0, x.w); u.e = g(0, x.e); u.s = g(0, x.s); u.n = g(0, x.n);
    u.nw = g(0, x.nw);  // u[j+1, i-1]
    v.c = g(1, x.c); v.w = g(1, x.w); v.e = g(1, x.e); v.s = g(1, x.s); v.n = g(1, x.n);
    v.se = g(1, x.se);  // v[j-1, i+1]
    u.se = v.nw = T(0);
    lap([&](int m) { return c[m * P + x.c]; }, u, v, lu, lv);
  }
};

// The recurrence at one cell whose state sits at offsets `ku` (u) and `kv` (v)
// of the carries and whose sum sits at `au` and `av` of `acc`, from the
// contraction's two outputs. `sums` is false where a windowed step computes a
// cell outside the core: it then advances the state only. `A` is VecArgs or
// the windowed kernels' argument struct, which has the same members.
template <typename T, int KIND, typename A>
__device__ __forceinline__ void vec_step_cell(const A& a, int64_t ku, int64_t kv, int64_t au,
                                              int64_t av, bool sums, T lu, T lv) {
  if (KIND == FIRST) {
    const T u0 = a.w[ku], v0 = a.w[kv];  // raw values
    const T tu = t1_value(lu, u0);
    const T tv = t1_value(lv, v0);
    a.t_next[ku] = tu;
    a.t_next[kv] = tv;
    if (sums) {
      a.acc[au] = acc_first(a.p_a, a.p_b, u0, tu);
      a.acc[av] = acc_first(a.p_a, a.p_b, v0, tv);
    }
    return;
  }
  const T nu = next_value(a.t[ku], lu, a.t_prev[ku]);
  const T nv = next_value(a.t[kv], lv, a.t_prev[kv]);
  if (KIND == MIDDLE) {
    // in place over t_prev: only this cell read it
    a.t_next[ku] = nu;
    a.t_next[kv] = nv;
  }
  if (sums) {
    a.acc[au] = acc_add(a.p_a, nu, a.acc[au]);  // in place
    a.acc[av] = acc_add(a.p_a, nv, a.acc[av]);
  }
}

}  // namespace
