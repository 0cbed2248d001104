// The per-cell arithmetic of one coupled vector Chebyshev step, shared by the
// periodic and windowed local step kernels (vec_pass.cu) and the ring step
// kernels (ring_pass.cu): the two contraction functors and the recurrence.
// The kernels differ only in where a neighbour's value comes from (the
// gather functor `G` and the offsets in `Nbr`); the rest is written in the
// explicitly rounded arithmetic of common.cuh, so all of them round alike.
#pragma once

#include "common.cuh"

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
  // c*f0 + n*fN + s*fS + e*fE + w*fW, summed left to right: the first product
  // is fused onto the second one, which is rounded (as nvcc contracts the plain
  // sum, and 2% faster here than rounding the first)
  template <typename T>
  static __device__ __forceinline__ T s5(T c, T n, T s, T e, T w, T f0, T fN, T fS, T fE,
                                         T fW) {
    return fmad(w, fW, fmad(e, fE, fmad(s, fS, fmad(c, f0, mul(n, fN)))));
  }

  template <typename T, typename G>
  static __device__ __forceinline__ void apply(const T* c, int64_t P, const Nbr& x,
                                               const G& g, T& lu, T& lv) {
    const T u0 = g(0, x.c), uN = g(0, x.n), uS = g(0, x.s), uE = g(0, x.e), uW = g(0, x.w);
    const T v0 = g(1, x.c), vN = g(1, x.n), vS = g(1, x.s), vE = g(1, x.e), vW = g(1, x.w);
    const T cc = c[0 * P + x.c], dn = c[1 * P + x.c], ds = c[2 * P + x.c],
            de = c[3 * P + x.c], dw = c[4 * P + x.c];
    const T mc = c[5 * P + x.c], mn = c[6 * P + x.c], ms = c[7 * P + x.c],
            me = c[8 * P + x.c], mw = c[9 * P + x.c];
    const T diff_u = s5(cc, dn, ds, de, dw, u0, uN, uS, uE, uW);
    const T diff_v = s5(cc, dn, ds, de, dw, v0, vN, vS, vE, vW);
    const T mix_u = s5(mc, mn, ms, me, mw, u0, uN, uS, uE, uW);
    const T mix_v = s5(mc, mn, ms, me, mw, v0, vN, vS, vE, vW);
    lu = add(diff_u, mix_v);  // u picks up S_mix(v)
    lv = add(diff_v, mix_u);  // v picks up S_mix(u)
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
    // each sum left to right, in CTAPS order, its first product fused onto the
    // second one (as in BGridLap::s5)
    lu = fmad(c[0 * P + k], u0, mul(c[1 * P + k], uW));
    lu = fmad(c[2 * P + k], uE, lu);
    lu = fmad(c[3 * P + k], uS, lu);
    lu = fmad(c[4 * P + k], uN, lu);
    lu = fmad(c[5 * P + k], v0, lu);
    lu = fmad(c[6 * P + k], vS, lu);
    lu = fmad(c[7 * P + k], vE, lu);
    lu = fmad(c[8 * P + k], vSE, lu);
    lv = fmad(c[9 * P + k], v0, mul(c[10 * P + k], vW));
    lv = fmad(c[11 * P + k], vE, lv);
    lv = fmad(c[12 * P + k], vS, lv);
    lv = fmad(c[13 * P + k], vN, lv);
    lv = fmad(c[14 * P + k], u0, lv);
    lv = fmad(c[15 * P + k], uW, lv);
    lv = fmad(c[16 * P + k], uN, lv);
    lv = fmad(c[17 * P + k], uNW, lv);
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
    const T tu = fmad(T(0.5), lu, -u0);
    const T tv = fmad(T(0.5), lv, -v0);
    a.t_next[ku] = tu;
    a.t_next[kv] = tv;
    if (sums) {
      a.acc[au] = fmad(a.p_b, tu, mul(a.p_a, u0));
      a.acc[av] = fmad(a.p_b, tv, mul(a.p_a, v0));
    }
    return;
  }
  const T nu = add(fmad(T(-2), a.t[ku], lu), -a.t_prev[ku]);
  const T nv = add(fmad(T(-2), a.t[kv], lv), -a.t_prev[kv]);
  if (KIND == MIDDLE) {
    // in place over t_prev: only this cell read it
    a.t_next[ku] = nu;
    a.t_next[kv] = nv;
  }
  if (sums) {
    a.acc[au] = fmad(a.p_a, nu, a.acc[au]);  // in place
    a.acc[av] = fmad(a.p_a, nv, a.acc[av]);
  }
}

}  // namespace
