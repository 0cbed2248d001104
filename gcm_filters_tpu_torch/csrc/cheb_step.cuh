// The per-cell arithmetic of one scalar Chebyshev step, shared by the
// unsharded step kernel (cheb_pass.cu) and the ring step kernel
// (ring_pass.cu). Both kernels differ only in where a neighbour's value comes
// from; everything after that is step_cell() below, written in the explicitly
// rounded arithmetic of common.cuh, so the two kernels' results are equal bit
// for bit.
#pragma once

#include "common.cuh"

namespace {

template <typename T>
struct Args {
  int ny, nx;
  const T* field;   // raw field (FIRST, LAST)
  const T* t;       // T_k (MIDDLE, LAST)
  const T* t_prev;  // T_{k-1} (MIDDLE, LAST)
  T* t_next;        // T_{k+1} (FIRST, MIDDLE); may alias t_prev
  T* acc;           // running sum, updated in place
  T* h;             // T_0 output (FIRST)
  const T* coef[5]; // c, n, s, e, w (pre-scaled); null -> cval
  T cval[5];
  const T* pre;
  const T* post;
  const T* area;
  T p_a, p_b, land_gain;
  int zap, fold, drop_pre;
};

// The value the stencil contracts over at plane offset `k` (batch base `b`).
template <typename T, int KIND>
__device__ __forceinline__ T gathered(const Args<T>& a, int64_t b, int64_t k) {
  T x;
  if (KIND == FIRST) {
    x = a.field[b + k];
    if (a.area) x = mul(x, a.area[k]);
    if (a.drop_pre) x = mul(a.post[k], nan_to_num(x));
  } else {
    x = a.t[b + k];
  }
  if (a.zap) x = nan_to_num(x);
  if (a.pre) x = mul(a.pre[k], x);
  return x;
}

template <typename T>
__device__ __forceinline__ T coef(const Args<T>& a, int m, int64_t k) {
  return a.coef[m] ? a.coef[m][k] : a.cval[m];
}

// One step at the cell at plane offset `k`, from the gathered values at the
// cell (g) and at its north, south, east and west neighbours.
template <typename T, int KIND>
__device__ __forceinline__ void step_cell(const Args<T>& a, int64_t b, int64_t k,
                                          T g, T gn, T gs, T ge, T gw) {
  // summed left to right, the first product fused onto the second one
  T lap = fmad(coef(a, 0, k), g, mul(coef(a, 1, k), gn));
  lap = fmad(coef(a, 2, k), gs, lap);
  lap = fmad(coef(a, 3, k), ge, lap);
  lap = fmad(coef(a, 4, k), gw, lap);
  if (a.post) lap = mul(a.post[k], lap);

  if (KIND == FIRST) {
    // T_0 = h is the un-masked-by-pre value at this cell
    T h = a.field[b + k];
    if (a.area) h = mul(h, a.area[k]);
    if (a.drop_pre) h = mul(a.post[k], nan_to_num(h));
    const T t1 = fmad(T(0.5), lap, -h);
    a.h[b + k] = h;
    a.t_next[b + k] = t1;
    a.acc[b + k] = fmad(a.p_b, t1, mul(a.p_a, h));
    return;
  }

  const T nxt = add(fmad(T(-2), a.t[b + k], lap), -a.t_prev[b + k]);
  T acc = fmad(a.p_a, nxt, a.acc[b + k]);
  if (KIND == MIDDLE) {
    a.t_next[b + k] = nxt;  // in place over t_prev: only this cell read it
    a.acc[b + k] = acc;     // in place
    return;
  }
  T fbar = a.field[b + k];
  if (a.area) fbar = mul(fbar, a.area[k]);
  // 0*fbar keeps a NaN at a wet cell NaN
  if (a.drop_pre) acc = a.post[k] == T(0) ? mul(a.land_gain, fbar) : fmad(fbar, T(0), acc);
  if (a.area) acc = quot(acc, a.area[k]);
  a.acc[b + k] = acc;  // in place: the filtered result
}

}  // namespace
