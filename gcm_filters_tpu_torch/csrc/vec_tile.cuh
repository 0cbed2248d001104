// The fused coupled vector Chebyshev pass on shared-memory tiles: S coupled
// (u, v) steps per launch, for the B-grid pair (BGridLap) and the C-grid taps
// (CTapLap) of vec_step.cuh. Entries vec_fused_pass_f32/f64 in vec_pass.cu.
//
// A block owns a by x bx tile of the output, for both components, and runs
// the trapezoid (overlapped-halo) decomposition of the TPU kernel
// (gcm_filters_tpu/ops/pallas/vec_pass.py::_build_coupled_pass, head
// comment), with a halo in both y and x:
//   1. load a window of (by+2H) x (bx+2H) cells, H = S, with its corners
//      (the C-grid's diagonal taps read them from the first step on, and a
//      5-point step reaches them within H steps): periodic in both axes on
//      the whole field, cut from the halo-extended block on a shard; into
//      shared memory: the raw state of both components (w on the first pass,
//      else t and t_prev) and every coefficient plane; acc of the own cells.
//      Every value goes by cp.async straight into its slot, all of a
//      window's copies in flight at once (vec_window_load), except, on a
//      ring shard, the state of the halo rows, which the same launch's sends
//      write: those go through registers past L1 after the flag wait
//      (vec_halo_load);
//   2. run the S steps in shared memory; step j updates the window shrunk by
//      j cells on each side, so the last one ends exactly on the own tile.
//      T_{k+1} overwrites T_{k-1} cell by cell (only the cell itself reads
//      it), acc of the own cells is updated in place. Or, a float32 pass of
//      the periodic field, in registers (vec_reg_kernel, where the plan says
//      so): each thread holds a run of window rows of one column through the
//      pass (see "the register steps" below);
//   3. write the own cells of t, t_prev and acc, or, when the pass ends the
//      filter, only acc (vector grids have no finalize).
// The window holds raw values: nan_to_num (zap) applies where a value enters
// the contraction, as in the step kernels, because the raw t and t_prev
// enter -2t - t_prev. Every value goes through OP::lap and the recurrence
// functions in the same order as in the step kernels, so a cell that two
// tiles compute gets the same bits as in the chain of one-step launches.
//
// The tile geometry is a template parameter (GEO): WrapGeo (cheb_tile.cuh,
// no fold) for the whole periodic field, RoundGeo (below) for the fused
// local round of the sharded engine (entries vec_local_fused_pass_f32/f64),
// whose window comes from the halo-extended shard block instead of a wrap,
// StripGeo (below), a round's first launch (entries
// vec_local_strip_pass_f32/f64, vec_strip_kernel), whose window state comes
// from the shard's core planes in place and four halo strips instead of an
// extended block, and RingGeo (cheb_tile.cuh, no fold) for a y-shard of the
// ring (entries vec_ring_fused_pass_f32/f64 in ring_pass.cu), whose window
// rows past the shard's edges are halo rows that the neighbours' sends
// fill. `vec_fused_tile`
// is one tile's whole pass, with the planes (`io`) and the tile's origin as
// arguments: `vec_fused_kernel` runs it for the tile of its blockIdx. The
// ring kernel runs its parts, with a flag wait and vec_halo_load between the
// load and the steps, for the tile its blockIdx or its ticket names, with a
// shard's row of its table as `io`.
// Every buffer is indexed through its own plane: the inputs (the state and
// the coefficients) through in_plane/in_index, the carries out through
// out_plane/out_index, acc through own_plane/own_index, and acc exists only
// where has_acc() says so (the core of the shard block). A tile cell outside
// the core steps the carries; its acc slot in shared memory is scratch that
// is never loaded from or stored to device memory.
//
// Bound: issue, with one 512-thread block an SM (a window takes most of its
// shared memory, and the registers allow no second block), no longer HBM. A
// cell-step reads about 23 (B-grid: 10 coefficients, the centre, north,
// south, east and west values of both components, t_prev and acc of both) or
// 31 (C-grid: 18 coefficients and the two diagonal values) shared words and
// writes two to four; the strips of rows per thread share the centre column
// between rows, and a warp's lanes take consecutive (strip, column) pairs so
// that none idles at a window's edge. The redundant cells of the trapezoid
// add (1 + 2H/by)(1 + 2H/bx) - 1 at most. The window's load is the other
// part of the time: 14 or 22 cp.async copies a window cell, each with its
// addresses, issued by the same warps. Its latency is one trip, not one per
// row and column chunk; what is left is issue, and issue is what the steps
// are bound by too, so a second window, loading while this one steps, does
// not hide it: the steps run no faster beside the next window's copies, and
// the smaller tiles that two windows need add redundant cells (PERF.md §6,
// measured on the card). A block keeps one window. Device memory moves each
// input once per pass plus the halos, which neighbouring tiles share through
// L2. The planner (ops/cuda/vec_pass.py::plan_vec_fused_passes) picks the
// tile and the split.
//
// Build without --use_fast_math: it breaks the NaN test in nan_to_num.
#pragma once

#include <type_traits>

#include "cheb_tile.cuh"  // the geometries, FUSED_THREADS, MAX_SHARED, cp_async, Quot
#include "vec_step.cuh"

namespace {

// A halo-extended shard block (ly+2c, lx+2c) of the sharded vector engine, of
// which one launch owns the region shrunk by `shrink` cells: the core and a
// margin of c - shrink cells around it. Own-region coordinates (gy, gx) run
// over [0, ly+2(c-shrink)) x [0, lx+2(c-shrink)). No wrap (the exchange
// placed it); reads past the block are clamped, and such cells lie more than
// n_ops cells from every own cell. The state, the coefficients and the
// carries out are extended planes; acc is core-shaped.
struct RoundGeo {
  int ly, lx, c, shrink;
  __host__ __device__ int margin() const { return c - shrink; }
  __host__ __device__ int rows() const { return ly + 2 * margin(); }
  __host__ __device__ int cols() const { return lx + 2 * margin(); }
  __device__ int row(int gy) const { return min(max(gy + shrink, 0), ly + 2 * c - 1); }
  __device__ int col(int gx, bool) const { return min(max(gx + shrink, 0), lx + 2 * c - 1); }
  __device__ int64_t in_plane() const { return (int64_t)(ly + 2 * c) * (lx + 2 * c); }
  __device__ int64_t in_index(int r, int cc) const { return (int64_t)r * (lx + 2 * c) + cc; }
  __device__ int64_t out_plane() const { return in_plane(); }
  __device__ int64_t out_index(int gy, int gx) const { return in_index(gy + shrink, gx + shrink); }
  __device__ int64_t own_plane() const { return (int64_t)ly * lx; }
  __device__ int64_t own_index(int gy, int gx) const {
    return (int64_t)(gy - margin()) * lx + (gx - margin());
  }
};

// Whether own cell (gy, gx) has an acc: every cell of the periodic field and
// of a ring shard (acc is own-shaped there), the core cells of a shard block.
__device__ __forceinline__ bool has_acc(const WrapGeo&, int, int) { return true; }
__device__ __forceinline__ bool has_acc(const RoundGeo& g, int gy, int gx) {
  return (unsigned)(gy - g.margin()) < (unsigned)g.ly &&
         (unsigned)(gx - g.margin()) < (unsigned)g.lx;
}
__device__ __forceinline__ bool has_acc(const RingGeo&, int, int) { return true; }

// A round's first launch on strips (entries vec_local_strip_pass_f32/f64):
// RoundGeo's block, own region and coordinates, with no extended copy of the
// state. The state of a window cell lies where the exchange left it: the
// core's own planes, read in place (the caller's u and v on round 0, the
// cores of the previous round's carries later), or one of the four halo
// strips that halo.exchange_strips returns, south and north (c, lx+2c) with
// the corners, west and east (ly, c), each (batch, 2, rows, cols) a carry.
// The coefficients stay on the extended planes (in_index); the carries out
// and acc are RoundGeo's.
struct StripGeo : RoundGeo {
  int64_t own_batch, own_pitch;  // of the own planes: batch stride, row pitch
};

// Where the state of extended cell (r, cc) of batch entry z lies: strip s (0
// south, 1 north, 2 west, 3 east) at `off` for component u and off + plane
// for v; with s = -1 the own planes at `off`.
struct StripCell {
  int s;
  int64_t off, plane;
};

__device__ __forceinline__ StripCell strip_cell(const StripGeo g, int r, int cc, unsigned z) {
  const int c = g.c, ex = g.lx + 2 * c;
  const int64_t e = 2 * (int64_t)z;  // the entry's u plane of a strip
  if (r < c) return {0, (e * c + r) * ex + cc, (int64_t)c * ex};
  if (r >= c + g.ly) return {1, (e * c + (r - c - g.ly)) * ex + cc, (int64_t)c * ex};
  if (cc < c) return {2, (e * g.ly + (r - c)) * c + cc, (int64_t)g.ly * c};
  if (cc >= c + g.lx) return {3, (e * g.ly + (r - c)) * c + (cc - c - g.lx), (int64_t)g.ly * c};
  return {-1, z * g.own_batch + (r - c) * g.own_pitch + (cc - c), 0};
}

// The planes of a launch on strips, the IO of vec_strip_kernel: the state's
// sources by carry, [0] T_k (w on the filter's first launch), [1] T_{k-1}
// (unused on a first launch), then the planes of VecFusedArgs that the tile
// reads and writes.
template <typename T>
struct StripIO {
  const T* own[2][2];    // [carry][component]: core cell (0, 0) of batch entry 0
  const T* strip[2][4];  // [carry][south, north, west, east]
  const T* coef;
  const T* acc_in;
  T* t_out;
  T* t_prev_out;
  T* acc_out;
};

template <typename T>
__device__ __forceinline__ const T* strip_src(const StripIO<T>& io, const StripCell& s,
                                              int carry, int comp) {
  return s.s < 0 ? io.own[carry][comp] + s.off : io.strip[carry][s.s] + s.off + comp * s.plane;
}

// The window's loads go into shared memory by cp.async (cp_async of
// cheb_tile.cuh), except the state of a ring shard's halo rows
// (StateAsync<RingGeo> is false): the sends of the same launch write those
// rows, so they go through registers past L1 (__ldcg), after the flag wait
// (vec_halo_load). A ring shard's own rows [0, ly) go by cp.async like the
// coefficients: no block of the launch writes them (the sends read them,
// the tiles write the other carry pair). That a .ca copy of an own row may
// bring into L1 a line that also holds the end of a halo row, still stale
// while the send is on its way, is why no halo cell is ever read through L1.
// On strips (StripGeo) all the state goes by cp.async: no block of the
// launch writes the own planes or the strips (the tiles write the two fresh
// extended carries out, which alias neither; the wrapper refuses a launch
// whose outputs share storage with what it reads), and nothing else on the
// stream runs during the launch, so no line a .ca copy brings into L1 can
// be stale.

template <typename T>
struct VecFusedArgs {
  int by, bx;         // the own tile
  int n_ops;          // steps in this pass, = H
  int first, last;    // the pass starts with FIRST / ends with LAST
  T pa[MAX_FUSE];     // p_a of each step of the pass
  T p_b;              // p_b of FIRST
  const T* w;         // the stacked input (first pass), (batch, 2, ny, nx)
  const T* t;         // T_k in (not first)
  const T* t_prev;    // T_{k-1} in (not first)
  const T* acc_in;    // acc in (not first); may alias acc_out
  T* t_out;           // T_k out (not last)
  T* t_prev_out;      // T_{k-1} out (not last)
  T* acc_out;         // acc out, the result on a last pass
  const T* coef;      // (n_coef, ny, nx), pre-scaled
};

// Shared planes of the window: the state pairs A (u, v) and B (u, v) (each
// (by+2H) x (bx+2H)), the n_coef coefficients of every window cell, then acc
// of the own tile for u and for v.
template <typename T>
__host__ __device__ inline size_t vec_fused_shared_bytes(int by, int bx, int H, int n_coef) {
  const size_t wy = by + 2 * H, wx = bx + 2 * H;
  return ((4 + n_coef) * wy * wx + 2 * (size_t)by * bx) * sizeof(T);
}

// Rows a thread steps per work item: it loads the strip's values first,
// then does the arithmetic (one latency per strip instead of one per row; a
// store of the step would keep the compiler from hoisting later rows'
// loads). Fewer for the C-grid's 18 coefficients and for float64, which
// would otherwise spill registers at 512 threads.
template <typename OP, typename T>
__host__ __device__ constexpr int vec_strip() {
  return (OP::N_COEF <= 10 ? 4 : 2) / (sizeof(T) == 4 ? 1 : 2);
}

// Two values in one shared-memory load.
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// Offsets of the window's planes in shared memory (offsets, not pointers,
// keep every access in the shared address space). The coefficients are
// stored cell-major: a cell's n_coef values (an even count) follow each
// other, so a cell-step loads them as n_coef / 2 pairs, without bank
// conflicts at a stride of 10 or 18 words.
struct VecPlanes {
  int wx, wa;   // window width (pitch) and cells
  int coef;     // the coefficients, n_coef per window cell
  int acc;      // acc of the own tile: u, then v
  int state;    // the state pairs A and B
};

// One step (kind KIND) of the window shrunk by j, rows [j, wy-j), columns
// [j, wx-j): the pair at `cur` holds T_k, the pair at `prev` T_{k-1}, and
// T_{k+1} goes over prev. A pair's u plane is at its offset, its v plane one
// window later. `b_acc` is this batch entry's u plane of acc, `io` the
// planes (a LAST step writes io.acc_out).
template <typename T, typename OP, int ZAP, int KIND, class GEO, class IO>
__device__ __forceinline__ void vec_step_window(const VecFusedArgs<T>& a, const IO& io, T* sm,
                                                const VecPlanes& pl, const GEO geo,
                                                int j, int wy, int H, int y0, int x0, int cur,
                                                int prev, T p_a, int64_t b_acc) {
  constexpr int S = vec_strip<OP, T>();
  constexpr int NC = OP::N_COEF;
  const int wx = pl.wx, wa = pl.wa;
  const int own_plane = a.by * a.bx;
  const int rows = wy - 2 * j, cols = wx - 2 * j;
  const int strips = (rows + S - 1) / S;
  const int64_t P = geo.own_plane();
  // A work item is a strip's column: (strip, column) pairs, column fastest,
  // one per thread, so a warp's 32 lanes take 32 consecutive pairs across a
  // strip's end and none idles where `cols` is not a multiple of 32.
  const int pairs = strips * cols;
  const Quot per_strip(cols);
  for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
    const int s_i = per_strip(idx);
    const int q = j + idx - s_i * cols;
    const int r0 = j + s_i * S;
    const int r1 = min(r0 + S, wy - j);  // rows past r1 load clamped rows and are not stored
    // loads, for each component: the centre column on rows r0-1 .. r0+S, the
    // east column on rows r0-1 .. r0+S-1 (v's south-east tap reads the row
    // below), the west column on rows r0 .. r0+S (u's north-west tap reads
    // the row above); the rest on the strip
    T tc[2][S + 2], te[2][S + 1], tw[2][S + 1], cf[S][NC], tp[2][S], ac[2][S];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int base = cur + c * wa;
#pragma unroll
      for (int s = 0; s < S + 2; ++s) tc[c][s] = sm[base + min(r0 - 1 + s, r1) * wx + q];
#pragma unroll
      for (int s = 0; s < S + 1; ++s) {
        te[c][s] = sm[base + min(r0 - 1 + s, r1 - 1) * wx + q + 1];
        tw[c][s] = sm[base + min(r0 + s, r1) * wx + q - 1];
      }
    }
    const unsigned ox = q - H;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = min(r0 + s, r1 - 1);
      const int k = r * wx + q;
      const auto* cp = reinterpret_cast<const typename Pair<T>::type*>(sm + pl.coef + k * NC);
#pragma unroll
      for (int m = 0; m < NC / 2; ++m) {
        const auto c2 = cp[m];
        cf[s][2 * m] = c2.x;
        cf[s][2 * m + 1] = c2.y;
      }
      const unsigned oy = r - H;
      const bool own = KIND != FIRST && oy < (unsigned)a.by && ox < (unsigned)a.bx;
      const int o = pl.acc + (int)oy * a.bx + (int)ox;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        tp[c][s] = KIND == FIRST ? T(0) : sm[prev + c * wa + k];
        ac[c][s] = own ? sm[o + c * own_plane] : T(0);
      }
    }
    T gc[2][S + 2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int s = 0; s < S + 2; ++s) gc[c][s] = gather_value<true>(tc[c][s], ZAP != 0, false, T(0));
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = r0 + s;
      if (r >= r1) break;
      const int k = r * wx + q;
      Nb<T> g[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        g[c].c = gc[c][s + 1];
        g[c].n = gc[c][s + 2];
        g[c].s = gc[c][s];
        g[c].e = gather_value<true>(te[c][s + 1], ZAP != 0, false, T(0));
        g[c].w = gather_value<true>(tw[c][s], ZAP != 0, false, T(0));
        g[c].se = gather_value<true>(te[c][s], ZAP != 0, false, T(0));
        g[c].nw = gather_value<true>(tw[c][s + 1], ZAP != 0, false, T(0));
      }
      T l[2];
      OP::lap([&](int m) { return cf[s][m]; }, g[0], g[1], l[0], l[1]);
      const unsigned oy = r - H;
      if (KIND == LAST) {
        // the window is the own tile
        const int gy = y0 + (int)oy, gx = x0 + (int)ox;
        if (gy < geo.rows() && gx < geo.cols() && has_acc(geo, gy, gx)) {
          const int64_t ko = b_acc + geo.own_index(gy, gx);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            io.acc_out[ko + c * P] = acc_add(p_a, next_value(tc[c][s + 1], l[c], tp[c][s]),
                                             ac[c][s]);
        }
        continue;
      }
      const bool own = oy < (unsigned)a.by && ox < (unsigned)a.bx;
      const int o = pl.acc + (int)oy * a.bx + (int)ox;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (KIND == FIRST) {
          const T t1 = t1_value(l[c], tc[c][s + 1]);
          sm[prev + c * wa + k] = t1;
          if (own) sm[o + c * own_plane] = acc_first(p_a, a.p_b, tc[c][s + 1], t1);
        } else {
          const T nxt = next_value(tc[c][s + 1], l[c], tp[c][s]);
          sm[prev + c * wa + k] = nxt;
          if (own) sm[o + c * own_plane] = acc_add(p_a, nxt, ac[c][s]);
        }
      }
    }
  }
}

// The planes of a window of wa cells, wx wide, in shared memory.
__host__ __device__ inline VecPlanes vec_planes(int wx, int wa, int n_coef) {
  return VecPlanes{wx, wa, 4 * wa, (4 + n_coef) * wa, 0};
}

// The same planes for the register steps (vec_reg_kernel), the coefficients
// first: once a thread has lifted its run, the state and acc behind them are
// dead, and the exchange planes take their room and what follows.
__host__ __device__ inline VecPlanes vec_reg_planes(int wx, int wa, int n_coef) {
  return VecPlanes{wx, wa, 0, (4 + n_coef) * wa, n_coef * wa};
}

// Issue the loads of the window of the tile at y0, x0 of batch entry z, and
// of acc of its own cells; the caller commits them as a cp.async group and
// waits (cp_async_wait_all, then __syncthreads) before it reads them. Pair A
// (offset 0) takes T_k (w on a first pass), pair B (2*wa) T_{k-1}; a first
// pass leaves pair B unloaded (its first step writes T_1 there before any
// step reads it); on a ring shard only the state of its own rows goes here,
// that of its halo rows to vec_halo_load. Coefficients go cell-major: a
// cell's n_coef values follow each other. The window's cells are spread over
// the block's threads, row-major, so a warp's copies read consecutive cells
// of a plane. REG: in the planes of the register steps (vec_reg_planes).
template <typename T, typename OP, bool REG = false, class GEO, class IO>
__device__ __forceinline__ void vec_window_load(const VecFusedArgs<T>& a, const IO& io,
                                                const GEO geo, T* sm, int y0, int x0,
                                                unsigned z) {
  constexpr int NC = OP::N_COEF;
  const int H = a.n_ops;
  const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
  const VecPlanes pl = REG ? vec_reg_planes(wx, wa, NC) : vec_planes(wx, wa, NC);
  const int64_t P = geo.in_plane();
  const int64_t b_in = (int64_t)z * 2 * P;
  const T* const s0 = (a.first ? io.w : io.t) + b_in;
  const T* const s1 = a.first ? s0 : io.t_prev + b_in;
  const Quot per_row(wx);
  for (int k = threadIdx.x; k < wa; k += blockDim.x) {
    const int r = per_row(k), q = k - r * wx;
    const int64_t kk = geo.in_index(geo.row(y0 - H + r), geo.col(x0 - H + q, false));
#pragma unroll
    for (int m = 0; m < NC; ++m) cp_async(sm + pl.coef + k * NC + m, io.coef + m * P + kk);
    T* const st = sm + pl.state;
    if constexpr (StateAsync<GEO>::value) {
#pragma unroll
      for (int c = 0; c < 2; ++c) cp_async(st + c * wa + k, s0 + c * P + kk);
      if (!a.first) {
#pragma unroll
        for (int c = 0; c < 2; ++c) cp_async(st + (2 + c) * wa + k, s1 + c * P + kk);
      }
    } else if ((unsigned)(y0 - H + r) < (unsigned)geo.rows()) {
      // a ring shard's own rows; its halo rows wait for vec_halo_load
#pragma unroll
      for (int c = 0; c < 2; ++c) cp_async(st + c * wa + k, s0 + c * P + kk);
      if (!a.first) {
#pragma unroll
        for (int c = 0; c < 2; ++c) cp_async(st + (2 + c) * wa + k, s1 + c * P + kk);
      }
    }
  }
  if (!a.first) {
    const int own_plane = a.by * a.bx;
    const int64_t PA = geo.own_plane();
    const int64_t b_acc = (int64_t)z * 2 * PA;
    const int ny = geo.rows(), nx = geo.cols();
    for (int i = threadIdx.x; i < own_plane; i += blockDim.x) {
      const int gy = y0 + i / a.bx, gx = x0 + i % a.bx;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        T* const dst = sm + pl.acc + c * own_plane + i;
        if (gy < ny && gx < nx && has_acc(geo, gy, gx))
          cp_async(dst, io.acc_in + b_acc + c * PA + geo.own_index(gy, gx));
        else
          *dst = T(0);
      }
    }
  }
}

// The window's copies on a round's first launch (StripGeo, StripIO): as
// vec_window_load's, but a window cell's state comes from where strip_cell
// finds it, the own planes or a strip, never from an extended block. The
// coefficient and acc copies repeat vec_window_load's rather than share a
// helper with it, so the kernels that inline it keep their code and their
// recorded ptxas -v lines.
template <typename T, typename OP>
__device__ __forceinline__ void vec_strip_window_load(const VecFusedArgs<T>& a,
                                                      const StripIO<T>& io, const StripGeo geo,
                                                      T* sm, int y0, int x0, unsigned z) {
  constexpr int NC = OP::N_COEF;
  const int H = a.n_ops;
  const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
  const VecPlanes pl = vec_planes(wx, wa, NC);
  const int64_t P = geo.in_plane();
  const Quot per_row(wx);
  for (int k = threadIdx.x; k < wa; k += blockDim.x) {
    const int r = per_row(k), q = k - r * wx;
    const int er = geo.row(y0 - H + r), ec = geo.col(x0 - H + q, false);
    const int64_t kk = geo.in_index(er, ec);
#pragma unroll
    for (int m = 0; m < NC; ++m) cp_async(sm + pl.coef + k * NC + m, io.coef + m * P + kk);
    const StripCell cell = strip_cell(geo, er, ec, z);
#pragma unroll
    for (int c = 0; c < 2; ++c) cp_async(sm + c * wa + k, strip_src(io, cell, 0, c));
    if (!a.first) {
#pragma unroll
      for (int c = 0; c < 2; ++c) cp_async(sm + (2 + c) * wa + k, strip_src(io, cell, 1, c));
    }
  }
  if (!a.first) {
    const int own_plane = a.by * a.bx;
    const int64_t PA = geo.own_plane();
    const int64_t b_acc = (int64_t)z * 2 * PA;
    const int ny = geo.rows(), nx = geo.cols();
    for (int i = threadIdx.x; i < own_plane; i += blockDim.x) {
      const int gy = y0 + i / a.bx, gx = x0 + i % a.bx;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        T* const dst = sm + pl.acc + c * own_plane + i;
        if (gy < ny && gx < nx && has_acc(geo, gy, gx))
          cp_async(dst, io.acc_in + b_acc + c * PA + geo.own_index(gy, gx));
        else
          *dst = T(0);
      }
    }
  }
}

// The state of the window rows outside a ring shard's own rows [0, ly)
// (RingGeo, where StateAsync is false; nothing elsewhere), after the wait for
// the flags of those rows: through registers past L1 (__ldcg), U
// cells a thread at a time, all their loads, then all their stores. Window
// rows [0, lo) lie below row 0, rows [hi, wy) from row ly on; an interior
// tile has none. The caller waits for the cp.async group and then for the
// block (__syncthreads) before the window is read.
template <typename T, class GEO, class IO>
__device__ __forceinline__ void vec_halo_load(const VecFusedArgs<T>& a, const IO& io,
                                              const GEO geo, T* sm, int y0, int x0) {
  if constexpr (!StateAsync<GEO>::value) {
    const int H = a.n_ops;
    const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
    const int64_t P = geo.in_plane();
    const T* const s0 = a.first ? io.w : io.t;
    const T* const s1 = a.first ? s0 : io.t_prev;
    const int lo = min(max(H - y0, 0), wy);
    const int hi = max(min(geo.rows() + H - y0, wy), lo);
    const int n_lo = lo * wx, cells = n_lo + (wy - hi) * wx;
    const Quot per_row(wx);
    constexpr int U = 4;
    for (int i0 = threadIdx.x; i0 < cells; i0 += U * blockDim.x) {
      T v[U][4];
      int ks[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * blockDim.x;
        ks[u] = i < n_lo ? i : i + (hi - lo) * wx;  // the window cell
        if (i < cells) {
          const int r = per_row(ks[u]), q = ks[u] - r * wx;
          const int64_t kk = geo.in_index(geo.row(y0 - H + r), geo.col(x0 - H + q, false));
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            v[u][c] = __ldcg(s0 + c * P + kk);
            v[u][2 + c] = a.first ? T(0) : __ldcg(s1 + c * P + kk);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u * (int)blockDim.x < cells) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < 2 || !a.first) sm[c * wa + ks[u]] = v[u][c];
        }
      }
    }
  }
}

// The steps of one tile on its window, which has arrived, and the stores of
// its own cells: the carries and, where it exists, acc (a last pass writes
// acc in its last step instead). Every step ends with __syncthreads, so the
// stores read the last step's values.
template <typename T, typename OP, int ZAP, class GEO, class IO>
__device__ __forceinline__ void vec_window_run(const VecFusedArgs<T>& a, const IO& io,
                                               const GEO geo, T* sm, int y0, int x0,
                                               unsigned z) {
  constexpr int NC = OP::N_COEF;
  const int H = a.n_ops;
  const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
  const VecPlanes pl = vec_planes(wx, wa, NC);
  const int own_plane = a.by * a.bx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  // this entry's u planes (v follows one plane later) of the carries out and acc
  const int64_t PO = geo.out_plane(), PA = geo.own_plane();
  const int64_t b_out = (int64_t)z * 2 * PO;
  const int64_t b_acc = (int64_t)z * 2 * PA;
  const int ny = geo.rows(), nx = geo.cols();

  int cur = 0, prev = 2 * wa;
  for (int i = 0; i < H; ++i) {
    const int j = i + 1;  // this step's window: shrunk by j
    if (a.first && i == 0)
      vec_step_window<T, OP, ZAP, FIRST>(a, io, sm, pl, geo, j, wy, H, y0, x0, cur, prev,
                                         a.pa[i], b_acc);
    else if (a.last && i == H - 1)
      vec_step_window<T, OP, ZAP, LAST>(a, io, sm, pl, geo, j, wy, H, y0, x0, cur, prev,
                                        a.pa[i], b_acc);
    else
      vec_step_window<T, OP, ZAP, MIDDLE>(a, io, sm, pl, geo, j, wy, H, y0, x0, cur, prev,
                                          a.pa[i], b_acc);
    __syncthreads();
    const int tmp = cur;
    cur = prev;
    prev = tmp;
  }
  if (a.last) return;

  for (int r = H + warp; r < H + a.by; r += nwarps) {
    const int gy = y0 - H + r;
    if (gy >= ny) break;
    for (int q = H + lane; q < H + a.bx; q += 32) {
      const int gx = x0 - H + q;
      if (gx >= nx) break;
      const int k = r * wx + q;
      const int64_t ko = b_out + geo.out_index(gy, gx);
      const int o = (r - H) * a.bx + (q - H);
      const bool sums = has_acc(geo, gy, gx);
      const int64_t ka = b_acc + geo.own_index(gy, gx);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        io.t_out[ko + c * PO] = sm[cur + c * wa + k];
        io.t_prev_out[ko + c * PO] = sm[prev + c * wa + k];
        if (sums) io.acc_out[ka + c * PA] = sm[pl.acc + c * own_plane + o];
      }
    }
  }
}

// One tile's pass on one window, all of the block's threads, the dynamic
// shared memory its window: the own cells of the tile at `org` (GridOrigin
// of cheb_tile.cuh). `a` holds the pass (steps, p_a, tile), `io`
// the planes (w, t, t_prev, acc_in, t_out, t_prev_out, acc_out, coef): the
// VecFusedArgs itself for vec_fused_kernel. The geometry goes by value, here,
// into vec_step_window and in the ring kernel: by
// reference, five of the RoundGeo kernels got other register counts than
// when this body was the kernel's own (ptxas -v, compared on the card).
template <typename T, typename OP, int ZAP, class GEO, class IO, class ORG>
__device__ __forceinline__ void vec_fused_tile(const VecFusedArgs<T>& a, const IO& io,
                                               const GEO geo, const ORG& org) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int y0 = org.y0(a.by), x0 = org.x0(a.bx);
  vec_window_load<T, OP>(a, io, geo, sm, y0, x0, org.z());
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  vec_window_run<T, OP, ZAP>(a, io, geo, sm, y0, x0, org.z());
}

template <typename T, typename OP, int ZAP, class GEO>
__global__ void __launch_bounds__(FUSED_THREADS) vec_fused_kernel(const VecFusedArgs<T> a,
                                                                   const GEO geo) {
  vec_fused_tile<T, OP, ZAP>(a, a, geo, GridOrigin{});
}

// A round's first launch on strips: vec_fused_tile's load, wait and run,
// the load from the own planes and the strips.
template <typename T, typename OP, int ZAP>
__global__ void __launch_bounds__(FUSED_THREADS) vec_strip_kernel(const VecFusedArgs<T> a,
                                                                   const StripIO<T> io,
                                                                   const StripGeo geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const GridOrigin org;
  const int y0 = org.y0(a.by), x0 = org.x0(a.bx);
  vec_strip_window_load<T, OP>(a, io, geo, sm, y0, x0, org.z());
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  vec_window_run<T, OP, ZAP>(a, io, geo, sm, y0, x0, org.z());
}

// -- the register steps ------------------------------------------------------
//
// A float32 pass on the periodic field (WrapGeo) can run its steps in
// registers instead (vec_reg_kernel, a kernel of its own, launched where the
// plan says so: ops/cuda/vec_pass.py::plan_vec_fused_passes weighs both
// steps per pass and the wrapper passes its choice). A thread owns a run of R
// consecutive window rows in one column for the whole pass: thread t <
// ceil(wy / R) wx takes column t % wx and rows [R (t / wx), R (t / wx) + R),
// so a warp's lanes take consecutive columns and none idles at a window's
// edge. After the window's load (the coefficients first, vec_reg_planes) the
// thread lifts its run into registers (VecRun): the raw T_k and T_{k-1} of u
// and v, and acc. The state and acc in shared memory are then dead, and two
// exchange planes take their room: (u, v) pairs, column-major, P rows a
// column (P odd, so a warp's lanes, a column apart, hit other banks), with a
// column of padding on each side. A plane holds T_k gathered (nan_to_num
// under zap), once, by the cell's owner when it makes the value, so a step
// loads every value it contracts ready, one (u, v) pair a cell: east, west
// (on the C-grid the diagonal ones too) and its own column; its own raw T_k
// and T_{k-1} enter the recurrence from the registers, and the coefficients
// stay in shared memory. It steps with OP::lap and the recurrence functions
// in vec_step_window's order, publishes the gathered T_{k+1} into the other
// plane, and one barrier a step separates the two (one plane, with a second
// barrier between a step's reads and its writes, ran 4% slower). A slot
// whose row lies outside the step's shrunk window is skipped (no later step
// reads its value: the windows only shrink); the columns outside it are
// stepped with values no later step reads, and the padding keeps their
// reads inside the planes. Only the own cells' results leave the registers.
// Measured on one H100 (PERF.md §6): 127-128 registers, one block an SM; at
// the 2400x3600 headline K3's two passes take 1.02-1.07 ms against 1.22 in
// shared memory.

// Rows of a thread's run in the register steps of a contraction and dtype;
// 0: the pass keeps vec_step_window. Every row of a run holds six values in
// registers: the longest run that does not spill (ptxas -v,
// csrc/ptxas_lines.json), for the C-grid's 18 coefficients a shorter one (8
// spilled 28 B and ran 10% slower than 6). float64 would hold twice the
// registers and keeps the shared-memory steps.
template <typename OP, typename T> struct VecRegRows { static constexpr int value = 0; };
template <> struct VecRegRows<BGridLap, float> { static constexpr int value = 8; };
template <> struct VecRegRows<CTapLap, float> { static constexpr int value = 6; };

// Cells a column of an exchange plane holds: the window's run rows, made odd.
__host__ __device__ constexpr int vec_reg_pitch(int wy, int r) { return (wy + r - 1) / r * r | 1; }

// Dynamic shared memory of a block on the register steps: the coefficients of
// the window, then its state pairs and acc of the own tile (as in
// vec_fused_shared_bytes) or, once those are lifted, the two exchange planes
// of (u, v) pairs over them, whichever is larger.
template <typename T>
__host__ __device__ inline size_t vec_reg_shared_bytes(int by, int bx, int H, int n_coef, int r) {
  const size_t wy = by + 2 * H, wx = bx + 2 * H;
  const size_t window = 4 * wy * wx + 2 * (size_t)by * bx;
  const size_t planes = 4 * (wx + 2) * (size_t)vec_reg_pitch((int)wy, r);
  return (n_coef * wy * wx + (window > planes ? window : planes)) * sizeof(T);
}

// One thread's run: slot s is window row r0 + s of column q.
template <typename T, int R>
struct VecRun {
  T x[2][R], y[2][R];  // raw T_k and T_{k-1} of u and v, the roles trading places every step
  T ac[2][R];          // acc of u and v (the own slots' is the result's)
  int q, r0;           // column and first row; q < 0: no run
  int e0;              // exchange-plane offset of slot 0, in pairs: (q + 1) P + r0
};

// One step (kind KIND, window shrunk by j) in registers: `cur` holds T_k,
// T_{k+1} goes over `old` (T_{k-1}); the neighbours' gathered T_k come from
// exchange plane `in` (word offset; P rows a column), and with `publish` the
// gathered T_{k+1} goes into plane `out`. LAST writes acc of the own cells.
template <int KIND, typename T, typename OP, int ZAP, int R>
__device__ __forceinline__ void vec_reg_step(const VecFusedArgs<T>& a, T* sm, const VecPlanes& pl,
                                             const WrapGeo geo, VecRun<T, R>& v,
                                             T (&cur)[2][R], T (&old)[2][R], int P_, int j,
                                             int wy, int H, int y0, int x0, int in, int out,
                                             T p_a, bool publish, int64_t b_acc) {
  using T2 = typename Pair<T>::type;
  constexpr int NC = OP::N_COEF;
  const T2* const se = reinterpret_cast<const T2*>(sm + in) + v.e0;  // slot 0 in plane `in`
  // the gathered T_k of the slot's column on the rows just below, on and
  // just above the slot (from the plane, where this thread published it: a
  // load is cheaper than gathering again), the east column a row below the
  // slot's and the west column on it, carried from slot to slot (the C-grid's
  // diagonal taps read the east column a row below and the west column a row
  // above; a contraction that does not read them drops their loads)
  T2 o_s = se[-1], o = se[0], e_s = se[P_ - 1], w = se[-P_];
  // the live slots: window rows [j, wy - j)
  const int lo = j - v.r0, hi = wy - j - v.r0;
  const unsigned ox = v.q - H;
  T2* const so = reinterpret_cast<T2*>(sm + out) + v.e0;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const T2 o_n = se[s + 1], e = se[P_ + s], w_n = se[s + 1 - P_];
    const T2 g_s = o_s, g = o, g_e = e, g_se = e_s, g_w = w;
    o_s = o;
    o = o_n;
    e_s = e;
    w = w_n;
    if (s < lo || s >= hi) continue;
    const int k = (v.r0 + s) * pl.wx + v.q;
    const T2* const cp = reinterpret_cast<const T2*>(sm + pl.coef + k * NC);
    T cf[NC];
#pragma unroll
    for (int m = 0; m < NC / 2; ++m) {
      const T2 c2 = cp[m];
      cf[2 * m] = c2.x;
      cf[2 * m + 1] = c2.y;
    }
    Nb<T> nb[2];
    nb[0].c = g.x;
    nb[0].n = o_n.x;
    nb[0].s = g_s.x;
    nb[0].e = g_e.x;
    nb[0].w = g_w.x;
    nb[0].se = g_se.x;
    nb[0].nw = w_n.x;
    nb[1].c = g.y;
    nb[1].n = o_n.y;
    nb[1].s = g_s.y;
    nb[1].e = g_e.y;
    nb[1].w = g_w.y;
    nb[1].se = g_se.y;
    nb[1].nw = w_n.y;
    T l[2];
    OP::lap([&](int m) { return cf[m]; }, nb[0], nb[1], l[0], l[1]);
    if (KIND == LAST) {
      // the live rows are the own tile's
      const int gy = y0 + v.r0 + s - H, gx = x0 + (int)ox;
      if (ox < (unsigned)a.bx && gy < geo.rows() && gx < geo.cols()) {
        const int64_t ko = b_acc + geo.own_index(gy, gx);
        const int64_t P = geo.own_plane();
#pragma unroll
        for (int c = 0; c < 2; ++c)
          a.acc_out[ko + c * P] = acc_add(p_a, next_value(cur[c][s], l[c], old[c][s]), v.ac[c][s]);
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (KIND == FIRST) {
        const T t1 = t1_value(l[c], cur[c][s]);
        v.ac[c][s] = acc_first(p_a, a.p_b, cur[c][s], t1);
        old[c][s] = t1;
      } else {
        const T nxt = next_value(cur[c][s], l[c], old[c][s]);
        v.ac[c][s] = acc_add(p_a, nxt, v.ac[c][s]);
        old[c][s] = nxt;
      }
    }
    if (publish) {
      T2 w2;
      w2.x = gather_value<true>(old[0][s], ZAP != 0, false, T(0));
      w2.y = gather_value<true>(old[1][s], ZAP != 0, false, T(0));
      so[s] = w2;
    }
  }
}

// The steps of one tile in registers, after its window has arrived (in
// vec_reg_planes), and the stores of its own cells: lift each thread's run,
// publish T_k into exchange plane 0 over the dead state, step, and write the
// carries and acc from the registers (LAST wrote acc).
template <typename T, typename OP, int ZAP>
__device__ __forceinline__ void vec_reg_steps(const VecFusedArgs<T>& a, const WrapGeo geo, T* sm,
                                              int y0, int x0, unsigned z) {
  using T2 = typename Pair<T>::type;
  constexpr int R = VecRegRows<OP, T>::value;
  constexpr int NC = OP::N_COEF;
  const int H = a.n_ops;
  const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
  const VecPlanes pl = vec_reg_planes(wx, wa, NC);
  const int P_ = vec_reg_pitch(wy, R);
  const int own_plane = a.by * a.bx;
  const bool first = a.first != 0;
  // this thread's run: column q, rows [r0, r0 + R); q < 0: none
  VecRun<T, R> v;
  const int t = threadIdx.x;
  const bool runs = t < (wy + R - 1) / R * wx;
  v.q = runs ? t % wx : -1;
  v.r0 = runs ? t / wx * R : 0;
  v.e0 = (v.q + 1) * P_ + v.r0;
  const unsigned ox = v.q - H;
  // the lift: a slot past the window (or of a thread with no run) reads the
  // window's last row (cell 0), whose values no live slot reads
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int k = runs ? min(v.r0 + s, wy - 1) * wx + v.q : 0;
    const unsigned oy = v.r0 + s - H;
    const bool own = oy < (unsigned)a.by && ox < (unsigned)a.bx;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      v.x[c][s] = sm[pl.state + c * wa + k];
      v.y[c][s] = first ? T(0) : sm[pl.state + (2 + c) * wa + k];
      v.ac[c][s] = first || !own ? T(0) : sm[pl.acc + c * own_plane + (int)oy * a.bx + (int)ox];
    }
  }
  // the exchange planes over the dead state: plane 0 from word pl.state,
  // plane 1 after it; T_k, gathered, goes into plane 0
  const int plane = 2 * (wx + 2) * P_;
  const int p0 = pl.state, p1 = pl.state + plane;
  __syncthreads();
  if (runs) {
    T2* const so = reinterpret_cast<T2*>(sm + p0) + v.e0;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      T2 w2;
      w2.x = gather_value<true>(v.x[0][s], ZAP != 0, false, T(0));
      w2.y = gather_value<true>(v.x[1][s], ZAP != 0, false, T(0));
      so[s] = w2;
    }
  }
  __syncthreads();

  const int64_t b_acc = (int64_t)z * 2 * geo.own_plane();
  // the steps: T_{k+1} goes over T_{k-1}, so step i reads T_k from x where
  // i is even and from y where it is odd; the planes trade places likewise
  for (int i = 0; i < H; ++i) {
    const int j = i + 1;
    const bool odd = i & 1, publish = i + 1 < H;
    const int in = odd ? p1 : p0, out = odd ? p0 : p1;
    const T p_a = a.pa[i];
    if (runs) {
      if (!odd) {
        if (first && i == 0)
          vec_reg_step<FIRST, T, OP, ZAP>(a, sm, pl, geo, v, v.x, v.y, P_, j, wy, H, y0, x0, in,
                                          out, p_a, publish, b_acc);
        else if (a.last && i == H - 1)
          vec_reg_step<LAST, T, OP, ZAP>(a, sm, pl, geo, v, v.x, v.y, P_, j, wy, H, y0, x0, in,
                                         out, p_a, publish, b_acc);
        else
          vec_reg_step<MIDDLE, T, OP, ZAP>(a, sm, pl, geo, v, v.x, v.y, P_, j, wy, H, y0, x0, in,
                                           out, p_a, publish, b_acc);
      } else {
        if (a.last && i == H - 1)
          vec_reg_step<LAST, T, OP, ZAP>(a, sm, pl, geo, v, v.y, v.x, P_, j, wy, H, y0, x0, in,
                                         out, p_a, publish, b_acc);
        else
          vec_reg_step<MIDDLE, T, OP, ZAP>(a, sm, pl, geo, v, v.y, v.x, P_, j, wy, H, y0, x0, in,
                                           out, p_a, publish, b_acc);
      }
    }
    if (publish) __syncthreads();
  }
  if (a.last || !runs) return;

  // the own cells of the carries and of acc, from the registers: T_k is in
  // y after an odd number of steps, in x after an even one
  const int gx = x0 + (int)ox;
  if (ox >= (unsigned)a.bx || gx >= geo.cols()) return;
  const int64_t PO = geo.out_plane(), PA = geo.own_plane();
  const int64_t b_out = (int64_t)z * 2 * PO;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const unsigned oy = v.r0 + s - H;
    const int gy = y0 + (int)oy;
    if (oy >= (unsigned)a.by || gy >= geo.rows()) continue;
    const int64_t ko = b_out + geo.out_index(gy, gx), ka = b_acc + geo.own_index(gy, gx);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      a.t_out[ko + c * PO] = H & 1 ? v.y[c][s] : v.x[c][s];
      a.t_prev_out[ko + c * PO] = H & 1 ? v.x[c][s] : v.y[c][s];
      a.acc_out[ka + c * PA] = v.ac[c][s];
    }
  }
}

// A pass of the periodic field on the register steps: the window's load in
// vec_reg_planes, then vec_reg_steps.
template <typename T, typename OP, int ZAP>
__global__ void __launch_bounds__(FUSED_THREADS) vec_reg_kernel(const VecFusedArgs<T> a,
                                                                 const WrapGeo geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const GridOrigin org;
  const int y0 = org.y0(a.by), x0 = org.x0(a.bx);
  vec_window_load<T, OP, true>(a, a, geo, sm, y0, x0, org.z());
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  vec_reg_steps<T, OP, ZAP>(a, geo, sm, y0, x0, org.z());
}

// Let `kernel` take `bytes` of dynamic shared memory.
template <class K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// The register steps' kernel of a pass (vec_reg_kernel): refused where the
// contraction and dtype have no run length, the block's threads do not
// cover the window's runs or its planes do not fit (the planner's
// ops/cuda/vec_pass.py::vec_reg_fits mirrors this).
template <typename T, typename OP, int ZAP>
int launch_vec_reg(const VecFusedArgs<T>& a, const WrapGeo& g, dim3 grid, cudaStream_t st) {
  constexpr int R = VecRegRows<OP, T>::value;
  if constexpr (R == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int wy = a.by + 2 * a.n_ops, wx = a.bx + 2 * a.n_ops;
    const size_t bytes = vec_reg_shared_bytes<T>(a.by, a.bx, a.n_ops, OP::N_COEF, R);
    if ((wy + R - 1) / R * wx > FUSED_THREADS || bytes > MAX_SHARED)
      return (int)cudaErrorInvalidValue;
    if (const int err = allow_shared(vec_reg_kernel<T, OP, ZAP>, bytes)) return err;
    vec_reg_kernel<T, OP, ZAP><<<grid, FUSED_THREADS, bytes, st>>>(a, g);
    return (int)cudaGetLastError();
  }
}

// The kernel of a launch: vec_strip_kernel on strips (`io` a StripIO),
// vec_reg_kernel for a pass of the periodic field on the register steps
// (`regs`), else vec_fused_kernel, whose planes are the VecFusedArgs
// themselves.
template <typename T, typename OP, int ZAP, class GEO, class IO>
int launch_vec_mode(const VecFusedArgs<T>& a, const IO& io, const GEO& g, dim3 grid,
                    size_t bytes, int regs, cudaStream_t st) {
  if constexpr (std::is_same<GEO, StripGeo>::value) {
    if (const int err = allow_shared(vec_strip_kernel<T, OP, ZAP>, bytes)) return err;
    vec_strip_kernel<T, OP, ZAP><<<grid, FUSED_THREADS, bytes, st>>>(a, io, g);
  } else {
    if constexpr (std::is_same<GEO, WrapGeo>::value)
      if (regs) return launch_vec_reg<T, OP, ZAP>(a, g, grid, st);
    if (const int err = allow_shared(vec_fused_kernel<T, OP, ZAP, GEO>, bytes)) return err;
    vec_fused_kernel<T, OP, ZAP, GEO><<<grid, FUSED_THREADS, bytes, st>>>(a, g);
  }
  return (int)cudaGetLastError();
}

// Launch one fused vector pass over the own domain of `g` (rows x cols
// cells), tiles of by x bx, one block per tile, with the kernel compiled for
// the contraction and for zap; `io` the planes (the VecFusedArgs, or a
// StripIO on strips). `regs` (a pass of the periodic field only): on the
// register steps, as the caller's plan says.
template <typename T, class GEO, class IO>
int launch_vec_fused(int op, int zap, int regs, const VecFusedArgs<T>& a, const IO& io,
                     const GEO& g, int rows, int cols, int batch, cudaStream_t st) {
  if (op != BGRID && op != CTAP) return (int)cudaErrorInvalidValue;
  if (regs && !std::is_same<GEO, WrapGeo>::value) return (int)cudaErrorInvalidValue;
  if (rows < 1 || cols < 1 || a.n_ops < 1 || a.n_ops > MAX_FUSE || a.by < 1 || a.bx < 1 ||
      batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_coef = op == BGRID ? BGridLap::N_COEF : CTapLap::N_COEF;
  const size_t bytes = vec_fused_shared_bytes<T>(a.by, a.bx, a.n_ops, n_coef);
  if (bytes > MAX_SHARED) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + a.bx - 1) / a.bx, (rows + a.by - 1) / a.by, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (op == BGRID)
    return zap ? launch_vec_mode<T, BGridLap, 1>(a, io, g, grid, bytes, regs, st)
               : launch_vec_mode<T, BGridLap, 0>(a, io, g, grid, bytes, regs, st);
  return zap ? launch_vec_mode<T, CTapLap, 1>(a, io, g, grid, bytes, regs, st)
             : launch_vec_mode<T, CTapLap, 0>(a, io, g, grid, bytes, regs, st);
}

// Fill the fields both fused entries pass the same way.
template <typename T>
VecFusedArgs<T> vec_fused_args(int by, int bx, int n_ops, int first, int last, const double* pa,
                               double p_b, const T* w, const T* t, const T* t_prev,
                               const T* acc_in, T* t_out, T* t_prev_out, T* acc_out,
                               const T* coef) {
  VecFusedArgs<T> a;
  a.by = by; a.bx = bx; a.n_ops = n_ops; a.first = first; a.last = last;
  for (int i = 0; i < MAX_FUSE; ++i) a.pa[i] = i < n_ops ? T(pa[i]) : T(0);
  a.p_b = T(p_b);
  a.w = w; a.t = t; a.t_prev = t_prev; a.acc_in = acc_in;
  a.t_out = t_out; a.t_prev_out = t_prev_out; a.acc_out = acc_out; a.coef = coef;
  return a;
}

}  // namespace
