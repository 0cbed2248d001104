// The fused scalar Chebyshev pass on shared-memory tiles: S steps per
// launch, shared by the unsharded fused entry (cheb_pass.cu, WrapGeo), the
// fused local round of the sharded engine (local_pass.cu, BlockGeo) and the
// fused ring pass (ring_pass.cu, RingGeo). `fused_tile` is one tile's whole
// pass; `fused_pass_kernel` runs it for the tile of its blockIdx, the ring
// kernel for the tile its ticket names.
//
// A block owns a by x bx tile of the output and runs the trapezoid
// (overlapped-halo) decomposition of the TPU kernel
// (gcm_filters_tpu/ops/pallas/cheb_pass.py, head comment), with a halo in
// both y and x:
//   1. load a window of (by+2H) x (bx+2H) cells, H = S, into shared memory
//      in one burst: every copy of the window goes by cp.async straight into
//      its slot, all of them in flight at once (fused_window_load): the
//      carries (t_prev and t, or on a first pass the raw field and area) and
//      the coefficient planes that are arrays (c, n, s, e, w, post, pre);
//      acc of the own cells. A first pass then computes T_0 = h in place
//      from the raw field, area and post (t0_value), one sweep over the
//      window between two barriers;
//   2. run the S steps in shared memory; step j updates the window shrunk by
//      j cells on each side, so the last one ends exactly on the own tile.
//      A step's work items are (strip, column) pairs, one per thread, so no
//      lane idles at a window's right edge (step_window).
//      T_{k+1} overwrites T_{k-1} cell by cell (only the cell itself reads
//      it), acc of the own cells is updated in place;
//   3. write the own cells of t, t_prev and acc, or, when the pass ends the
//      filter, only the result (land reconstruction and /area fused).
// Every value goes through the functions of cheb_step.cuh in the same order
// as in the step kernels, so a cell that two tiles compute, or that a tile
// computes as a mirror, gets the same bits as in the chain of one-step
// launches.
//
// The tripolar fold (WrapGeo with fold): window rows above the top row are
// mirror cells, ext row ny-1+m = real row ny-m reversed in x. A mirror cell
// is stepped as the real cell R it mirrors: with R's own coefficients and
// masks (loaded from R's index) and with its window neighbours in swapped
// roles (R's north is the window's south, R's east the window's west). In
// the fixed summation order c, n, s, e, w that is R's arithmetic exactly.
// Window rows below row 0 wrap to the top rows (as the step kernel's south
// neighbour of row 0 does); there the window's north neighbour of real row
// ny-1 is row 0 and not the fold, so those cells drift from the step chain,
// and the drift would reach row 0 one step later. Row 0 is land on every
// fold grid (`_check_antarctica` raises otherwise) and its Laplacian is zero
// whatever its south neighbour holds (post = 0, or all coefficients 0), so
// no real cell reads the drift.
//
// Bound: issue in the steps, no longer HBM. A cell-step reads about 7 shared
// words (the centre column shared by a strip's rows, east, west, c, post,
// t_prev, acc of an own cell) and writes one or two; the (strip, column)
// items keep every lane of a round busy but the last round's; the redundant
// cells of the trapezoid add (1 + 2H/by)(1 + 2H/bx) - 1 at most. Measured on
// one H100 (PERF.md §6, python3 -m gcm_filters_tpu_torch.utils.tile_split):
// on the 2400x3600 float32 headline (40x80 tiles, one pass of 11 steps, two
// blocks an SM) the steps take 82% of the time, the window's burst load 13%,
// and the two add up: the load does not hide under the other block's steps.
// Device memory moves each input once per pass plus the halos, which
// neighbouring tiles share through L2.
//
// Build without --use_fast_math: it breaks the NaN test in nan_to_num and the
// 0*fbar NaN poison.
#pragma once

#include "cheb_step.cuh"

namespace {

constexpr int MAX_FUSE = 16;       // steps per pass at most (the halo, H)
constexpr int FUSED_THREADS = 512; // 16 warps; a warp walks one window row
constexpr size_t MAX_SHARED = 232448;  // what a block may take on sm_90

template <typename T>
struct FusedArgs {
  int by, bx;        // the own tile
  int n_ops;         // steps in this pass, = H
  int first, last;   // the pass starts with FIRST / ends with LAST
  T pa[MAX_FUSE];    // p_a of each step of the pass
  T p_b;             // p_b of FIRST
  const T* field;    // raw field of the window (first pass), in-plane indexed
  const T* field_own;  // raw field of the own cells (last pass), own-plane indexed
  const T* t;        // T_k in (not first)
  const T* t_prev;   // T_{k-1} in (not first)
  const T* acc_in;   // acc in (not first); may alias acc_out
  T* t_out;          // T_k out (not last)
  T* t_prev_out;     // T_{k-1} out (not last)
  T* acc_out;        // acc out, or the result on a last pass
  const T* coef[5];  // c, n, s, e, w (pre-scaled); null -> cval
  T cval[5];
  const T* pre;
  const T* post;
  const T* area;
  T land_gain;
  int zap, drop_pre;
};

// Planes: "in" planes (t, t_prev, the first pass's field and every
// coefficient plane) and "out" planes (t_out, t_prev_out) are indexed by
// in_index/out_index, the own planes (acc, the result, the last pass's
// field) by own_index. Window row gy, column gx are in the own domain's
// coordinates and may lie outside it.

// The whole field: x periodic, y periodic or folded at the top.
struct WrapGeo {
  int ny, nx, fold;
  __device__ int rows() const { return ny; }
  __device__ int cols() const { return nx; }
  __device__ bool mirror(int gy) const { return fold && gy >= ny; }
  // one add or subtract where the field is at least a window wide, as the
  // planner's predicate makes it; the loops cover smaller fields too
  __device__ int row(int gy) const {
    if (mirror(gy)) gy = 2 * ny - 1 - gy;  // ext row ny-1+m -> real row ny-m
    while (gy < 0) gy += ny;
    while (gy >= ny) gy -= ny;
    return gy;
  }
  __device__ int col(int gx, bool mir) const {
    while (gx < 0) gx += nx;
    while (gx >= nx) gx -= nx;
    return mir ? nx - 1 - gx : gx;
  }
  __device__ int64_t in_plane() const { return (int64_t)ny * nx; }
  __device__ int64_t in_index(int r, int c) const { return (int64_t)r * nx + c; }
  __device__ int64_t own_plane() const { return (int64_t)ny * nx; }
  __device__ int64_t own_index(int gy, int gx) const { return (int64_t)gy * nx + gx; }
  __device__ int64_t out_plane() const { return (int64_t)ny * nx; }
  __device__ int64_t out_index(int gy, int gx) const { return (int64_t)gy * nx + gx; }
  template <typename T>
  __device__ T ld(const T* p, int64_t k) const { return p[k]; }
};

// A y-shard of the ring (ly rows of nx cells): every "in" plane is the
// shard's block extended by `pad` rows below and above, whose halo rows the
// neighbours' sends fill (the bottom shard's south halo holds the top shard's
// top rows: y wraps); x is periodic. On the top shard of a fold grid
// (`fold`) window rows above ly-1 are mirror cells of the shard's own top
// rows, as WrapGeo's are of the field's (needs ly >= the pass's halo). Rows
// further than the pass's halo from every own row are clamped into the
// block: their values reach no own cell. The carries go to the own rows of
// extended planes; acc and the last pass's field are own-shaped. Carries and
// the field are loaded past L1: the sends of the same launch wrote the halo
// rows.
struct RingGeo {
  int ly, nx, pad, fold;
  __device__ int rows() const { return ly; }
  __device__ int cols() const { return nx; }
  __device__ bool mirror(int gy) const { return fold && gy >= ly; }
  __device__ int row(int gy) const {
    if (mirror(gy)) gy = max(2 * ly - 1 - gy, 0);  // ext row ly-1+m -> real row ly-m
    return min(max(gy, -pad), ly + pad - 1) + pad;
  }
  __device__ int col(int gx, bool mir) const {
    while (gx < 0) gx += nx;
    while (gx >= nx) gx -= nx;
    return mir ? nx - 1 - gx : gx;
  }
  __device__ int64_t in_plane() const { return (int64_t)(ly + 2 * pad) * nx; }
  __device__ int64_t in_index(int r, int c) const { return (int64_t)r * nx + c; }
  __device__ int64_t own_plane() const { return (int64_t)ly * nx; }
  __device__ int64_t own_index(int gy, int gx) const { return (int64_t)gy * nx + gx; }
  __device__ int64_t out_plane() const { return in_plane(); }
  __device__ int64_t out_index(int gy, int gx) const { return (int64_t)(gy + pad) * nx + gx; }
  template <typename T>
  __device__ T ld(const T* p, int64_t k) const { return __ldcg(p + k); }
};

// A halo-extended block (ly+2c, lx+2c) of the sharded engine: the own domain
// is its core, no wrap and no fold (the exchange placed them). Reads past
// the block are clamped: such cells lie more than S cells from the core.
struct BlockGeo {
  int ly, lx, c;
  __device__ int rows() const { return ly; }
  __device__ int cols() const { return lx; }
  __device__ bool mirror(int) const { return false; }
  __device__ int row(int gy) const { return min(max(gy + c, 0), ly + 2 * c - 1); }
  __device__ int col(int gx, bool) const { return min(max(gx + c, 0), lx + 2 * c - 1); }
  __device__ int64_t in_plane() const { return (int64_t)(ly + 2 * c) * (lx + 2 * c); }
  __device__ int64_t in_index(int r, int cc) const { return (int64_t)r * (lx + 2 * c) + cc; }
  __device__ int64_t own_plane() const { return (int64_t)ly * lx; }
  __device__ int64_t own_index(int gy, int gx) const { return (int64_t)gy * lx + gx; }
  __device__ int64_t out_plane() const { return in_plane(); }
  __device__ int64_t out_index(int gy, int gx) const { return in_index(gy + c, gx + c); }
  template <typename T>
  __device__ T ld(const T* p, int64_t k) const { return p[k]; }
};

// The window's copies. cp.async puts a value from device memory straight
// into its shared-memory slot, with no round trip through a register, so
// every copy of a window is in flight at once: one latency per window, where
// a load into a register and a store per cell queue one behind the other.
// cp.async of 4 or 8 bytes caches in L1, so it copies only what no block of
// the launch writes: the coefficients, acc of the own tile (only its tile
// writes it) and the carries of the whole field and of a shard block. A ring
// shard's carries and raw field go through registers past L1 (RingGeo::ld,
// __ldcg): the sends of the same launch write their halo rows, and a
// 128-byte line may hold an own row's end and a halo row's start.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Whether the carries may go into the window by cp.async (see above).
template <class GEO> struct StateAsync { static constexpr bool value = true; };
template <> struct StateAsync<RingGeo> { static constexpr bool value = false; };

// n / d for 0 <= n < 2^32 / d, as a multiply-high by the rounded-up
// reciprocal m = ceil(2^32 / d): exact there, since m*d - 2^32 < d.
struct Quot {
  unsigned long long m;
  __device__ explicit Quot(int d) : m(0xFFFFFFFFull / (unsigned)d + 1) {}
  __device__ int operator()(int n) const { return (int)(((unsigned long long)n * m) >> 32); }
};

// Shared planes of one window: 2 carries, the array coefficients, post, pre
// (each (by+2H) x (bx+2H)), then acc of the own tile.
template <typename T>
__host__ __device__ inline size_t fused_shared_bytes(const FusedArgs<T>& a) {
  int planes = 2;
  for (int m = 0; m < 5; ++m) planes += a.coef[m] != nullptr;
  planes += (a.post != nullptr) + (a.pre != nullptr);
  const size_t wy = a.by + 2 * a.n_ops, wx = a.bx + 2 * a.n_ops;
  return (planes * wy * wx + (size_t)a.by * a.bx) * sizeof(T);
}

// Stencil shapes the kernel is compiled for. Every branch on them is
// resolved at compile time; GENERIC reads them from the arguments.
enum Mode {
  GENERIC = 0,  // any combination of zap, pre, post and coefficient arrays
  HSPACE = 1,   // no zap, no pre, post, c an array, n s e w constants (the
                // masked grids under the h-space elimination)
  FLUX = 2,     // zap, no pre, no post, c n s e w arrays (flux-form grids)
};

template <typename T, int MODE>
struct Tile {
  const FusedArgs<T>& a;
  T* sm;       // the window planes
  int wx;      // window width (pitch of every plane)
  int o_coef[5], o_post, o_pre, o_acc;  // plane offsets; -1: absent

  __device__ bool zap() const { return MODE == GENERIC ? a.zap != 0 : MODE == FLUX; }
  __device__ bool has_pre() const { return MODE == GENERIC && o_pre >= 0; }
  __device__ bool has_post() const { return MODE == GENERIC ? o_post >= 0 : MODE == HSPACE; }
  __device__ bool coef_array(int m) const {
    return MODE == GENERIC ? o_coef[m] >= 0 : MODE == FLUX || m == 0;
  }
  __device__ T coef(int m, int k) const { return coef_array(m) ? sm[o_coef[m] + k] : a.cval[m]; }
  __device__ T gat(T x, int k) const {
    return gather_value<true>(x, zap(), has_pre(), has_pre() ? sm[o_pre + k] : T(0));
  }
};

// Rows a thread steps per work item: it loads the strip's values first,
// then does the arithmetic (one latency per strip instead of one per row),
// and keeps the centre column in registers (a cell loads its east and west,
// and one more centre value).
constexpr int STRIP = 4;

// One step (kind KIND) of the window shrunk by j, rows [j, wy-j), columns
// [j, wx-j): cur holds T_k, prev T_{k-1}, T_{k+1} goes over prev. `pl` holds
// the planes (see fused_tile). A work item is a strip's column: (strip,
// column) pairs, column fastest, one per thread, so a warp's 32 lanes take
// 32 consecutive pairs across a strip's end and none idles where the
// window's width is not a multiple of 32.
template <typename T, int MODE, int KIND, class Geo, class P>
__device__ __forceinline__ void step_window(const Tile<T, MODE>& tl, const P& pl, const Geo geo,
                                            int j, int wy, int H, int y0, int x0, int cur,
                                            int prev, T p_a, int64_t b_own) {
  const FusedArgs<T>& a = tl.a;
  T* const sm = tl.sm;
  const int wx = tl.wx;
  const int rows = wy - 2 * j, cols = wx - 2 * j;
  const int pairs = (rows + STRIP - 1) / STRIP * cols;
  const Quot per_strip(cols);
  const int ny = geo.rows(), nx = geo.cols();
  for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
    const int s_i = per_strip(idx);
    const int q = j + idx - s_i * cols;
    const int r0 = j + s_i * STRIP;
    const int r1 = min(r0 + STRIP, wy - j);  // rows past r1 load row r1-1 and are not stored
    // loads: the centre column on rows r0-1 .. r0+STRIP, the rest on the strip
    T tc[STRIP + 2], te[STRIP], tw[STRIP], cf[STRIP][5], po[STRIP], tp[STRIP], ac[STRIP];
#pragma unroll
    for (int s = 0; s < STRIP + 2; ++s) tc[s] = sm[cur + min(r0 - 1 + s, r1) * wx + q];
    const unsigned ox = q - H;
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int k = min(r0 + s, r1 - 1) * wx + q;
      te[s] = sm[cur + k + 1];
      tw[s] = sm[cur + k - 1];
#pragma unroll
      for (int m = 0; m < 5; ++m) cf[s][m] = tl.coef(m, k);
      po[s] = tl.has_post() ? sm[tl.o_post + k] : T(0);
      tp[s] = KIND == FIRST ? T(0) : sm[prev + k];
      const unsigned oy = min(r0 + s, r1 - 1) - H;
      ac[s] = KIND != FIRST && oy < (unsigned)a.by && ox < (unsigned)a.bx
                  ? sm[tl.o_acc + (int)oy * a.bx + (int)ox] : T(0);
    }
    T g[STRIP + 2];
#pragma unroll
    for (int s = 0; s < STRIP + 2; ++s) g[s] = tl.gat(tc[s], min(r0 - 1 + s, r1) * wx + q);
#pragma unroll
    for (int s = 0; s < STRIP; ++s) {
      const int r = r0 + s;
      if (r >= r1) break;
      const int k = r * wx + q;
      const T ge = tl.gat(te[s], k + 1), gw = tl.gat(tw[s], k - 1);
      // a mirror cell's north is the window's south, its east the window's west
      const bool mir = geo.mirror(y0 - H + r);
      const T lap = lap_value(cf[s][0], cf[s][1], cf[s][2], cf[s][3], cf[s][4], g[s + 1],
                              mir ? g[s] : g[s + 2], mir ? g[s + 2] : g[s], mir ? gw : ge,
                              mir ? ge : gw, tl.has_post(), po[s]);
      const unsigned oy = r - H;
      const bool own = oy < (unsigned)a.by && ox < (unsigned)a.bx;
      const int o = tl.o_acc + (int)oy * a.bx + (int)ox;
      if (KIND == FIRST) {
        const T t1 = t1_value(lap, tc[s + 1]);
        sm[prev + k] = t1;
        if (own) sm[o] = acc_first(p_a, a.p_b, tc[s + 1], t1);
      } else if (KIND == MIDDLE) {
        const T nxt = next_value(tc[s + 1], lap, tp[s]);
        sm[prev + k] = nxt;
        if (own) sm[o] = acc_add(p_a, nxt, ac[s]);
      } else {
        // LAST: the window is the own tile
        const int gy = y0 + (int)oy, gx = x0 + (int)ox;
        if (gy < ny && gx < nx) {
          const T acc = acc_add(p_a, next_value(tc[s + 1], lap, tp[s]), ac[s]);
          const int64_t kk = geo.in_index(geo.row(gy), geo.col(gx, false));
          const int64_t ko = b_own + geo.own_index(gy, gx);
          pl.acc_out[ko] = finish_value(acc, at(pl.field_own, ko), pl.area != nullptr,
                                        at(pl.area, kk), a.drop_pre != 0, po[s], a.land_gain);
        }
      }
    }
  }
}

// Where a block's tile lies: the tile of its blockIdx, batch entry
// blockIdx.z (the grid of fused_pass_kernel) ... z() is unsigned, as
// blockIdx.z is: an int there changed the fused K1's registers and spills.
struct GridOrigin {
  __device__ int y0(int by) const { return blockIdx.y * by; }
  __device__ int x0(int bx) const { return blockIdx.x * bx; }
  __device__ unsigned z() const { return blockIdx.z; }
};

// ... or a tile that the block was handed, in an unbatched field.
struct TileOrigin {
  int ty, tx;
  __device__ int y0(int by) const { return ty * by; }
  __device__ int x0(int bx) const { return tx * bx; }
  __device__ unsigned z() const { return 0; }
};

// Issue the copies of the window of the tile at (y0, x0), batch bases b_in
// (the "in" planes) and b_own (acc), and of acc of its own cells; the caller
// commits them as a cp.async group and waits (cp_async_wait_all, then
// __syncthreads) before it reads them. Plane 0 takes t_prev, plane 1 t; a
// first pass takes the raw field into plane 0 and area into plane 1, which
// its first step overwrites with T_1 after the transform has read it. The
// window's cells are spread over the block's threads, row-major, so a
// warp's copies read consecutive cells of a plane; a row above the fold
// reads its real row reversed in x. Clamped rows of a shard block or a ring
// shard copy a source cell into several slots, each its own copy. On a ring
// shard (StateAsync false) the carries and the field go through registers,
// U cells a thread at a time: all their loads, then all their stores.
template <typename T, class Geo, int MODE, class P>
__device__ __forceinline__ void fused_window_load(const Tile<T, MODE>& tl, const P& pl,
                                                  const Geo geo, int wy, int H, int y0, int x0,
                                                  int64_t b_in, int64_t b_own) {
  const FusedArgs<T>& a = tl.a;
  T* const sm = tl.sm;
  const int wx = tl.wx, wa = wy * wx;
  const bool first = a.first != 0;
  const Quot per_row(wx);
  for (int k = threadIdx.x; k < wa; k += blockDim.x) {
    const int r = per_row(k), q = k - r * wx;
    const int gy = y0 - H + r;
    const int64_t kk = geo.in_index(geo.row(gy), geo.col(x0 - H + q, geo.mirror(gy)));
#pragma unroll
    for (int m = 0; m < 5; ++m)
      if (tl.coef_array(m)) cp_async(sm + tl.o_coef[m] + k, pl.coef[m] + kk);
    if (tl.has_post()) cp_async(sm + tl.o_post + k, pl.post + kk);
    if (tl.has_pre()) cp_async(sm + tl.o_pre + k, pl.pre + kk);
    if (first && pl.area) cp_async(sm + wa + k, pl.area + kk);
    if constexpr (StateAsync<Geo>::value) {
      if (first) {
        cp_async(sm + k, pl.field + b_in + kk);
      } else {
        cp_async(sm + k, pl.t_prev + b_in + kk);
        cp_async(sm + wa + k, pl.t + b_in + kk);
      }
    }
  }
  if constexpr (!StateAsync<Geo>::value) {
    constexpr int U = 4;
    const T* const s0 = first ? pl.field : pl.t_prev;
    for (int k0 = threadIdx.x; k0 < wa; k0 += U * blockDim.x) {
      T v[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * blockDim.x;
        if (k < wa) {
          const int r = per_row(k), q = k - r * wx;
          const int gy = y0 - H + r;
          const int64_t kk =
              b_in + geo.in_index(geo.row(gy), geo.col(x0 - H + q, geo.mirror(gy)));
          v[u][0] = geo.ld(s0, kk);
          v[u][1] = first ? T(0) : geo.ld(pl.t, kk);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * blockDim.x;
        if (k < wa) {
          sm[k] = v[u][0];
          if (!first) sm[wa + k] = v[u][1];
        }
      }
    }
  }
  if (!first) {
    const int ny = geo.rows(), nx = geo.cols();
    const Quot per_tile_row(a.bx);
    for (int i = threadIdx.x; i < a.by * a.bx; i += blockDim.x) {
      const int oy = per_tile_row(i);
      const int gy = y0 + oy, gx = x0 + i - oy * a.bx;
      if (gy < ny && gx < nx)
        cp_async(sm + tl.o_acc + i, pl.acc_in + b_own + geo.own_index(gy, gx));
      else
        sm[tl.o_acc + i] = T(0);
    }
  }
}

// One tile's pass, all of the block's threads, the dynamic shared memory its
// window: the own cells of the tile at `org`. `a` holds the pass (steps, p_a,
// tile, constants), `pl` the planes (field, field_own, t, t_prev, acc_in,
// t_out, t_prev_out, acc_out, coef, pre, post, area): the FusedArgs itself
// for fused_pass_kernel, a shard's row of a table for the ring. The geometry
// goes by value, here and into the load and the steps, as in vec_tile.cuh.
template <typename T, class Geo, int MODE, class P, class Org>
__device__ __forceinline__ void fused_tile(const FusedArgs<T>& a, const P& pl, const Geo geo,
                                           const Org& org) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.n_ops;
  const int wy = a.by + 2 * H, wx = a.bx + 2 * H, wa = wy * wx;
  // plane offsets in the window (offsets, not pointers, keep every access in
  // the shared address space); a plane that is absent has offset -1
  Tile<T, MODE> tl{a, reinterpret_cast<T*>(smem_raw), wx, {}, -1, -1, 0};
  int off = 2 * wa;
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    tl.o_coef[m] = pl.coef[m] ? off : -1;
    if (pl.coef[m]) off += wa;
  }
  tl.o_post = pl.post ? off : -1;
  if (pl.post) off += wa;
  tl.o_pre = pl.pre ? off : -1;
  if (pl.pre) off += wa;
  tl.o_acc = off;
  T* const sm = tl.sm;

  const bool has_area = pl.area != nullptr, drop_pre = a.drop_pre != 0;
  const int y0 = org.y0(a.by), x0 = org.x0(a.bx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int64_t b_in = (int64_t)org.z() * geo.in_plane();
  const int64_t b_own = (int64_t)org.z() * geo.own_plane();
  const int64_t b_out = (int64_t)org.z() * geo.out_plane();
  const int ny = geo.rows(), nx = geo.cols();

  // 1. the window, in one burst; on a first pass, T_0 in place
  fused_window_load(tl, pl, geo, wy, H, y0, x0, b_in, b_own);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (a.first && (has_area || drop_pre)) {
    for (int k = threadIdx.x; k < wa; k += blockDim.x)
      sm[k] = t0_value<true>(sm[k], has_area, sm[wa + k], drop_pre,
                             tl.has_post() ? sm[tl.o_post + k] : T(0));
    __syncthreads();
  }

  // 2. the steps. On a first pass plane 0 holds T_0 and FIRST writes T_1
  // into plane 1.
  int cur = a.first ? 0 : wa;
  int prev = a.first ? wa : 0;
  for (int i = 0; i < H; ++i) {
    const int j = i + 1;  // this step's window: shrunk by j
    if (a.first && i == 0)
      step_window<T, MODE, FIRST>(tl, pl, geo, j, wy, H, y0, x0, cur, prev, a.pa[i], b_own);
    else if (a.last && i == H - 1)
      step_window<T, MODE, LAST>(tl, pl, geo, j, wy, H, y0, x0, cur, prev, a.pa[i], b_own);
    else
      step_window<T, MODE, MIDDLE>(tl, pl, geo, j, wy, H, y0, x0, cur, prev, a.pa[i], b_own);
    __syncthreads();
    const int tmp = cur;
    cur = prev;
    prev = tmp;
  }
  if (a.last) return;

  // 3. the own cells of the carries and of acc
  for (int r = H + warp; r < H + a.by; r += nwarps) {
    const int gy = y0 - H + r;
    if (gy >= ny) break;
    for (int q = H + lane; q < H + a.bx; q += 32) {
      const int gx = x0 - H + q;
      if (gx >= nx) break;
      const int k = r * wx + q;
      pl.t_out[b_out + geo.out_index(gy, gx)] = sm[cur + k];
      pl.t_prev_out[b_out + geo.out_index(gy, gx)] = sm[prev + k];
      pl.acc_out[b_own + geo.own_index(gy, gx)] = sm[tl.o_acc + (r - H) * a.bx + (q - H)];
    }
  }
}

template <typename T, class Geo, int MODE>
__global__ void __launch_bounds__(FUSED_THREADS) fused_pass_kernel(const FusedArgs<T> a,
                                                                    const Geo geo) {
  fused_tile<T, Geo, MODE>(a, a, geo, GridOrigin{});
}

template <typename T, class Geo, int MODE>
int launch_mode(const FusedArgs<T>& a, const Geo& g, dim3 grid, size_t bytes, cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_pass_kernel<T, Geo, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fused_pass_kernel<T, Geo, MODE><<<grid, FUSED_THREADS, bytes, st>>>(a, g);
  return (int)cudaGetLastError();
}

// The compiled mode that fits the stencil's shape.
template <typename T>
int fused_mode(const FusedArgs<T>& a) {
  const bool c_only = a.coef[0] && !a.coef[1] && !a.coef[2] && !a.coef[3] && !a.coef[4];
  const bool all = a.coef[0] && a.coef[1] && a.coef[2] && a.coef[3] && a.coef[4];
  if (!a.zap && !a.pre && a.post && c_only) return HSPACE;
  if (a.zap && !a.pre && !a.post && all) return FLUX;
  return GENERIC;
}

// Launch one fused pass over the own domain of `geo`, tiles of by x bx, with
// the kernel compiled for the stencil's shape.
template <typename T, class Geo>
int launch_fused(const FusedArgs<T>& a, const Geo& g, int ny, int nx, int batch,
                 cudaStream_t st) {
  if (a.n_ops < 1 || a.n_ops > MAX_FUSE || a.by < 1 || a.bx < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = fused_shared_bytes(a);
  if (bytes > MAX_SHARED) return (int)cudaErrorInvalidValue;
  const dim3 grid((nx + a.bx - 1) / a.bx, (ny + a.by - 1) / a.by, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  switch (fused_mode(a)) {
    case HSPACE: return launch_mode<T, Geo, HSPACE>(a, g, grid, bytes, st);
    case FLUX: return launch_mode<T, Geo, FLUX>(a, g, grid, bytes, st);
    default: return launch_mode<T, Geo, GENERIC>(a, g, grid, bytes, st);
  }
}

// Fill the fields every fused entry passes the same way.
template <typename T>
FusedArgs<T> fused_args(int by, int bx, int n_ops, int first, int last, const double* pa,
                        double p_b, const T* field, const T* field_own, const T* t,
                        const T* t_prev,
                        const T* acc_in, T* t_out, T* t_prev_out, T* acc_out, const T* c,
                        const T* n, const T* s, const T* e, const T* w, double cv,
                        double nv, double sv, double ev, double wv, const T* pre,
                        const T* post, const T* area, double land_gain, int zap,
                        int drop_pre) {
  FusedArgs<T> a;
  a.by = by; a.bx = bx; a.n_ops = n_ops; a.first = first; a.last = last;
  for (int i = 0; i < MAX_FUSE; ++i) a.pa[i] = i < n_ops ? T(pa[i]) : T(0);
  a.p_b = T(p_b);
  a.field = field; a.field_own = field_own; a.t = t; a.t_prev = t_prev; a.acc_in = acc_in;
  a.t_out = t_out; a.t_prev_out = t_prev_out; a.acc_out = acc_out;
  a.coef[0] = c; a.coef[1] = n; a.coef[2] = s; a.coef[3] = e; a.coef[4] = w;
  a.cval[0] = T(cv); a.cval[1] = T(nv); a.cval[2] = T(sv); a.cval[3] = T(ev); a.cval[4] = T(wv);
  a.pre = pre; a.post = post; a.area = area;
  a.land_gain = T(land_gain);
  a.zap = zap; a.drop_pre = drop_pre;
  return a;
}

}  // namespace
