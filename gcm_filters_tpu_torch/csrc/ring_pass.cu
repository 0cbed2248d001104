// One Chebyshev step on the y-shards of a ring, with the halo exchange done
// by the kernel itself, for Hopper (sm_90a). Three entries:
//   ring_pass_f32/f64      scalar step   (the arithmetic of cheb_pass.cu)
//   vec_ring_pass_f32/f64  coupled step, op = BGRID or CTAP (vec_pass.cu)
//
// Replaces the ring mode of the TPU pass kernels:
// gcm_filters_tpu/ops/pallas/cheb_pass.py::build_ring_pass with its
// _WindowStreamer (remote copies `rem_desc`, the entry barrier, the block
// order `_pblk`), and the ring mode of
// gcm_filters_tpu/ops/pallas/vec_pass.py::_build_coupled_pass
// (build_vec_pass, build_ctap_pass with ring_axis). This file ports WHAT those
// kernels do, not their TPU layout: on the TPU a shard's kernel starts remote
// DMA of its edge rows into the neighbours' halo buffers, computes its
// interior blocks while the rows travel and its two edge blocks last, waiting
// on the receive semaphores only there. Here the remote copy is a plain store
// through a pointer into the neighbour's halo buffer, and the semaphore is a
// flag word written with release and read with acquire order.
//
// The field is cut into p shards of ly = ny/p rows along y; x is not cut, so
// the x wrap and the tripolar seam are local (the seam belongs to the top
// shard). Every shard is a set of separately allocated buffers, listed in one
// row of a pointer table in device memory. One launch runs ONE step of ALL
// shards (the steps are FIRST / MIDDLE / LAST of cheb_pass.cu and vec_pass.cu,
// with t_next written over t_prev and acc updated in place), so with one step
// per launch a cell reads its neighbours' `t` only, and the halo is one row per
// side: the C-grid's diagonal taps u[j+1, i-1] and v[j-1, i+1] stay inside
// that row because x is local. A halo row holds the already GATHERED values
// (area, masks and nan_to_num applied at the sender's own index), so a
// receiver needs no coefficient row of its neighbour.
//
// Work order. A launch has exactly one block per work item, and a block
// learns its item from an atomic ticket when it starts to run, in this order:
//   1. sends: for every shard, its bottom row into the down-neighbour's north
//      halo and its top row into the up-neighbour's south halo; then a release
//      store of this launch's epoch into the halo's flag word. A send waits for
//      nothing.
//   2. interior tiles of every shard (32 x 8 cells, one per thread, as in the
//      unsharded kernels): they read the shard's own rows only.
//   3. edge tiles (those holding row 0 or row ly-1): they wait, with acquire
//      order, until the flag of the halo they read holds this launch's epoch.
// A block that waits holds a ticket above every send's, so every send has
// been drawn by a block that already runs and never waits: each wait ends
// whatever order the hardware schedules blocks in. The ticket counter needs
// no reset either: every launch draws exactly `total` tickets, so a launch's
// item is ticket % total.
//
// Flags need no reset: the epoch grows by one with every launch and a flag is
// compared for equality with it. Buffer reuse (the TPU kernel's entry
// barrier): all shards share one launch and launches follow each other in
// stream order, so step k+1's sends cannot land while step k's edge tiles
// still read a halo. Two applies of one state on two streams at once are not
// supported, nor is replaying a launch from a CUDA graph (the epoch is an
// argument of the launch). The wait is bounded: it backs off with
// __nanosleep and traps after SPIN_LIMIT polls, so a protocol fault is a CUDA
// error, not a hang.
//
// Memory order: the halo stores of a send block are followed by
// __syncthreads, then one thread fences and stores the flag with release
// order; a reader's thread 0 loads the flag with acquire order, then
// __syncthreads, then the halo loads, which bypass L1 (__ldcg): no
// non-coherent load touches a buffer written in the same launch. The scope is
// .gpu: all shards live on this card. Shards on peer cards would need .sys.
//
// Bound: memory, as the unsharded steps: the same planes plus 2p halo rows
// written and read. The whole-filter bound is the unsharded one.
//
// Build without --use_fast_math: it breaks isnan/isinf in nan_to_num and the
// 0*fbar NaN poison.

#include <cstdio>

#include "cheb_step.cuh"
#include "vec_step.cuh"

namespace {

constexpr int TILE_X = 32;  // cells of a tile along x: one warp
constexpr int TILE_Y = 8;   // rows of a tile: one per warp
constexpr int THREADS = TILE_X * TILE_Y;
// Blocks per SM that the scalar kernel is compiled for (a cap of 32 registers,
// met without spills): a shard's pointers come from the table, not from the
// launch's parameters, and left alone they take the kernel to 66-80 registers
// and half the occupancy of the unsharded kernel, which on an H100 cost a
// memory-bound MIDDLE step about a quarter of its speed. The vector kernels
// were faster left alone.
constexpr int SCALAR_MIN_BLOCKS = 8;
constexpr long long SPIN_LIMIT = 1LL << 23;  // polls of >= 1 us each: seconds

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Thread 0 polls `flag` until it holds `epoch`; then the whole block goes on.
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned epoch, int tid) {
  if (tid == 0) {
    unsigned ns = 32;
    for (long long polls = 0; ld_acquire(flag) != epoch; ++polls) {
      if (polls > SPIN_LIMIT) {
        printf("ring_pass: halo flag %p never reached epoch %u (holds %u)\n",
               (const void*)flag, epoch, ld_acquire(flag));
        __trap();
      }
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
  }
  __syncthreads();
}

// After the block's halo stores: publish them under `flag`.
__device__ __forceinline__ void publish(unsigned* flag, unsigned epoch, int tid) {
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    st_release(flag, epoch);
  }
}

// What all shards of one launch share.
struct Ring {
  int p, ly, nx;            // shards, rows of a shard, cells of a row
  int tiles_x, tiles_y;     // tiles of a shard
  int swap;                 // 0: t = b, t_prev = a; 1: t = a, t_prev = b
  unsigned epoch;           // this launch's flag value
  unsigned long long* ticket;
};

enum ItemKind { SEND = 0, TILE = 1 };

struct Item {
  int what, shard;
  int side;    // SEND: 0 = bottom row to the down-neighbour, 1 = top row to the up-neighbour
  int tx, ty;  // TILE
};

__host__ __device__ inline long long interior_tiles(int tiles_x, int tiles_y) {
  return (long long)tiles_x * (tiles_y > 2 ? tiles_y - 2 : 0);
}

__host__ __device__ inline long long edge_tiles(int tiles_x, int tiles_y) {
  return (long long)tiles_x * (tiles_y < 2 ? tiles_y : 2);
}

__host__ __device__ inline long long total_items(int p, int tiles_x, int tiles_y) {
  return p * (2 + interior_tiles(tiles_x, tiles_y) + edge_tiles(tiles_x, tiles_y));
}

// The block's item: sends of every shard, then interior tiles, then edge tiles.
__device__ __forceinline__ Item draw_item(const Ring& q, int tid) {
  __shared__ unsigned long long drawn;
  if (tid == 0)
    drawn = atomicAdd(q.ticket, 1ULL) %
            (unsigned long long)total_items(q.p, q.tiles_x, q.tiles_y);
  __syncthreads();
  long long idx = (long long)drawn;
  Item it;
  if (idx < 2LL * q.p) {
    it.what = SEND; it.shard = (int)(idx / 2); it.side = (int)(idx % 2); it.tx = it.ty = 0;
    return it;
  }
  idx -= 2LL * q.p;
  it.what = TILE; it.side = 0;
  const long long n_int = interior_tiles(q.tiles_x, q.tiles_y);
  if (idx < q.p * n_int) {
    it.shard = (int)(idx / n_int);
    const long long rem = idx % n_int;
    it.ty = 1 + (int)(rem / q.tiles_x);
    it.tx = (int)(rem % q.tiles_x);
    return it;
  }
  idx -= q.p * n_int;
  const long long n_edge = edge_tiles(q.tiles_x, q.tiles_y);
  it.shard = (int)(idx / n_edge);
  const long long rem = idx % n_edge;
  it.ty = rem / q.tiles_x == 0 ? 0 : q.tiles_y - 1;
  it.tx = (int)(rem % q.tiles_x);
  return it;
}

// ---- scalar -----------------------------------------------------------------

// One row of the scalar pointer table: a shard's own buffers.
template <typename T>
struct Shard {
  const T* field;      // raw input rows
  T* a;                // carry: T_0 (FIRST's h), then every other T_k
  T* b;                // carry: T_1, then every other T_k
  T* acc;              // running sum; the result after LAST
  T* halo_s;           // gathered row below row 0, written by the down-neighbour
  T* halo_n;           // gathered row above row ly-1, written by the up-neighbour
  unsigned* flag_s;    // epoch of halo_s
  unsigned* flag_n;    // epoch of halo_n
  const T* coef[5];    // c, n, s, e, w rows (pre-scaled); null -> the launch's constant
  const T* pre;
  const T* post;
  const T* area;
};

// What the scalar step reads besides the table.
template <typename T>
struct ScalarStep {
  T cval[5];
  T p_a, p_b, land_gain;
  int zap, fold, drop_pre;
};

template <typename T, int KIND>
__device__ __forceinline__ Args<T> shard_args(const Ring& q, const ScalarStep<T>& s,
                                              const Shard<T>& sh) {
  Args<T> a;
  a.ny = q.ly; a.nx = q.nx;
  a.field = sh.field;
  a.t = q.swap ? sh.a : sh.b;
  a.t_prev = q.swap ? sh.b : sh.a;
  a.t_next = KIND == FIRST ? sh.b : (q.swap ? sh.b : sh.a);  // MIDDLE: over t_prev
  a.acc = sh.acc;
  a.h = sh.a;
  for (int m = 0; m < 5; ++m) { a.coef[m] = sh.coef[m]; a.cval[m] = s.cval[m]; }
  a.pre = sh.pre; a.post = sh.post; a.area = sh.area;
  a.p_a = s.p_a; a.p_b = s.p_b; a.land_gain = s.land_gain;
  a.zap = s.zap; a.fold = s.fold; a.drop_pre = s.drop_pre;
  return a;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(THREADS, SCALAR_MIN_BLOCKS)
ring_pass_kernel(const Ring q, const ScalarStep<T> s, const Shard<T>* __restrict__ table) {
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  const Item it = draw_item(q, tid);
  const Shard<T> me = table[it.shard];  // all pointers at once: one latency, not a chain
  const Args<T> a = shard_args<T, KIND>(q, s, me);
  const int nx = q.nx, ly = q.ly;

  if (it.what == SEND) {
    const int to = it.side ? (it.shard + 1) % q.p : (it.shard + q.p - 1) % q.p;
    T* out = it.side ? table[to].halo_s : table[to].halo_n;
    const int64_t row = it.side ? (int64_t)(ly - 1) * nx : 0;
    for (int i = tid; i < nx; i += THREADS) out[i] = gathered<T, KIND>(a, 0, row + i);
    publish(it.side ? table[to].flag_s : table[to].flag_n, q.epoch, tid);
    return;
  }

  // the seam folds the top shard's top row onto itself: it reads no north halo
  const bool folds = s.fold && it.shard == q.p - 1;
  if (it.ty == 0) wait_flag(me.flag_s, q.epoch, tid);
  if (it.ty == q.tiles_y - 1 && !folds) wait_flag(me.flag_n, q.epoch, tid);

  const int i = it.tx * TILE_X + threadIdx.x;
  const int j = it.ty * TILE_Y + threadIdx.y;
  if (i >= nx || j >= ly) return;
  const int64_t r = (int64_t)j * nx;
  const int64_t k = r + i;
  T gn, gs;
  if (j + 1 < ly) gn = gathered<T, KIND>(a, 0, k + nx);
  else if (folds) gn = gathered<T, KIND>(a, 0, r + (nx - 1 - i));
  else gn = __ldcg(me.halo_n + i);
  if (j > 0) gs = gathered<T, KIND>(a, 0, k - nx);
  else gs = __ldcg(me.halo_s + i);
  step_cell<T, KIND>(a, 0, k, gathered<T, KIND>(a, 0, k), gn, gs,
                     gathered<T, KIND>(a, 0, i + 1 < nx ? k + 1 : r),
                     gathered<T, KIND>(a, 0, i > 0 ? k - 1 : r + nx - 1));
}

// ---- vector -----------------------------------------------------------------

// One row of the vector pointer table: a shard's own buffers, each carry a
// stacked (2, ly, nx) pair, each halo a stacked (2, nx) pair of rows.
template <typename T>
struct VecShard {
  T* a;              // carry: the stacked input T_0, then every other T_k
  T* b;              // carry: T_1, then every other T_k
  T* acc;            // running sum; the result after LAST
  T* halo_s;
  T* halo_n;
  unsigned* flag_s;
  unsigned* flag_n;
  const T* coef;     // (n_coef, ly, nx) rows, pre-scaled
};

template <typename T>
struct VecStep {
  T p_a, p_b;
  int zap;
};

// The contraction input of a ring shard: offsets inside the plane read the
// shard's own rows, offsets below 0 the south halo row and offsets past the
// plane the north halo row, both already gathered by their senders.
template <typename T>
struct RingGather {
  Gather<T> own;
  const T* halo_s;
  const T* halo_n;
  int nx;
  __device__ __forceinline__ T operator()(int comp, int64_t k) const {
    if (k < 0) return __ldcg(halo_s + comp * nx + (k + nx));
    if (k >= own.plane) return __ldcg(halo_n + comp * nx + (k - own.plane));
    return own(comp, k);
  }
};

template <typename T, typename OP, int KIND>
__global__ void __launch_bounds__(THREADS)
vec_ring_pass_kernel(const Ring q, const VecStep<T> s, const VecShard<T>* __restrict__ table) {
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  const Item it = draw_item(q, tid);
  const VecShard<T>& me = table[it.shard];
  const int nx = q.nx, ly = q.ly;
  const int64_t P = (int64_t)ly * nx;

  VecArgs<T> a;
  a.ny = ly; a.nx = nx;
  a.w = me.a;
  a.t = q.swap ? me.a : me.b;
  a.t_prev = q.swap ? me.b : me.a;
  a.t_next = KIND == FIRST ? me.b : (q.swap ? me.b : me.a);  // MIDDLE: over t_prev
  a.acc = me.acc;
  a.coef = me.coef;
  a.p_a = s.p_a; a.p_b = s.p_b; a.zap = s.zap;
  const Gather<T> own{KIND == FIRST ? a.w : a.t, P, s.zap};

  if (it.what == SEND) {
    const int to = it.side ? (it.shard + 1) % q.p : (it.shard + q.p - 1) % q.p;
    T* out = it.side ? table[to].halo_s : table[to].halo_n;
    const int64_t row = it.side ? (int64_t)(ly - 1) * nx : 0;
    for (int i = tid; i < 2 * nx; i += THREADS) {
      const int comp = i >= nx;
      out[i] = own(comp, row + (i - comp * nx));
    }
    publish(it.side ? table[to].flag_s : table[to].flag_n, q.epoch, tid);
    return;
  }

  if (it.ty == 0) wait_flag(me.flag_s, q.epoch, tid);
  if (it.ty == q.tiles_y - 1) wait_flag(me.flag_n, q.epoch, tid);

  const int i = it.tx * TILE_X + threadIdx.x;
  const int j = it.ty * TILE_Y + threadIdx.y;
  if (i >= nx || j >= ly) return;
  const int ie = i + 1 < nx ? i + 1 : 0;
  const int iw = i > 0 ? i - 1 : nx - 1;
  const int64_t r = (int64_t)j * nx;
  const int64_t rn = j + 1 < ly ? r + nx : P;  // the north halo row follows the plane
  const int64_t rs = j > 0 ? r - nx : -nx;     // the south halo row precedes it
  Nbr x;
  x.c = r + i;
  x.n = rn + i;
  x.s = rs + i;
  x.e = r + ie;
  x.w = r + iw;
  x.nw = rn + iw;
  x.se = rs + ie;
  T lu, lv;
  OP::apply(a.coef, P, x, RingGather<T>{own, me.halo_s, me.halo_n, nx}, lu, lv);
  vec_step_cell<T, KIND>(a, x.c, P + x.c, x.c, P + x.c, true, lu, lv);
}

// ---- launches ---------------------------------------------------------------

bool ring_geometry(int p, int ly, int nx, int kind, int swap, unsigned epoch, void* ticket,
                   Ring* q) {
  if (p < 2 || ly < 1 || nx < 1 || !ticket) return false;
  if (kind != FIRST && kind != MIDDLE && kind != LAST) return false;
  q->p = p; q->ly = ly; q->nx = nx;
  q->tiles_x = (nx + TILE_X - 1) / TILE_X;
  q->tiles_y = (ly + TILE_Y - 1) / TILE_Y;
  q->swap = swap ? 1 : 0;
  q->epoch = epoch;
  q->ticket = static_cast<unsigned long long*>(ticket);
  return total_items(p, q->tiles_x, q->tiles_y) <= 0x7fffffffLL;
}

template <typename T>
int launch_scalar(int kind, int swap, int p, int ly, int nx, const void* table, void* ticket,
                  unsigned epoch, double cv, double nv, double sv, double ev, double wv,
                  double p_a, double p_b, double land_gain, int zap, int fold, int drop_pre,
                  void* stream) {
  cudaGetLastError();  // clear a stale error so the result below is this launch's
  Ring q;
  if (!table || !ring_geometry(p, ly, nx, kind, swap, epoch, ticket, &q))
    return (int)cudaErrorInvalidValue;
  ScalarStep<T> s;
  s.cval[0] = T(cv); s.cval[1] = T(nv); s.cval[2] = T(sv); s.cval[3] = T(ev); s.cval[4] = T(wv);
  s.p_a = T(p_a); s.p_b = T(p_b); s.land_gain = T(land_gain);
  s.zap = zap; s.fold = fold; s.drop_pre = drop_pre;
  const Shard<T>* tab = static_cast<const Shard<T>*>(table);
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((unsigned)total_items(p, q.tiles_x, q.tiles_y));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case FIRST: ring_pass_kernel<T, FIRST><<<grid, block, 0, st>>>(q, s, tab); break;
    case MIDDLE: ring_pass_kernel<T, MIDDLE><<<grid, block, 0, st>>>(q, s, tab); break;
    default: ring_pass_kernel<T, LAST><<<grid, block, 0, st>>>(q, s, tab); break;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename OP>
void launch_vec_kind(int kind, dim3 grid, dim3 block, cudaStream_t st, const Ring& q,
                     const VecStep<T>& s, const VecShard<T>* tab) {
  switch (kind) {
    case FIRST: vec_ring_pass_kernel<T, OP, FIRST><<<grid, block, 0, st>>>(q, s, tab); break;
    case MIDDLE: vec_ring_pass_kernel<T, OP, MIDDLE><<<grid, block, 0, st>>>(q, s, tab); break;
    default: vec_ring_pass_kernel<T, OP, LAST><<<grid, block, 0, st>>>(q, s, tab); break;
  }
}

template <typename T>
int launch_vector(int op, int kind, int swap, int p, int ly, int nx, const void* table,
                  void* ticket, unsigned epoch, double p_a, double p_b, int zap, void* stream) {
  cudaGetLastError();  // clear a stale error so the result below is this launch's
  Ring q;
  if (!table || !ring_geometry(p, ly, nx, kind, swap, epoch, ticket, &q))
    return (int)cudaErrorInvalidValue;
  if (op != BGRID && op != CTAP) return (int)cudaErrorInvalidValue;
  VecStep<T> s;
  s.p_a = T(p_a); s.p_b = T(p_b); s.zap = zap;
  const VecShard<T>* tab = static_cast<const VecShard<T>*>(table);
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((unsigned)total_items(p, q.tiles_x, q.tiles_y));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == BGRID) launch_vec_kind<T, BGridLap>(kind, grid, block, st, q, s, tab);
  else launch_vec_kind<T, CTapLap>(kind, grid, block, st, q, s, tab);
  return (int)cudaGetLastError();
}

}  // namespace

#define RING_PASS_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(int kind, int swap, int p, int ly, int nx, const void* table,       \
                      void* ticket, unsigned epoch, double cv, double nv, double sv,      \
                      double ev, double wv, double p_a, double p_b, double land_gain,     \
                      int zap, int fold, int drop_pre, void* stream) {                    \
    return launch_scalar<T>(kind, swap, p, ly, nx, table, ticket, epoch, cv, nv, sv, ev,  \
                            wv, p_a, p_b, land_gain, zap, fold, drop_pre, stream);        \
  }

RING_PASS_ENTRY(ring_pass_f32, float)
RING_PASS_ENTRY(ring_pass_f64, double)

#define VEC_RING_PASS_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(int op, int kind, int swap, int p, int ly, int nx,                  \
                      const void* table, void* ticket, unsigned epoch, double p_a,        \
                      double p_b, int zap, void* stream) {                                \
    return launch_vector<T>(op, kind, swap, p, ly, nx, table, ticket, epoch, p_a, p_b,    \
                            zap, stream);                                                 \
  }

VEC_RING_PASS_ENTRY(vec_ring_pass_f32, float)
VEC_RING_PASS_ENTRY(vec_ring_pass_f64, double)

// Pointers in one row of the scalar and of the vector table, for the wrapper.
extern "C" int ring_pass_table_row(int vector) {
  return (int)((vector ? sizeof(VecShard<float>) : sizeof(Shard<float>)) / sizeof(void*));
}

extern "C" const char* ring_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
