// Double-f32 (df64) GEMV passes of the Woodbury preconditioner apply.
//
// Replaces the TPU kernels mlff_tpu/ops/pallas_df64.py::_bt_v_kernel
// (u = B^T v, reached through df64_bt_v) and ::_b_x_kernel (y = B x, through
// df64_b_x).  B (n, m) is stored row-major as an f32 (hi, lo) pair; the
// vector comes in as f64 and is split into (hi, lo) inside the kernel, and
// the result goes out as f64.  Per element, with b = (bh, bl), v = (vh, vl):
//
//     (ph, pe) = two_prod(bh, vh)            error-free hi*hi product
//     pe      += bh*vl + bl*vh               2^-24-small cross terms
//     acc      = df64_add(acc, (ph, pe))     compensated accumulation
//
// Arithmetic.  two_prod is p = a*b, e = fmaf(a, b, -p): exact, and equal to
// the Veltkamp/Dekker split the TPU (and the plain PyTorch version) uses.
// Every other add and multiply is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fsub_rn, __fmul_rn), which nvcc never contracts into an FMA
// or reorders, so TwoSum and FastTwoSum stay error-free without -fmad=false.
//
// What bounds it on the H100.  Both passes read the (hi, lo) pair once:
// 8 bytes per element against ~18 f32 operations, so the bytes bound them
// by ~9x.  Instruction slots are not free either: ~24 thread-instructions per
// element are about a third of the byte bound, so the design also saves
// memory instructions.  What it does:
//
//   Streaming.  One persistent block per SM.  B moves through a ring of
//   shared-memory stages of ROWS x COLS elements of Bh and of Bl.  A producer
//   warp fills a stage with one asynchronous bulk copy per row segment
//   (cp.async.bulk, completion reported to the stage's "full" mbarrier);
//   twelve consumer warps compute and hand the stage back through its
//   "empty" mbarrier.  With four stages ~190 KB are in flight per SM and no
//   thread spends registers or load instructions on B.  Block b takes the
//   8-row panels b, b + grid, ... in both passes, so that the blocks read
//   one moving window of B together.  The copies want 16-byte aligned
//   segments, which every row segment is when m % 4 == 0.  For other m
//   (kernel<false>) the consumers fill one stage themselves with 4-byte
//   loads, zero-padding it to whole groups of four columns, and compute
//   from it with the same code.
//   16-byte reads.  A lane owns four neighbouring columns and reads Bh and
//   Bl from the stage as float4; consumer warp w takes columns
//   128 * (w % 6) + 4 * lane and rows 4 * (w / 6) .. + 3 of the stage.
//   Nothing the consumers need per stage comes from global memory past L1:
//   such a load queues behind the ~190 KB of bulk copies the SM has in
//   flight and takes microseconds.  b_x reads x from L1, where it stays;
//   bt_v gets the panel's eight v with the stage.  Each is split once per
//   thread: in b_x four x values serve 16 elements, in bt_v one v value
//   serves the row's four columns.
//   b_x    a thread keeps 4 rows x 4 columns of accumulators over all column
//          chunks of an 8-row panel; the four rows are reduced across the
//          warp together in a transposing butterfly (6 compensated adds
//          instead of 20), the six column warps meet in shared memory.
//   bt_v   one launch.  Slab s is the panels s, s + n_slabs, ...; a block
//          takes a slab times up to GROUP neighbouring column chunks, one
//          such unit per block where B is large, and keeps every chunk's
//          sums in registers, so that it reads whole rows.  It writes the
//          unit's (hi, lo) partial and draws a ticket (atomicAdd on a
//          counter, after __threadfence(); never on data) at its node of a
//          FAN-ary tree over the slabs; the block that draws a node's last
//          ticket adds the node's partials in slab order into the next
//          level and draws there, and the top node's goes to u.  The tree
//          and its orders are fixed, so the result is the same bit for bit
//          from run to run; only which block does the adding varies.  One
//          block adding all slabs would pull them through one SM's port in
//          ~15 us; the tree leaves ~3 us per level behind the last block.
//
// Accumulation order.  No thread runs a long sequential df64 sum: a bt_v
// thread adds half of a slab's rows (at most 320 terms) into one
// accumulator per column, a b_x thread m / 768 terms into one per (row,
// column mod 4); accumulators, row sets, warps and slabs are combined in
// fixed trees and fixed orders.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// The launch geometry; ops/df64_gemv.py::plan mirrors these.
constexpr int ROWS = 8;                   // rows of B in a stage
constexpr int COLS = 768;                 // columns of B in a stage
constexpr int COL_WARPS = COLS / 128;     // a warp spans 32 lanes x 4 columns
constexpr int ROW_SETS = 2;               // consumer warps: 2 sets of COL_WARPS
constexpr int ROWS_T = ROWS / ROW_SETS;   // rows per thread per stage
constexpr int CONSUMERS = 32 * COL_WARPS * ROW_SETS;
constexpr int NT = CONSUMERS + 32;        // and the producer warp
constexpr int STAGE_FLOATS = ROWS * COLS;
constexpr int STAGE_BYTES = 2 * STAGE_FLOATS * 4 + 128;  // Bh, Bl, v
constexpr int FAN = 8;                    // bt_v: partials added at a tree node
constexpr int GROUP = 5;                  // bt_v: column chunks walked together
constexpr int RED_BYTES = GROUP * (CONSUMERS / 2) * 4 * 8;  // cross-warp sums
constexpr int BAR_BYTES = 256;            // mbarriers and the ticket flag
constexpr int MAX_STAGES = 8;
constexpr uint32_t SPIN_LIMIT = 1u << 26;  // a wait this long is a fault

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void fast_two_sum(float a, float b, float& s,
                                             float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// (xh, xl) += (yh, yl)
__device__ __forceinline__ void df64_acc(float& xh, float& xl, float yh,
                                         float yl) {
  float sh, se;
  two_sum(xh, yh, sh, se);
  se = __fadd_rn(se, __fadd_rn(xl, yl));
  fast_two_sum(sh, se, xh, xl);
}

// (xh, xl) += (bh, bl) * (vh, vl), the product rounded to a df64 pair first
__device__ __forceinline__ void df64_fma(float& xh, float& xl, float bh,
                                         float bl, float vh, float vl) {
  const float ph = __fmul_rn(bh, vh);
  float pe = __fmaf_rn(bh, vh, -ph);
  pe = __fadd_rn(pe, __fadd_rn(__fmul_rn(bh, vl), __fmul_rn(bl, vh)));
  df64_acc(xh, xl, ph, pe);
}

// four neighbouring columns of one row of B^T v
__device__ __forceinline__ void df64_fma4(float (&xh)[4], float (&xl)[4],
                                          const float4& bh, const float4& bl,
                                          float vh, float vl) {
  df64_fma(xh[0], xl[0], bh.x, bl.x, vh, vl);
  df64_fma(xh[1], xl[1], bh.y, bl.y, vh, vl);
  df64_fma(xh[2], xl[2], bh.z, bl.z, vh, vl);
  df64_fma(xh[3], xl[3], bh.w, bl.w, vh, vl);
}

// four neighbouring columns of one row of B x
__device__ __forceinline__ void df64_fma4(float (&xh)[4], float (&xl)[4],
                                          const float4& bh, const float4& bl,
                                          const float (&vh)[4],
                                          const float (&vl)[4]) {
  df64_fma(xh[0], xl[0], bh.x, bl.x, vh[0], vl[0]);
  df64_fma(xh[1], xl[1], bh.y, bl.y, vh[1], vl[1]);
  df64_fma(xh[2], xl[2], bh.z, bl.z, vh[2], vl[2]);
  df64_fma(xh[3], xl[3], bh.w, bl.w, vh[3], vl[3]);
}

__device__ __forceinline__ void split(double x, float& h, float& l) {
  h = __double2float_rn(x);
  l = __double2float_rn(x - (double)h);
}

__device__ __forceinline__ float shfl_xor(float x, int off) {
  return __shfl_xor_sync(0xffffffffu, x, off);
}

// -- mbarriers, bulk copies, the consumers' barrier -------------------------

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  A fault
// in the pipeline would show as a hang: trap instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > SPIN_LIMIT) __trap();
  }
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned); completion is counted on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// The shared-memory layout and the ring's state, the same in both kernels.
struct Ring {
  unsigned char* stages;
  float2* red;
  uint32_t full, empty;   // shared addresses of the mbarrier arrays
  int* flag;
  int n_stages, stage, phase;

  __device__ Ring(unsigned char* smem, int n_stages_) {
    stages = smem;
    red = reinterpret_cast<float2*>(smem + (size_t)n_stages_ * STAGE_BYTES);
    unsigned char* bars = smem + (size_t)n_stages_ * STAGE_BYTES + RED_BYTES;
    full = shared_addr(bars);
    empty = full + 8 * MAX_STAGES;
    flag = reinterpret_cast<int*>(bars + 16 * MAX_STAGES);
    n_stages = n_stages_;
    stage = 0;
    phase = 0;
  }
  __device__ void init_barriers() {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the current stage: Bh, Bl at + STAGE_FLOATS, the rows' v behind both
  __device__ const float* bh() const {
    return reinterpret_cast<const float*>(stages + (size_t)stage * STAGE_BYTES);
  }
  __device__ const double* v() const {
    return reinterpret_cast<const double*>(bh() + 2 * STAGE_FLOATS);
  }
  __device__ void advance() {
    if (++stage == n_stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // producer warp: rows row0 .. row0 + rv - 1, columns col0 .. col0 + cw - 1
  // of Bh and Bl into the next stage, one row segment per lane and array;
  // with gv, also the whole pairs of gv[row0 .. row0 + rv - 1]
  __device__ void produce(const float* gh, const float* gl, int m, int row0,
                          int rv, int col0, int cw, int lane,
                          const double* gv = nullptr) {
    mbar_wait(empty + 8 * stage, phase ^ 1);
    const uint32_t bar = full + 8 * stage;
    const uint32_t v_bytes = gv ? 16u * (rv / 2) : 0u;
    if (lane == 0) mbar_expect_tx(bar, 8u * rv * cw + v_bytes);
    __syncwarp();
    if (lane < rv) {
      const size_t g = (size_t)(row0 + lane) * m + col0;
      const uint32_t dst = shared_addr(bh()) + 4u * lane * COLS;
      bulk_copy(dst, gh + g, 4u * cw, bar);
      bulk_copy(dst + 4u * STAGE_FLOATS, gl + g, 4u * cw, bar);
    }
    if (lane == 31 && v_bytes)
      bulk_copy(shared_addr(v()), gv + row0, v_bytes, bar);
    advance();
  }
  __device__ void wait_full() const { mbar_wait(full + 8 * stage, phase); }
  __device__ void release(int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    advance();
  }
  // consumers, where no bulk copy applies: the same tile into stage 0 with
  // 4-byte loads, zero beyond rv rows and up to a multiple of 4 columns
  __device__ void fill(const float* gh, const float* gl, int m, int row0,
                       int rv, int col0, int cw, int tid) {
    float* sh = reinterpret_cast<float*>(stages);
    const int cw4 = (cw + 3) / 4 * 4;
    consumer_sync();
#pragma unroll 4
    for (int i = tid; i < ROWS * cw4; i += CONSUMERS) {
      const int r = i / cw4, c = i % cw4;
      const bool in = r < rv && c < cw;
      const size_t g = (size_t)(row0 + r) * m + col0 + c;
      sh[r * COLS + c] = in ? gh[g] : 0.f;
      sh[STAGE_FLOATS + r * COLS + c] = in ? gl[g] : 0.f;
    }
    consumer_sync();
  }
};

// Row set 1 hands its sums of every chunk of the group to row set 0 of the
// same columns, which adds them to its own.
__device__ __forceinline__ void add_row_sets(float (&h)[GROUP][4],
                                             float (&l)[GROUP][4], float2* red,
                                             int gc, int row_set, int slot) {
  if (row_set == 1) {
#pragma unroll
    for (int c = 0; c < GROUP; ++c)
      if (c < gc) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(c * (CONSUMERS / 2) + slot) * 4 + j] =
              make_float2(h[c][j], l[c][j]);
      }
  }
  consumer_sync();
  if (row_set == 0) {
#pragma unroll
    for (int c = 0; c < GROUP; ++c)
      if (c < gc) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 o = red[(c * (CONSUMERS / 2) + slot) * 4 + j];
          df64_acc(h[c][j], l[c][j], o.x, o.y);
        }
      }
  }
}

// nodes of the tree over `count` partials: one ticket each
__device__ __forceinline__ int tree_nodes(int count) {
  int nodes = 0;
  do {
    count = (count + FAN - 1) / FAN;
    nodes += count;
  } while (count > 1);
  return nodes;
}

// After every consumer thread's stores: draw a ticket; true in the whole
// block if it was the last of `count`, whose drawer resets the counter.
// What the other drawers stored before their tickets is then visible.
__device__ __forceinline__ bool last_ticket(int* ticket, int count, int* flag,
                                            int tid) {
  __threadfence();
  consumer_sync();
  if (tid == 0) {
    const bool last = atomicAdd(ticket, 1) == count - 1;
    if (last) *ticket = 0;
    *flag = last;
  }
  consumer_sync();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// Rows first .. first + count - 1 (count <= FAN) of the partials, columns
// col_lo .. col_lo + cols - 1, added in row order (even rows into one
// accumulator, odd rows into the other, then the two) into row `out` of the
// partials or, at the tree's top, into u.  A thread takes four columns at a
// time, four rows' loads in flight at once, and reads past L1:
// other SMs wrote the partials.
template <bool TOP>
__device__ __forceinline__ void add_partials(float* part_h, float* part_l,
                                             int mp, int first, int count,
                                             int col_lo, int cols, int out,
                                             double* u, int tid) {
  for (int c = 4 * tid; c < cols; c += 4 * CONSUMERS) {
    const size_t o = (size_t)first * mp + col_lo + c;
    float h[2][4] = {}, l[2][4] = {};
#pragma unroll
    for (int i0 = 0; i0 < FAN; i0 += FAN / 2) {
      float4 ph[FAN / 2], pl[FAN / 2];
#pragma unroll
      for (int i = 0; i < FAN / 2; ++i) {
        if (i0 + i < count) {
          const size_t oi = o + (size_t)(i0 + i) * mp;
          ph[i] = __ldcg(reinterpret_cast<const float4*>(part_h + oi));
          pl[i] = __ldcg(reinterpret_cast<const float4*>(part_l + oi));
        }
      }
#pragma unroll
      for (int i = 0; i < FAN / 2; ++i) {
        if (i0 + i < count) {
          df64_acc(h[i % 2][0], l[i % 2][0], ph[i].x, pl[i].x);
          df64_acc(h[i % 2][1], l[i % 2][1], ph[i].y, pl[i].y);
          df64_acc(h[i % 2][2], l[i % 2][2], ph[i].z, pl[i].z);
          df64_acc(h[i % 2][3], l[i % 2][3], ph[i].w, pl[i].w);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) df64_acc(h[0][j], l[0][j], h[1][j], l[1][j]);
    if (TOP) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < cols) u[col_lo + c + j] = (double)h[0][j] + (double)l[0][j];
    } else {
      const size_t oo = (size_t)out * mp + col_lo + c;
      *reinterpret_cast<float4*>(part_h + oo) =
          make_float4(h[0][0], h[0][1], h[0][2], h[0][3]);
      *reinterpret_cast<float4*>(part_l + oo) =
          make_float4(l[0][0], l[0][1], l[0][2], l[0][3]);
    }
  }
}

// Pass 1: u = B^T v.  Slab s is the 8-row panels s, s + n_slabs, ...: the
// blocks then read one moving window of B together, as in b_x.  A unit is a
// slab times a group of up to GROUP neighbouring column chunks,
// uid = slab * n_groups + group; block b takes units b, b + gridDim.x, ...
// and walks each panel chunk by chunk, in long contiguous runs.  A thread
// sums rows 4 * row_set + k, k < 4, of each stage into the accumulators of
// its four columns of that chunk.  The panel's v comes with the stage of its
// first chunk: a load from global memory would wait behind the bulk copies
// the SM has in flight.
template <bool BULK>
__global__ void __launch_bounds__(NT, 1)
bt_v_kernel(const float* __restrict__ gh, const float* __restrict__ gl,
            const double* __restrict__ gv, float* part_h, float* part_l,
            int* tickets, double* __restrict__ u, int n, int m, int n_slabs,
            int group_chunks, int n_stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring(smem, n_stages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (BULK && tid == 0) ring.init_barriers();
  __syncthreads();
  const int n_chunks = (m + COLS - 1) / COLS;
  const int n_groups = (n_chunks + group_chunks - 1) / group_chunks;
  const int n_units = n_slabs * n_groups;
  const int n_panels = (n + ROWS - 1) / ROWS;
  const int mp = (m + 3) / 4 * 4;   // row length of the partials

  if (warp == CONSUMERS / 32) {     // the producer warp
    if (!BULK) return;
    for (int uid = blockIdx.x; uid < n_units; uid += gridDim.x) {
      const int c_lo = (uid % n_groups) * group_chunks;
      const int c_hi = min(n_chunks, c_lo + group_chunks);
      for (int p = uid / n_groups; p < n_panels; p += n_slabs)
        for (int c = c_lo; c < c_hi; ++c)
          ring.produce(gh, gl, m, p * ROWS, min(ROWS, n - p * ROWS), c * COLS,
                       min(COLS, m - c * COLS), lane, c == c_lo ? gv : nullptr);
    }
    return;
  }

  const int row_set = warp / COL_WARPS;
  const int slot = (warp % COL_WARPS) * 32 + lane;
  const int col = 4 * slot;         // first of the thread's columns in a stage
  for (int uid = blockIdx.x; uid < n_units; uid += gridDim.x) {
    const int group = uid % n_groups, slab = uid / n_groups;
    const int c_lo = group * group_chunks;
    const int gc = min(group_chunks, n_chunks - c_lo);
    float ah[GROUP][4] = {}, al[GROUP][4] = {};
    for (int p = slab; p < n_panels; p += n_slabs) {
      const int row0 = p * ROWS, rv = min(ROWS, n - row0);
      float vh[ROWS_T], vl[ROWS_T];
#pragma unroll
      for (int c = 0; c < GROUP; ++c) {
        if (c < gc) {
          const int col0 = (c_lo + c) * COLS, cw = min(COLS, m - col0);
          if (BULK) ring.wait_full();
          else ring.fill(gh, gl, m, row0, rv, col0, cw, tid);
          if (c == 0) {
#pragma unroll
            for (int k = 0; k < ROWS_T; ++k) {
              const int r = row_set * ROWS_T + k;
              double vd = 0.0;
              if (BULK && r < rv / 2 * 2) vd = ring.v()[r];
              else if (r < rv) vd = __ldg(gv + row0 + r);
              split(vd, vh[k], vl[k]);
            }
          }
          if (col < cw) {
            const float* sh = ring.bh() + col;
#pragma unroll
            for (int k = 0; k < ROWS_T; ++k) {
              const int r = row_set * ROWS_T + k;
              if (r < rv) {
                const float4 bh =
                    *reinterpret_cast<const float4*>(sh + r * COLS);
                const float4 bl = *reinterpret_cast<const float4*>(
                    sh + STAGE_FLOATS + r * COLS);
                df64_fma4(ah[c], al[c], bh, bl, vh[k], vl[k]);
              }
            }
          }
          if (BULK) ring.release(lane);
        }
      }
    }
    // the unit's partial: row set 1 joins row set 0, which stores it
    add_row_sets(ah, al, ring.red, gc, row_set, slot);
    if (row_set == 0) {
#pragma unroll
      for (int c = 0; c < GROUP; ++c) {
        const int col0 = (c_lo + c) * COLS;
        if (c < gc && col < m - col0) {
          const size_t o = (size_t)slab * mp + col0 + col;
          *reinterpret_cast<float4*>(part_h + o) =
              make_float4(ah[c][0], ah[c][1], ah[c][2], ah[c][3]);
          *reinterpret_cast<float4*>(part_l + o) =
              make_float4(al[c][0], al[c][1], al[c][2], al[c][3]);
        }
      }
    }
    // A tree over the slabs' partials, FAN to a node, in fixed order.  The
    // block that draws a node's last ticket adds the node's rows of the
    // scratch into one row of the next level (the levels lie one after
    // another), and at the top into u.
    const int col_lo = c_lo * COLS, cols = min(gc * COLS, m - col_lo);
    int* ticket = tickets + group * tree_nodes(n_slabs);
    for (int idx = slab, count = n_slabs, base = 0;;) {
      const int nodes = (count + FAN - 1) / FAN, node = idx / FAN;
      const int first = node * FAN, k = min(FAN, count - first);
      if (!last_ticket(ticket + node, k, ring.flag, tid)) break;
      if (nodes == 1) {
        add_partials<true>(part_h, part_l, mp, base + first, k, col_lo, cols,
                           0, u, tid);
        break;
      }
      add_partials<false>(part_h, part_l, mp, base + first, k, col_lo, cols,
                          base + count + node, nullptr, tid);
      ticket += nodes;
      base += count;
      idx = node;
      count = nodes;
    }
  }
}

// Pass 2: y = B x.  Block b takes the 8-row panels b, b + gridDim.x, ...,
// each in column chunks of COLS.  A thread keeps 4 rows x 4 columns of sums.
// x is read from global memory: it is small enough to stay in L1.
template <bool BULK>
__global__ void __launch_bounds__(NT, 1)
b_x_kernel(const float* __restrict__ gh, const float* __restrict__ gl,
           const double* __restrict__ x, double* __restrict__ y, int n, int m,
           int n_stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring(smem, n_stages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (BULK && tid == 0) ring.init_barriers();
  __syncthreads();
  const int n_chunks = (m + COLS - 1) / COLS;
  const int n_panels = (n + ROWS - 1) / ROWS;

  if (warp == CONSUMERS / 32) {     // the producer warp
    if (!BULK) return;
    for (int p = blockIdx.x; p < n_panels; p += gridDim.x)
      for (int c = 0; c < n_chunks; ++c)
        ring.produce(gh, gl, m, p * ROWS, min(ROWS, n - p * ROWS), c * COLS,
                     min(COLS, m - c * COLS), lane);
    return;
  }

  const int row_set = warp / COL_WARPS, col_warp = warp % COL_WARPS;
  const int col = 4 * (col_warp * 32 + lane);
  int parity = 0;                   // which half of red this panel uses
  for (int p = blockIdx.x; p < n_panels; p += gridDim.x, parity ^= 1) {
    const int row0 = p * ROWS, rv = min(ROWS, n - row0);
    float ah[ROWS_T][4] = {}, al[ROWS_T][4] = {};
    for (int c = 0; c < n_chunks; ++c) {
      const int col0 = c * COLS, cw = min(COLS, m - col0);
      double xd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xd[j] = col + j < cw ? __ldg(x + col0 + col + j) : 0.0;
      if (BULK) ring.wait_full();
      else ring.fill(gh, gl, m, row0, rv, col0, cw, tid);
      if (col < cw) {
        float xh[4], xl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) split(xd[j], xh[j], xl[j]);
        const float* sh = ring.bh() + col;
#pragma unroll
        for (int k = 0; k < ROWS_T; ++k) {
          const int r = row_set * ROWS_T + k;
          if (r < rv) {
            const float4 bh = *reinterpret_cast<const float4*>(sh + r * COLS);
            const float4 bl = *reinterpret_cast<const float4*>(
                sh + STAGE_FLOATS + r * COLS);
            df64_fma4(ah[k], al[k], bh, bl, xh, xl);
          }
        }
      }
      if (BULK) ring.release(lane);
    }
    // each row's four column sums: (0 + 1) + (2 + 3)
    float h[ROWS_T], l[ROWS_T];
#pragma unroll
    for (int k = 0; k < ROWS_T; ++k) {
      df64_acc(ah[k][0], al[k][0], ah[k][1], al[k][1]);
      df64_acc(ah[k][2], al[k][2], ah[k][3], al[k][3]);
      df64_acc(ah[k][0], al[k][0], ah[k][2], al[k][2]);
      h[k] = ah[k][0];
      l[k] = al[k][0];
    }
    // transposing butterfly over the warp: lanes with bit 4 set keep rows
    // 2, 3 and give rows 0, 1 away, the others the reverse; then bit 3
    // halves again, and three plain steps finish the one row a lane holds
    const bool up = lane & 16, up2 = lane & 8;
    float k0h = up ? h[2] : h[0], k0l = up ? l[2] : l[0];
    float k1h = up ? h[3] : h[1], k1l = up ? l[3] : l[1];
    df64_acc(k0h, k0l, shfl_xor(up ? h[0] : h[2], 16),
             shfl_xor(up ? l[0] : l[2], 16));
    df64_acc(k1h, k1l, shfl_xor(up ? h[1] : h[3], 16),
             shfl_xor(up ? l[1] : l[3], 16));
    float rh = up2 ? k1h : k0h, rl = up2 ? k1l : k0l;
    df64_acc(rh, rl, shfl_xor(up2 ? k0h : k1h, 8),
             shfl_xor(up2 ? k0l : k1l, 8));
#pragma unroll
    for (int off = 4; off > 0; off /= 2) {
      const float oh = shfl_xor(rh, off), ol = shfl_xor(rl, off);
      df64_acc(rh, rl, oh, ol);
    }
    // lane 8 k holds row k of the warp's four; the column warps meet in red
    float2* red = ring.red + parity * ROWS * COL_WARPS;
    if (lane % 8 == 0)
      red[(row_set * ROWS_T + lane / 8) * COL_WARPS + col_warp] =
          make_float2(rh, rl);
    consumer_sync();
    if (tid < rv) {
      float2 s = red[tid * COL_WARPS];
#pragma unroll
      for (int w = 1; w < COL_WARPS; ++w) {
        const float2 o = red[tid * COL_WARPS + w];
        df64_acc(s.x, s.y, o.x, o.y);
      }
      y[row0 + tid] = (double)s.x + (double)s.y;
    }
  }
}

size_t smem_needed(int n_stages) {
  return (size_t)n_stages * STAGE_BYTES + RED_BYTES + BAR_BYTES;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// u = B^T v in one launch.  part_h, part_l: f32 scratch of n_slabs rows and
// one row per inner node of the tree over them, each m rounded up to 4 long;
// tickets: one int per column group and tree node, zero on entry and on
// exit.  bulk != 0 needs m % 4 == 0 and 16-byte aligned bh, bl, v.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int mlff_df64_bt_v(const float* bh, const float* bl, const double* v,
                              float* part_h, float* part_l, int* tickets,
                              double* u, int n, int m, int n_slabs,
                              int group_chunks, int grid, int n_stages,
                              int bulk, void* stream) {
  if (n_stages < 1 || n_stages > MAX_STAGES || (bulk && m % 4 != 0) ||
      group_chunks < 1 || group_chunks > GROUP || n_slabs < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_needed(n_stages);
  auto kernel = bulk ? bt_v_kernel<true> : bt_v_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, s>>>(bh, bl, v, part_h, part_l, tickets, u, n, m,
                                n_slabs, group_chunks, n_stages);
  return (int)cudaGetLastError();
}

// y = B x in one launch.  bulk != 0 needs m % 4 == 0 and 16-byte aligned bh,
// bl.
extern "C" int mlff_df64_b_x(const float* bh, const float* bl, const double* x,
                             double* y, int n, int m, int grid, int n_stages,
                             int bulk, void* stream) {
  if (n_stages < 1 || n_stages > MAX_STAGES || (bulk && m % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_needed(n_stages);
  auto kernel = bulk ? b_x_kernel<true> : b_x_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, s>>>(bh, bl, x, y, n, m, n_stages);
  return (int)cudaGetLastError();
}
