// Fused descriptor-space force/energy contraction for prediction, f64, on the
// FP64 tensor cores.
//
// Replaces the TPU kernel mlff_tpu/ops/pallas_predict.py::_contract_kernel
// and the Gram-trick distances that desc_forces_pallas computes before it.
// For query descriptors xq (B, D), the permuted training descriptors
// xt (M, D) and their cotangents wt (M, D) it computes
//
//     d2   = max(|xq|^2 + |xt|^2 - 2 xq . xt^T, 0)     dist = sqrt(d2)
//     a    = c0 exp(-dist)                             a1 = a (1 + dist)
//     dot  = xq . wt^T - sum_d(xt * wt)                G  = a dot
//     F    = xq * sum_m G - G xt - a1 wt               (B, D)
//     E    = sum_m (a1 dot) / q                        (B,)
//
// and no (B, M) array ever reaches device memory: the inputs are read once
// per query tile, the outputs written once per slab of training rows.
//
// Precision.  The TPU kernel is f32 because Mosaic has no f64.  On a trained
// model f32 is not enough: the cotangents wt of a lam = 1e-10 ridge solve are
// orders of magnitude larger than the forces they sum to, and an f32
// contraction of the calibrated ethanol model (n = 31,482) misses the f64
// forces by ~6% relative (chip_smoke.py, predict phase).  So everything here
// is f64; exp and sqrt are the f64 library functions (no --use_fast_math).
//
// What bounds it on the H100.  8 D + 10 f64 operations per (query, training
// row) pair against 16 D bytes per training row: operations, by far.  The
// card's f64 peak (67 TFLOP/s) belongs to the tensor cores, so all four
// products are f64 mma.sync operations (DMMA in SASS).  Measured with
// tools/f64_rates.cu on an H100 80GB HBM3 at 700 W: m16n8k4, k8 and k16
// reach 62-66 TFLOP/s, m8n8k4 half of that, plain DFMA 30; and a warp's
// DMMAs and DFMAs do not overlap, they queue for one f64 pipe (one 16x8x4
// mma and 8 DFMAs together take 1.3x the sum of their times).  So the f64
// sqrt and exp of every pair (~38 f64 operations in SASS) are paid on top
// of the 40 mmas per 16 x 8 pairs, not beside them, and the kernel is bound
// by that pipe: about a third of the pipe's time at D = 36 goes to the
// elementwise stage.
//
// Design.
//  * A warp owns 8 RH queries (RH = 2 up to D = 72, one m16n8k4 per step;
//    RH = 1 above, m8n8k4) for its whole walk over a slab of training rows.
//    The A fragments of xq (row = lane / 4, k = lane % 4), shared by the
//    products S = xq wt^T and Gram = xq xt^T, and the accumulators of F
//    (8 NT8 columns, D padded with zeros) stay in registers throughout.
//  * Per 8 training rows: S and Gram over D in steps of 4, then the
//    weights elementwise on the C fragments, then F += G xt + a1 wt with
//    the 8 rows as the k axis.  A C fragment holds columns 2t and 2t + 1 of
//    row lane / 4 (t = lane % 4); an A fragment wants k = t.  The sum over
//    k does not care which training row is called k, so step j of the force
//    product takes column 2t + j straight from the C registers and pairs it
//    with that row of xt and wt: G and a1 never leave their registers.
//  * xt and wt arrive in tiles of TM = 16 rows through a ring of NS = 4
//    shared-memory stages filled by cp.async (16-byte copies when D is even
//    and the arrays are 16-byte aligned, which makes every row start
//    aligned; 8-byte copies otherwise), so the loads of the next tiles
//    overlap the products of this one.  Rows past the end of a slab are
//    filled with zeros, and a zero row adds exactly nothing to F, E and
//    sum G; queries past B are computed and not stored.  Nothing is padded
//    by the caller.
//  * Shared rows have a pitch of DS = 8 NT8 + 4 doubles (columns D.. are
//    zero).  DS = 4 mod 8 puts the B fragments of the first two products
//    (8 rows x 4 neighbouring columns) on distinct banks; the force
//    product's fragments (rows 2t + j x 8 neighbouring columns) land on
//    distinct banks as well once column c of a tile stands for training row
//    c ^ (c >> 2), which is the order the tiles are read in.
//  * The row terms ct = sum_d xt wt and |xt|^2 of tile i + 1 are summed from
//    its stage while tile i is multiplied, one __syncthreads per tile.
//  * Block (i, s) owns query tile i and slab s of the training rows; the
//    caller's plan cuts the slabs so that one wave of blocks fills the SMs
//    for B = 512 as for B = 1.  Each block writes its partial F and E, and a
//    second kernel adds the slabs in a fixed order: no atomics, the same
//    bits on every run.
//
// The wide route (D > 129).  A warp's xq fragments and F accumulators no
// longer fit its registers, and the weights of a pair need sums over all of
// D before any of F can be formed.  So the wide route is two passes that
// meet in a (B, M) pair of f64 weight arrays in device memory, as the TPU
// kernel's own caller meets it in an f64 (B, M) distance array.  Both passes
// are GEMM-shaped and bound by the f64 tensor pipe, and both are built the
// same way: blocks of 4 warps, two resident per SM (~240 registers a
// thread, ~95 KB of shared memory a block), so that one block's barrier
// leaves the other's warps issuing; each warp a 32-query tile of m16n8k4
// mmas with 64 accumulators; the operands streamed through a ring of 3
// shared-memory stages filled by cp.async (16-byte copies when D is even
// and the arrays 16-byte aligned, 8-byte otherwise), the copies of the next
// 2 stages in flight while the current one is multiplied, one __syncthreads
// per stage.  Row pitches are 4 mod 16 doubles, which puts a half warp's
// fragment reads on distinct banks.
//  * wide_weights (pass 1): tiles of 64 queries x 64 training rows, 16
//    descriptor columns a stage; a warp owns 32 x 32 pairs of both
//    S = xq wt^T and Gram = xq xt^T.  The row terms |xq|^2, |xt|^2, ct are
//    summed from the same stages, spread evenly over the warps (four
//    threads to a row).  They cost the full row at D = 3828 ~10% (a build
//    without them ran it 12% faster); summing them from the mma fragments
//    instead, each warp its share, took more registers than pass 1 has.  The query tile is the tiles' fastest
//    axis, so the blocks in flight share their xt and wt rows, which are
//    read from device memory once.
//  * Splitting D.  Where the tiles leave SMs idle in a wave, pass 1 cuts D:
//    at small M (catcher: 119 rows, 16 tiles at B = 512; the nanotube: 14
//    rows) or small B every tile would otherwise walk thousands of columns
//    alone, and at large M the last wave is partial (full_3828: 880 tiles,
//    3 waves of 264 and 88 over).  The tiles of the last wave that is not
//    full (all tiles where they fill less than one) are each cut into as
//    many slices as fill that wave.  A slice's block writes its partial S,
//    Gram and row terms to scratch, and wide_combine adds the slices in
//    slice order and forms the weights.  (A thread-block cluster reducing
//    through distributed shared memory would keep the partials on chip, but
//    a portable cluster holds at most 8 blocks, too few slices for catcher
//    at B = 1 or the nanotube, and the partials are small: one wave of
//    64 x 64 tiles, 17 MB.)  An unsplit tile forms the weights on its C
//    fragments.  Either way G = a dot and a1 = a (1 + dist) go to device
//    memory with a row pitch ldm = M rounded up to even, and each query's
//    sums of G and a1 dot over the training tile are written as the tile's
//    partial.
//  * wide_forces (pass 2): tiles of 64 queries x 128 descriptor columns, 8
//    training rows a stage: F += G xt + a1 wt, a warp owning 32 queries x
//    64 columns.  While its first stages land, a block sums its queries' G
//    over the training tiles in tile order (and one block per query tile
//    writes them and the energies out).  The F tile then goes through shared memory and out row by
//    row, a column a thread, with 16 rows of xq loaded ahead of the stores
//    (written from the fragments, each lane's stores waited on its own
//    loads, which made the epilogue of a short slab its whole time).  With
//    one slab it writes F = xq sum G - that; where the tiles fill less than
//    a wave the plan cuts the training rows into slabs, each writes a
//    partial and wide_finish adds them in slab order.
// A warp whose queries all lie past B, or whose rows or columns lie past M
// or D, skips those tiles' mmas (B = 1, M = 14).  Rows, queries and columns
// past the ends are staged as zeros and not stored; every sum runs in a
// fixed order, so a call gives the same bits every time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TM = 16;  // training rows per shared-memory stage
constexpr int NS = 4;   // stages in the ring
constexpr unsigned FULL = 0xffffffffu;

// D (8x8) += A (8x4, row major) * B (4x8, column major), f64.  Per lane:
// a = A[lane / 4][lane % 4], b = B[lane % 4][lane / 4],
// c[j] = D[lane / 4][2 (lane % 4) + j].
__device__ __forceinline__ void mma(double (&c)[2], const double (&a)[1],
                                    double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a[0]), "d"(b));
}

// The 16x8x4 form: a[h] and c[2 h + j] are those of rows lane / 4 + 8 h.
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[2],
                                    double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// The 16x8x8 form: a[0..3] = A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4]; b[0..1] = B[t][g], B[t + 4][g] (g = lane / 4,
// t = lane % 4); c as in the 16x8x4 form.
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Asynchronous copy of 16 or 8 bytes to shared memory; with bytes = 0 the
// destination is filled with zeros and the source is not read.
__device__ __forceinline__ void cp_async16(double* dst, const double* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// the sum over the four lanes that share lane / 4, the same in all four
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

template <int NT8>
constexpr size_t smem_bytes() {
  return sizeof(double) * (size_t)(2 * NS * TM * (8 * NT8 + 4) + 2 * NS * TM);
}

// NT8: 8-column tiles of the padded descriptor width; RH: 8-query halves per
// warp; NW: warps per block; MINB: blocks per SM the registers must allow.
template <int NT8, int RH, int NW, int MINB>
__global__ void __launch_bounds__(NW * 32, MINB)
contract_partial(const double* __restrict__ xq, const double* __restrict__ xt,
                 const double* __restrict__ wt, double* __restrict__ part,
                 int B, int M, int D, int rows_per_split, int copy16,
                 double c0, double q) {
  constexpr int KS = 2 * NT8;      // k steps of the products over D
  constexpr int DS = 8 * NT8 + 4;  // shared-memory row pitch, doubles
  constexpr int QW = 8 * RH;       // queries per warp
  constexpr int NTHR = NW * 32;
  constexpr int TPR = NTHR / TM;   // threads that sum one row's terms
  static_assert(TPR == 8 || TPR == 16, "row sums shuffle within 8 or 16 lanes");

  extern __shared__ __align__(16) double smem[];
  double* s_xt = smem;                   // [NS][TM][DS]
  double* s_wt = s_xt + NS * TM * DS;    // [NS][TM][DS]
  double* s_ct = s_wt + NS * TM * DS;    // [NS][TM]  sum_d xt wt
  double* s_nt = s_ct + NS * TM;         // [NS][TM]  |xt|^2

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b0 = blockIdx.x * (NW * QW) + warp * QW;
  const bool active = b0 < B;            // a warp past B only helps loading
  const int m_begin = blockIdx.y * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int n_tiles = (m_end - m_begin + TM - 1) / TM;

  // columns D.. of every staged row are zero; the copies never touch them
  for (int i = tid; i < NS * TM * DS; i += NTHR)
    if (i % DS >= D) {
      s_xt[i] = 0.0;
      s_wt[i] = 0.0;
    }

  auto load_tile = [&](int tile) {
    if (tile < n_tiles) {
      const int m0 = m_begin + tile * TM;
      const int stage = tile % NS;
      for (int r = warp; r < TM; r += NW) {
        const int bytes = (m0 + r < m_end) ? (copy16 ? 16 : 8) : 0;
        const size_t src = (size_t)min(m0 + r, m_end - 1) * D;
        double* dx = s_xt + (stage * TM + r) * DS;
        double* dw = s_wt + (stage * TM + r) * DS;
        if (copy16) {
          for (int c = 2 * lane; c < D; c += 64) {
            cp_async16(dx + c, xt + src + c, bytes);
            cp_async16(dw + c, wt + src + c, bytes);
          }
        } else {
          for (int c = lane; c < D; c += 32) {
            cp_async8(dx + c, xt + src + c, bytes);
            cp_async8(dw + c, wt + src + c, bytes);
          }
        }
      }
    }
    cp_async_commit();  // always, so that the groups count tiles
  };

  auto row_sums = [&](int tile) {
    const int row = (tile % NS) * TM + tid / TPR;
    const double* xr = s_xt + row * DS;
    const double* wr = s_wt + row * DS;
    double ct = 0.0, nt = 0.0;
    for (int d = tid % TPR; d < D; d += TPR) {
      const double x = xr[d];
      ct = fma(x, wr[d], ct);
      nt = fma(x, x, nt);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2) {
      ct += __shfl_xor_sync(FULL, ct, off);
      nt += __shfl_xor_sync(FULL, nt, off);
    }
    if (tid % TPR == 0) {
      s_ct[row] = ct;
      s_nt[row] = nt;
    }
  };

  for (int s = 0; s < NS - 1; ++s) load_tile(s);

  // A fragments of this warp's queries, and their squared norms
  double xa[KS][RH], nq[RH];
#pragma unroll
  for (int h = 0; h < RH; ++h) {
    const int b = b0 + g + 8 * h;
    double sq = 0.0;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int d = 4 * k + t;
      const double x = (b < B && d < D) ? xq[(size_t)b * D + d] : 0.0;
      xa[k][h] = x;
      sq = fma(x, x, sq);
    }
    nq[h] = quad_sum(sq);
  }

  double F[NT8][2 * RH], e_acc[RH], g_acc[RH];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int i = 0; i < 2 * RH; ++i) F[n][i] = 0.0;
#pragma unroll
  for (int h = 0; h < RH; ++h) e_acc[h] = g_acc[h] = 0.0;

  cp_async_wait<NS - 2>();  // tile 0 has landed
  __syncthreads();
  if (n_tiles > 0) row_sums(0);

  // column c of an 8-row tile stands for its row c ^ (c >> 2)
  const int row_b = g ^ (g >> 2);                      // as B column g
  const int row_k[2] = {(2 * t) ^ (t >> 1), (2 * t + 1) ^ (t >> 1)};

  for (int tile = 0; tile < n_tiles; ++tile) {
    // tile + 1 has landed; everyone is done with tile - 1 and with the row
    // sums of this tile
    cp_async_wait<NS - 3>();
    __syncthreads();
    load_tile(tile + NS - 1);  // into the stage of tile - 1
    if (tile + 1 < n_tiles) row_sums(tile + 1);
    if (!active) continue;

    const int stage = tile % NS;
    const int rows = min(TM, m_end - m_begin - tile * TM);
    for (int r0 = 0; r0 < rows; r0 += 8) {
      const double* xs = s_xt + (stage * TM + r0) * DS;
      const double* ws = s_wt + (stage * TM + r0) * DS;

      // S = xq wt^T and Gram = xq xt^T on 8 QW x 8 pairs
      double S[2 * RH], Gm[2 * RH];
#pragma unroll
      for (int i = 0; i < 2 * RH; ++i) S[i] = Gm[i] = 0.0;
      const double* pw = ws + row_b * DS + t;
      const double* px = xs + row_b * DS + t;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        mma(S, xa[k], pw[4 * k]);
        mma(Gm, xa[k], px[4 * k]);
      }

      // the weights, on the C fragments; ag[j] and a1[j] are the A
      // fragments of the force product's step j
      double ag[2][RH], a1[2][RH];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double ct = s_ct[stage * TM + r0 + row_k[j]];
        const double nt = s_nt[stage * TM + r0 + row_k[j]];
#pragma unroll
        for (int h = 0; h < RH; ++h) {
          const double d2 = fmax(nq[h] + nt - 2.0 * Gm[2 * h + j], 0.0);
          const double ds = sqrt(d2);
          const double a = c0 * exp(-ds);
          const double dot = S[2 * h + j] - ct;
          ag[j][h] = a * dot;
          a1[j][h] = a * (1.0 + ds);
          e_acc[h] = fma(a1[j][h], dot, e_acc[h]);
          g_acc[h] += ag[j][h];
        }
      }

      // F += G xt + a1 wt, the 8 training rows as k
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double* qx = xs + row_k[j] * DS + g;
        const double* qw = ws + row_k[j] * DS + g;
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          mma(F[n], ag[j], qx[8 * n]);
          mma(F[n], a1[j], qw[8 * n]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  // this slab's partial: [F (B, D), E (B)]
  double* f_part = part + (size_t)blockIdx.y * ((size_t)B * D + B);
  double* e_part = f_part + (size_t)B * D;
#pragma unroll
  for (int h = 0; h < RH; ++h) {
    const double gsum = quad_sum(g_acc[h]);
    const double e = quad_sum(e_acc[h]);
    const int b = b0 + g + 8 * h;
    if (b >= B) continue;
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = 8 * n + 2 * t + j;
        if (d < D)
          f_part[(size_t)b * D + d] =
              fma(xq[(size_t)b * D + d], gsum, -F[n][2 * h + j]);
      }
    if (t == 0) e_part[b] = e / q;
  }
}

// out[i] = sum over the n_split slabs of part[s][i], in an order that depends
// on n_split alone: 8 strided sums, then those 8 in turn.  The first B D
// values of a slab's partial go to f_out, the last B to e_out.
__global__ void __launch_bounds__(256)
sum_splits(const double* __restrict__ part, double* __restrict__ f_out,
           double* __restrict__ e_out, int nf, int total, int n_split) {
  __shared__ double red[8][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  double s = 0.0;
  if (i < total) {
#pragma unroll 4
    for (int k = threadIdx.y; k < n_split; k += 8)
      s += part[(size_t)k * total + i];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < total) {
    s = red[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < 8; ++k) s += red[k][threadIdx.x];
    if (i < nf)
      f_out[i] = s;
    else
      e_out[i - nf] = s;
  }
}

constexpr int MAX_DEVICES = 64;

template <int NT8, int RH, int NW, int MINB>
struct Instance {
  static constexpr int queries = NW * 8 * RH;

  // the kernel's shared-memory attributes are set once per device
  static cudaError_t configure() {
    static bool done[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    auto kernel = contract_partial<NT8, RH, NW, MINB>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<NT8>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) done[dev] = true;
    return cudaSuccess;
  }

  static int launch(const double* xq, const double* xt, const double* wt,
                    double* part, double* f_out, double* e_out, int B, int M,
                    int D, int n_split, int rows_per_split, double c0,
                    double q, cudaStream_t s) {
    cudaError_t err = configure();
    if (err != cudaSuccess) return (int)err;
    const int copy16 = D % 2 == 0 && (uintptr_t)xt % 16 == 0 &&
                       (uintptr_t)wt % 16 == 0;
    const dim3 grid((B + queries - 1) / queries, n_split);
    contract_partial<NT8, RH, NW, MINB><<<grid, NW * 32, smem_bytes<NT8>(),
                                          s>>>(
        xq, xt, wt, part, B, M, D, rows_per_split, copy16, c0, q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int nf = B * D, total = nf + B;
    sum_splits<<<(total + 31) / 32, dim3(32, 8), 0, s>>>(part, f_out, e_out,
                                                         nf, total, n_split);
    return (int)cudaGetLastError();
  }

  // {queries per block, threads, shared-memory bytes, blocks the card keeps
  // resident per SM}
  static int geometry(int* out) {
    cudaError_t err = configure();
    if (err != cudaSuccess) return (int)err;
    out[0] = queries;
    out[1] = NW * 32;
    out[2] = (int)smem_bytes<NT8>();
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3], contract_partial<NT8, RH, NW, MINB>, NW * 32,
        smem_bytes<NT8>());
  }
};

// One instantiation per padded width: D <= 40, <= 72, <= 136.  The 16x8x4
// mma runs at twice the rate of the 8x8x4 one on this card, so a warp takes
// 16 queries wherever their fragments and accumulators fit its registers.
using W40 = Instance<5, 2, 4, 3>;
using W72 = Instance<9, 2, 4, 2>;
using W136 = Instance<17, 1, 8, 1>;

// -- the wide route ---------------------------------------------------------

namespace wide {

constexpr int NTHR = 128;   // 4 warps in both passes
constexpr int MINB = 2;     // blocks per SM the registers must allow
constexpr int BQ = 64;      // queries per block tile, both passes
constexpr int WQ = BQ / 32; // warps along the queries (32 queries each)
// pass 1: BQ queries x BN training rows, KC1 descriptor columns per stage
constexpr int BN = 64;
constexpr int KC1 = 16;
constexpr int NS1 = 3;
constexpr int PA1 = KC1 + 4;  // pitch of the [row][k] tiles, 4 mod 16
// pass 2: BQ queries x BD descriptor columns, KC2 training rows per stage
constexpr int BD = 128;
constexpr int KC2 = 8;
constexpr int NS2 = 3;
constexpr int PA2 = KC2 + 4;  // [query][k] tiles of G and a1, 12
constexpr int PB2 = BD + 4;   // [k][column] tiles of xt and wt, 4 mod 16
constexpr int CQ = 8;         // queries per block of wide_combine
// a split tile's partial of one slice: S, Gram, |xq|^2, |xt|^2, ct
constexpr int PART_DOUBLES = 2 * BQ * BN + BQ + 2 * BN;
// pass 2 stages its F tile in shared memory at this pitch (8 mod 16: a
// quarter warp's double2 writes of two rows fall on distinct banks)
constexpr int PF = BD + 8;
static_assert(NTHR == 64 * WQ, "two warps of 32 queries per query slice");
static_assert(NTHR == BD, "pass 2 writes its tile a column a thread");
static_assert(BQ * (BD + 8) <= NS2 * (2 * BQ * PA2 + 2 * KC2 * PB2),
              "pass 2's F tile fits the ring");
// row terms of pass 1: four threads to a query row and a training row, RS
// rows of each to a thread
static_assert(BQ == BN, "pass 1's row terms pair query and training rows");
constexpr int RS = 4 * BQ / NTHR;
static_assert(RS * NTHR == 4 * BQ && KC1 % 4 == 0, "whole rows, columns");

constexpr size_t smem_weights() {
  return sizeof(double) *
         (size_t)(NS1 * (BQ + 2 * BN) * PA1 + BQ + 2 * BN + 4 * BQ);
}
constexpr size_t smem_forces() {
  return sizeof(double) * (size_t)(NS2 * (2 * BQ * PA2 + 2 * KC2 * PB2) + BQ);
}

__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// the number of valid tiles of `size` rows starting at `first`, at most n
__device__ __forceinline__ int valid_tiles(int end, int first, int size,
                                           int n) {
  return max(0, min(n, (end - first + size - 1) / size));
}

// S += xq wt^T and Gm += xq xt^T over one KC1-deep stage: the warp's 32
// queries (two 16-row A tiles) x 32 training rows (four 8-row B tiles).
// With WHOLE false only the first ni A tiles and nj B tiles are multiplied.
template <bool WHOLE>
__device__ __forceinline__ void weight_products(
    double (&S)[2][4][4], double (&Gm)[2][4][4], const double* q,
    const double* x, const double* w, int g, int t, int ni, int nj) {
#pragma unroll
  for (int kk = 0; kk < KC1 / 4; ++kk) {
    const int k = 4 * kk + t;
    double a[2][2], bx[4], bw[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i][0] = q[(16 * i + g) * PA1 + k];
      a[i][1] = q[(16 * i + g + 8) * PA1 + k];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bx[j] = x[(8 * j + g) * PA1 + k];
      bw[j] = w[(8 * j + g) * PA1 + k];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (WHOLE || (i < ni && j < nj)) {
          mma(S[i][j], a[i], bw[j]);
          mma(Gm[i][j], a[i], bx[j]);
        }
  }
}

// Pass 1.  Tiles in order t = query tile + n_qt training tile.  Blocks
// x < n_whole take tile x over all of D and form the weights on their C
// fragments: gw, aw (B, ldm), and each query's sums of G and a1 dot over
// the tile in gpart, epart (n_mt, B).  The tiles from n_whole on (the last,
// partial wave's) are split: block n_whole + u takes tile n_whole + u % n_tail
// and slice y = u / n_tail of the columns, [y cols_per_slice, (y + 1)
// cols_per_slice), and writes its partial S, Gram (BQ x BN each) and row
// terms (BQ of |xq|^2, BN each of |xt|^2 and ct) to part entry
// (u % n_tail) n_ksplit + y, for wide_combine.
__global__ void __launch_bounds__(NTHR, MINB)
wide_weights(const double* __restrict__ xq, const double* __restrict__ xt,
             const double* __restrict__ wt, double* __restrict__ gw,
             double* __restrict__ aw, double* __restrict__ gpart,
             double* __restrict__ epart, double* __restrict__ part, int B,
             int M, int D, int ldm, int n_qt, int n_whole, int n_tail,
             int n_ksplit, int cols_per_slice, int copy16, double c0) {
  extern __shared__ __align__(16) double smem[];
  double* s_q = smem;                  // [NS1][BQ][PA1]
  double* s_x = s_q + NS1 * BQ * PA1;  // [NS1][BN][PA1]
  double* s_w = s_x + NS1 * BN * PA1;  // [NS1][BN][PA1]
  double* s_nq = s_w + NS1 * BN * PA1; // [BQ]  |xq|^2
  double* s_nt = s_nq + BQ;            // [BN]  |xt|^2
  double* s_ct = s_nt + BN;            // [BN]  sum_d xt wt
  double* s_red = s_ct + BN;           // [wm][gsum, esum][BQ]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's 32 queries and 32 rows; the warps of one row half (all that
  // a small M keeps busy) have neighbouring ids, which the SM deals to
  // different sub-partitions
  const int wq = warp % WQ, wm = warp / WQ;
  const bool split = (int)blockIdx.x >= n_whole;
  const int u = blockIdx.x - n_whole;
  const int tile = split ? n_whole + u % n_tail : blockIdx.x;
  const int qt = tile % n_qt, mt = tile / n_qt;
  const int b0 = qt * BQ, m0 = mt * BN;
  const int k_begin = split ? u / n_tail * cols_per_slice : 0;
  const int k_end = split ? min(D, k_begin + cols_per_slice) : D;
  const int n_steps = (k_end - k_begin + KC1 - 1) / KC1;

  // Stage `step` of the ring: BQ rows of xq and BN rows each of xt and wt,
  // KC1 columns, zeros past B, M and the slice's end.
  auto load_stage = [&](int step) {
    if (step < n_steps) {
      const int k0 = k_begin + step * KC1;
      const int st = step % NS1;
      if (copy16) {
        constexpr int CPR = KC1 / 2, RPS = NTHR / CPR;  // chunks a row, rows a sweep
        const int c = 2 * (tid % CPR);
#pragma unroll
        for (int s = 0; s < BQ / RPS; ++s) {
          const int r = tid / CPR + RPS * s;
          const bool ok = b0 + r < B && k0 + c < k_end;
          cp_async16(s_q + (st * BQ + r) * PA1 + c,
                     ok ? xq + (size_t)(b0 + r) * D + k0 + c : xq,
                     ok ? 16 : 0);
        }
#pragma unroll
        for (int s = 0; s < BN / RPS; ++s) {
          const int r = tid / CPR + RPS * s;
          const bool ok = m0 + r < M && k0 + c < k_end;
          const size_t src = ok ? (size_t)(m0 + r) * D + k0 + c : 0;
          cp_async16(s_x + (st * BN + r) * PA1 + c, xt + src, ok ? 16 : 0);
          cp_async16(s_w + (st * BN + r) * PA1 + c, wt + src, ok ? 16 : 0);
        }
      } else {
        constexpr int RPS = NTHR / KC1;
        const int c = tid % KC1;
#pragma unroll
        for (int s = 0; s < BQ / RPS; ++s) {
          const int r = tid / KC1 + RPS * s;
          const bool ok = b0 + r < B && k0 + c < k_end;
          cp_async8(s_q + (st * BQ + r) * PA1 + c,
                    ok ? xq + (size_t)(b0 + r) * D + k0 + c : xq, ok ? 8 : 0);
        }
#pragma unroll
        for (int s = 0; s < BN / RPS; ++s) {
          const int r = tid / KC1 + RPS * s;
          const bool ok = m0 + r < M && k0 + c < k_end;
          const size_t src = ok ? (size_t)(m0 + r) * D + k0 + c : 0;
          cp_async8(s_x + (st * BN + r) * PA1 + c, xt + src, ok ? 8 : 0);
          cp_async8(s_w + (st * BN + r) * PA1 + c, wt + src, ok ? 8 : 0);
        }
      }
    }
    cp_async_commit();  // always, so that the groups count stages
  };

  // Row terms from the staged tiles, spread evenly over the warps: thread
  // tid takes query rows and training rows (tid + NTHR s) / 4 (s < RS) and,
  // of each stage, their columns c4, c4 + 4, ... (c4 = tid % 4, which puts
  // a half warp's reads on distinct banks); the four threads of a row,
  // neighbours in one warp, add their sums at the end.
  const int c4 = tid % 4;
  double r_q[RS], r_t[RS], r_c[RS];  // |xq|^2, |xt|^2, ct
#pragma unroll
  for (int s = 0; s < RS; ++s) r_q[s] = r_t[s] = r_c[s] = 0.0;
  auto row_terms = [&](int st) {
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      const int r = (tid + NTHR * s) / 4;
      const double* pq = s_q + (st * BQ + r) * PA1 + c4;
      const double* px = s_x + (st * BN + r) * PA1 + c4;
      const double* pw = s_w + (st * BN + r) * PA1 + c4;
#pragma unroll
      for (int e = 0; e < KC1; e += 4) {
        const double q = pq[e], x = px[e];
        r_q[s] = fma(q, q, r_q[s]);
        r_t[s] = fma(x, x, r_t[s]);
        r_c[s] = fma(x, pw[e], r_c[s]);
      }
    }
  };

  for (int s = 0; s < NS1 - 1; ++s) load_stage(s);

  double S[2][4][4], Gm[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[i][j][e] = Gm[i][j][e] = 0.0;
  const int ni = valid_tiles(B, b0 + 32 * wq, 16, 2);
  const int nj = valid_tiles(M, m0 + 32 * wm, 8, 4);

  for (int step = 0; step < n_steps; ++step) {
    // this stage has landed, and every thread is done with the last one,
    // whose slot the next load refills: one barrier per stage
    cp_async_wait<NS1 - 2>();
    __syncthreads();
    load_stage(step + NS1 - 1);
    const int st = step % NS1;
    row_terms(st);
    if (ni > 0 && nj > 0) {
      const double* q = s_q + (st * BQ + 32 * wq) * PA1;
      const double* x = s_x + (st * BN + 32 * wm) * PA1;
      const double* w = s_w + (st * BN + 32 * wm) * PA1;
      if (ni == 2 && nj == 4)
        weight_products<true>(S, Gm, q, x, w, g, t, ni, nj);
      else
        weight_products<false>(S, Gm, q, x, w, g, t, ni, nj);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int s = 0; s < RS; ++s) {  // the same sums in a row's four threads
    r_q[s] = quad_sum(r_q[s]);
    r_t[s] = quad_sum(r_t[s]);
    r_c[s] = quad_sum(r_c[s]);
  }

  // C fragment [i][j][2 h + c]: query b0 + 32 wq + 16 i + g + 8 h, training
  // row m0 + 32 wm + 8 j + 2 t + c
  if (split) {
    double* p = part + (size_t)((u % n_tail) * n_ksplit + u / n_tail) *
                           PART_DOUBLES;
    if (c4 == 0)
#pragma unroll
      for (int s = 0; s < RS; ++s) {
        const int r = (tid + NTHR * s) / 4;
        p[2 * BQ * BN + r] = r_q[s];
        p[2 * BQ * BN + BQ + r] = r_t[s];
        p[2 * BQ * BN + BQ + BN + r] = r_c[s];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 32 * wq + 16 * i + g + 8 * h;
        if (b0 + rl >= B) continue;  // rows wide_combine does not read
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ml = 32 * wm + 8 * j + 2 * t;
          if (m0 + ml >= M) continue;
          store2(p + rl * BN + ml, S[i][j][2 * h], S[i][j][2 * h + 1]);
          store2(p + BQ * BN + rl * BN + ml, Gm[i][j][2 * h],
                 Gm[i][j][2 * h + 1]);
        }
      }
    return;
  }

  if (c4 == 0)
#pragma unroll
    for (int s = 0; s < RS; ++s) {
      const int r = (tid + NTHR * s) / 4;
      s_nq[r] = r_q[s];
      s_nt[r] = r_t[s];
      s_ct[r] = r_c[s];
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bl = 32 * wq + 16 * i + g + 8 * h;
      const int b = b0 + bl;
      const double nq = s_nq[bl];
      double gs = 0.0, es = 0.0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i >= ni || j >= nj) continue;
        const int ml = 32 * wm + 8 * j + 2 * t;
        const int m = m0 + ml;
        double gv[2], av[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const double d2 =
              fmax(nq + s_nt[ml + c] - 2.0 * Gm[i][j][2 * h + c], 0.0);
          const double ds = sqrt(d2);
          const double a = c0 * exp(-ds);
          const double dot = S[i][j][2 * h + c] - s_ct[ml + c];
          gv[c] = a * dot;
          av[c] = a * (1.0 + ds);
          if (m + c < M) {
            gs += gv[c];
            es = fma(av[c], dot, es);
          }
        }
        if (b < B && m < M) {
          store2(gw + (size_t)b * ldm + m, gv[0], gv[1]);
          store2(aw + (size_t)b * ldm + m, av[0], av[1]);
        }
      }
      gs = quad_sum(gs);
      es = quad_sum(es);
      if (t == 0) {
        s_red[(2 * wm) * BQ + bl] = gs;
        s_red[(2 * wm + 1) * BQ + bl] = es;
      }
    }
  __syncthreads();
  for (int r = tid; r < BQ; r += NTHR)
    if (b0 + r < B) {
      gpart[(size_t)mt * B + b0 + r] = s_red[r] + s_red[2 * BQ + r];
      epart[(size_t)mt * B + b0 + r] = s_red[BQ + r] + s_red[3 * BQ + r];
    }
}

// The weights of the split tiles, each sum over the slices in slice order.
// Block (split tile v, CQ queries): warp w takes query row CQ y + w of the
// tile, lane l its training rows l and l + 32; each query's sums of G and
// a1 dot over the tile go to gpart, epart as pass 1 writes them.
__global__ void __launch_bounds__(CQ * 32, 1)
wide_combine(const double* __restrict__ part, double* __restrict__ gw,
             double* __restrict__ aw, double* __restrict__ gpart,
             double* __restrict__ epart, int B, int M, int ldm, int n_qt,
             int n_whole, int n_ksplit, double c0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v = blockIdx.x / (BQ / CQ);
  const int rl = blockIdx.x % (BQ / CQ) * CQ + warp;
  const int tile = n_whole + v;
  const int b = tile % n_qt * BQ + rl, m0 = tile / n_qt * BN;
  if (b >= B) return;
  const double* p0 = part + (size_t)v * n_ksplit * PART_DOUBLES;
  double nq = 0.0;
  for (int y = 0; y < n_ksplit; ++y)
    nq += p0[(size_t)y * PART_DOUBLES + 2 * BQ * BN + rl];
  double gs = 0.0, es = 0.0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int ml = lane + 32 * c, m = m0 + ml;
    if (m >= M) continue;
    double s = 0.0, gm = 0.0, nt = 0.0, ct = 0.0;
    for (int y = 0; y < n_ksplit; ++y) {
      const double* p = p0 + (size_t)y * PART_DOUBLES;
      s += p[rl * BN + ml];
      gm += p[BQ * BN + rl * BN + ml];
      nt += p[2 * BQ * BN + BQ + ml];
      ct += p[2 * BQ * BN + BQ + BN + ml];
    }
    const double d2 = fmax(nq + nt - 2.0 * gm, 0.0);
    const double ds = sqrt(d2);
    const double a = c0 * exp(-ds);
    const double dot = s - ct;
    const double gv = a * dot, av = a * (1.0 + ds);
    gw[(size_t)b * ldm + m] = gv;
    aw[(size_t)b * ldm + m] = av;
    gs += gv;
    es = fma(av, dot, es);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    gs += __shfl_xor_sync(FULL, gs, off);
    es += __shfl_xor_sync(FULL, es, off);
  }
  if (lane == 0) {
    gpart[(size_t)(tile / n_qt) * B + b] = gs;
    epart[(size_t)(tile / n_qt) * B + b] = es;
  }
}

// F += G xt + a1 wt over one KC2-deep stage: the warp's 32 queries (two
// 16-row A tiles each of G and a1) x 64 columns (eight 8-column B tiles
// each of xt and wt), the training rows as k, on 16x8x8 mmas (fewer
// instructions for the same operands than 16x8x4).  The G products of all
// 16 accumulators go first, then the a1 products, so that two mmas into
// one accumulator stand 16 apart.
template <bool WHOLE>
__device__ __forceinline__ void force_products(
    double (&F)[2][8][4], const double* G, const double* A, const double* X,
    const double* W, int g, int t, int ni, int nj) {
#pragma unroll
  for (int kk = 0; kk < KC2 / 8; ++kk) {
    const int k = 8 * kk + t;
    double ag[2][4], aa[2][4], bx[8][2], bw[8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = (16 * i + g + 8 * (e % 2)) * PA2 + k + 4 * (e / 2);
        ag[i][e] = G[o];
        aa[i][e] = A[o];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bx[j][e] = X[(k + 4 * e) * PB2 + 8 * j + g];
        bw[j][e] = W[(k + 4 * e) * PB2 + 8 * j + g];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (WHOLE || (i < ni && j < nj)) mma(F[i][j], ag[i], bx[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (WHOLE || (i < ni && j < nj)) mma(F[i][j], aa[i], bw[j]);
  }
}

// Pass 2.  Block (column tile, query tile, slab z of the training rows
// [z rows_per_split, (z + 1) rows_per_split)): F += G xt + a1 wt over the
// slab through a ring of NS2 stages.  With one slab it writes
// F = xq sum G - that, with several each slab writes its partial to `part`
// for wide_finish.
__global__ void __launch_bounds__(NTHR, MINB)
wide_forces(const double* __restrict__ xq, const double* __restrict__ xt,
            const double* __restrict__ wt, const double* __restrict__ gw,
            const double* __restrict__ aw, const double* __restrict__ gpart,
            const double* __restrict__ epart, double* __restrict__ gsum,
            double* __restrict__ f_out, double* __restrict__ e_out,
            double* __restrict__ part, int B, int M, int D, int ldm,
            int n_mt, int rows_per_split, int copy16, double q) {
  extern __shared__ __align__(16) double smem[];
  double* s_g = smem;                   // [NS2][BQ][PA2]
  double* s_a = s_g + NS2 * BQ * PA2;   // [NS2][BQ][PA2]
  double* s_x = s_a + NS2 * BQ * PA2;   // [NS2][KC2][PB2]
  double* s_w = s_x + NS2 * KC2 * PB2;  // [NS2][KC2][PB2]
  double* s_gs = s_w + NS2 * KC2 * PB2; // [BQ]  each query's sum of G

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wq = warp % WQ, wd = warp / WQ;  // 32 queries, 64 columns
  const int d0 = blockIdx.x * BD, b0 = blockIdx.y * BQ;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int n_steps = (m_end - m_begin + KC2 - 1) / KC2;

  // Stage `step`: KC2 training rows of G and a1 for BQ queries (16-byte
  // copies: the pitch ldm is even; the second half of a pair past the slab
  // is filled with zeros) and of xt and wt for BD columns.
  auto load_stage = [&](int step) {
    if (step < n_steps) {
      const int k0 = m_begin + step * KC2;
      const int st = step % NS2;
      {
        constexpr int CPR = KC2 / 2, RPS = NTHR / CPR;
        const int c = 2 * (tid % CPR);
        const int bytes_m = min(16, max(0, 8 * (m_end - k0 - c)));
#pragma unroll
        for (int s = 0; s < BQ / RPS; ++s) {
          const int r = tid / CPR + RPS * s;
          const int bytes = b0 + r < B ? bytes_m : 0;
          const size_t src = bytes ? (size_t)(b0 + r) * ldm + k0 + c : 0;
          cp_async16(s_g + (st * BQ + r) * PA2 + c, gw + src, bytes);
          cp_async16(s_a + (st * BQ + r) * PA2 + c, aw + src, bytes);
        }
      }
      if (copy16) {
        constexpr int CPR = BD / 2, RPS = NTHR / CPR;
        const int c = 2 * (tid % CPR);
#pragma unroll
        for (int s = 0; s < KC2 / RPS; ++s) {
          const int r = tid / CPR + RPS * s;
          const bool ok = k0 + r < m_end && d0 + c < D;
          const size_t src = ok ? (size_t)(k0 + r) * D + d0 + c : 0;
          cp_async16(s_x + (st * KC2 + r) * PB2 + c, xt + src, ok ? 16 : 0);
          cp_async16(s_w + (st * KC2 + r) * PB2 + c, wt + src, ok ? 16 : 0);
        }
      } else {
        constexpr int RPS = NTHR / BD;
        const int c = tid % BD;
#pragma unroll
        for (int s = 0; s < KC2 / RPS; ++s) {
          const int r = tid / BD + RPS * s;
          const bool ok = k0 + r < m_end && d0 + c < D;
          const size_t src = ok ? (size_t)(k0 + r) * D + d0 + c : 0;
          cp_async8(s_x + (st * KC2 + r) * PB2 + c, xt + src, ok ? 8 : 0);
          cp_async8(s_w + (st * KC2 + r) * PB2 + c, wt + src, ok ? 8 : 0);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < NS2 - 1; ++s) load_stage(s);

  // While the first stages land: each query's sum of G over the training
  // tiles, in tile order (8 tiles' loads at a time); the first column
  // tile's first slab also writes it out for wide_finish, with E.
  if (tid < BQ) {
    const int b = b0 + tid;
    const bool first = blockIdx.x == 0 && blockIdx.z == 0;
    double gs = 0.0, es = 0.0;
    if (b < B) {
      for (int k0 = 0; k0 < n_mt; k0 += 8) {
        double vg[8], ve[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const bool ok = k0 + k < n_mt;
          vg[k] = ok ? gpart[(size_t)(k0 + k) * B + b] : 0.0;
          ve[k] = ok && first ? epart[(size_t)(k0 + k) * B + b] : 0.0;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          gs += vg[k];
          es += ve[k];
        }
      }
      if (first) {
        gsum[b] = gs;
        e_out[b] = es / q;
      }
    }
    s_gs[tid] = gs;
  }

  double F[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) F[i][j][e] = 0.0;
  const int ni = valid_tiles(B, b0 + 32 * wq, 16, 2);
  const int nj = valid_tiles(D, d0 + 64 * wd, 8, 8);

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<NS2 - 2>();
    __syncthreads();
    load_stage(step + NS2 - 1);
    if (ni == 0 || nj == 0) continue;
    const int st = step % NS2;
    const double* G = s_g + (st * BQ + 32 * wq) * PA2;
    const double* A = s_a + (st * BQ + 32 * wq) * PA2;
    const double* X = s_x + st * KC2 * PB2 + 64 * wd;
    const double* W = s_w + st * KC2 * PB2 + 64 * wd;
    if (ni == 2 && nj == 8)
      force_products<true>(F, G, A, X, W, g, t, ni, nj);
    else
      force_products<false>(F, G, A, X, W, g, t, ni, nj);
  }
  cp_async_wait<0>();

  // The F tile goes through shared memory (the ring is free now), so that
  // the block writes it row by row, a column a thread, with 16 rows of xq
  // loaded ahead: the store of a row waits for no load.  C
  // fragment [i][j][2 h + c]: row 32 wq + 16 i + g + 8 h, column
  // 64 wd + 8 j + 2 t + c.
  __syncthreads();
  double* s_f = smem;  // [BQ][PF]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(s_f + (32 * wq + 16 * i + g + 8 * h) * PF + 64 * wd + 8 * j +
                   2 * t,
               F[i][j][2 * h], F[i][j][2 * h + 1]);
  __syncthreads();
  double* slab = part == nullptr ? nullptr
                                 : part + (size_t)blockIdx.z * ((size_t)B * D);
  const int d = d0 + tid;
  if (d >= D) return;
  constexpr int RU = 16;  // rows in flight
#pragma unroll 1
  for (int r0 = 0; r0 < BQ; r0 += RU) {
    double x[RU], gs[RU];
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const int b = b0 + r0 + r;
      const bool load = slab == nullptr && b < B;
      x[r] = load ? xq[(size_t)b * D + d] : 0.0;
      gs[r] = s_gs[r0 + r];
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      const int b = b0 + r0 + r;
      if (b >= B) break;
      const double f = s_f[(r0 + r) * PF + tid];
      const size_t o = (size_t)b * D + d;
      if (slab != nullptr)
        slab[o] = f;
      else
        f_out[o] = fma(x[r], gs[r], -f);
    }
  }
}

// f_out = xq * gsum - (sum of the n_split slabs' partials, in slab order)
__global__ void __launch_bounds__(256)
wide_finish(const double* __restrict__ xq, const double* __restrict__ gsum,
            const double* __restrict__ part, double* __restrict__ f_out,
            int B, int D, int n_split) {
  const size_t total = (size_t)B * D;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  double s = 0.0;
  for (int k = 0; k < n_split; ++k) s += part[(size_t)k * total + i];
  f_out[i] = fma(xq[i], gsum[i / D], -s);
}

// the kernels' shared-memory attributes are set once per device
cudaError_t configure() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(wide_weights,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_weights());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wide_forces,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_forces());
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) done[dev] = true;
  return cudaSuccess;
}

// n rounded up to even, so that every array of the scratch starts 16-byte
// aligned
constexpr size_t even(size_t n) { return n + (n & 1); }

// Scratch layout, in doubles, with ldm = M rounded up to even: gw, aw
// (B ldm each); gpart, epart (n_mt B each), gsum (B), each rounded up to
// even; the split tiles' partials (n_tail n_ksplit PART_DOUBLES); with
// n_split > 1 the slabs' force partials (n_split B D).
int launch(const double* xq, const double* xt, const double* wt,
           double* scratch, double* f_out, double* e_out, int B, int M,
           int D, int n_whole, int n_ksplit, int cols_per_slice, int n_split,
           int rows_per_split, double c0, double q, cudaStream_t s) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const int ldm = M + (M & 1);
  const int n_qt = (B + BQ - 1) / BQ, n_mt = (M + BN - 1) / BN;
  const int n_dt = (D + BD - 1) / BD;
  const int n_tail = n_qt * n_mt - n_whole;
  const size_t w = (size_t)B * ldm;
  double* gw = scratch;
  double* aw = gw + w;
  double* gpart = aw + w;
  double* epart = gpart + even((size_t)n_mt * B);
  double* gsum = epart + even((size_t)n_mt * B);
  double* part = gsum + even(B);
  double* fpart = part + (size_t)n_tail * n_ksplit * PART_DOUBLES;
  const int copy16 = D % 2 == 0 && (uintptr_t)xq % 16 == 0 &&
                     (uintptr_t)xt % 16 == 0 && (uintptr_t)wt % 16 == 0;

  wide_weights<<<n_whole + n_tail * n_ksplit, NTHR, smem_weights(), s>>>(
      xq, xt, wt, gw, aw, gpart, epart, part, B, M, D, ldm, n_qt, n_whole,
      n_tail, n_ksplit, cols_per_slice, copy16, c0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_tail > 0) {
    wide_combine<<<n_tail * (BQ / CQ), CQ * 32, 0, s>>>(
        part, gw, aw, gpart, epart, B, M, ldm, n_qt, n_whole, n_ksplit, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  wide_forces<<<dim3(n_dt, n_qt, n_split), NTHR, smem_forces(), s>>>(
      xq, xt, wt, gw, aw, gpart, epart, gsum, f_out, e_out,
      n_split > 1 ? fpart : nullptr, B, M, D, ldm, n_mt, rows_per_split,
      copy16, q);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const size_t total = (size_t)B * D;
  wide_finish<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      xq, gsum, fpart, f_out, B, D, n_split);
  return (int)cudaGetLastError();
}

// {queries per tile; pass 1: training rows per tile, columns per stage,
//  stages; pass 2: columns per tile, training rows per stage, stages;
//  threads; dynamic shared bytes of pass 1 and pass 2; resident blocks per
//  SM of pass 1 and pass 2; queries per block of the combine}
int geometry(int* out) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  out[0] = BQ;
  out[1] = BN;
  out[2] = KC1;
  out[3] = NS1;
  out[4] = BD;
  out[5] = KC2;
  out[6] = NS2;
  out[7] = NTHR;
  out[8] = (int)smem_weights();
  out[9] = (int)smem_forces();
  out[12] = CQ;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[10], wide_weights, NTHR, smem_weights());
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[11], wide_forces, NTHR, smem_forces());
}

}  // namespace wide

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success, cudaErrorInvalidValue for D > 136: those take
// mlff_fused_predict_wide).  `part` is scratch of
// n_split * (B * D + B) doubles; slab s is the training rows
// [s * rows_per_split, (s + 1) * rows_per_split), a multiple of 16 rows.
extern "C" int mlff_fused_predict(const double* xq, const double* xt,
                                  const double* wt, double* part,
                                  double* f_out, double* e_out, int B, int M,
                                  int D, int n_split, int rows_per_split,
                                  double c0, double q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 40)
    return W40::launch(xq, xt, wt, part, f_out, e_out, B, M, D, n_split,
                       rows_per_split, c0, q, s);
  if (D <= 72)
    return W72::launch(xq, xt, wt, part, f_out, e_out, B, M, D, n_split,
                       rows_per_split, c0, q, s);
  if (D <= 136)
    return W136::launch(xq, xt, wt, part, f_out, e_out, B, M, D, n_split,
                        rows_per_split, c0, q, s);
  return (int)cudaErrorInvalidValue;
}

// The launch geometry of the instantiation that takes descriptor width D, for
// the caller's plan to be held against: out[0..3] = queries per block,
// threads per block, dynamic shared memory in bytes, resident blocks per SM.
extern "C" int mlff_fused_predict_geometry(int D, int* out) {
  if (D <= 40) return W40::geometry(out);
  if (D <= 72) return W72::geometry(out);
  if (D <= 136) return W136::geometry(out);
  return (int)cudaErrorInvalidValue;
}

// The wide route, for any D (the caller takes it for D > 129): two to four
// launches on `stream`, returning cudaGetLastError().  Pass 1 takes its
// first n_whole tiles whole and cuts D for each later one into n_ksplit
// slices of cols_per_slice columns (a multiple of 16); pass 2 cuts the
// training rows into n_split slabs of rows_per_split (a multiple of 8).
// `scratch` holds what wide::launch lays out.
extern "C" int mlff_fused_predict_wide(const double* xq, const double* xt,
                                       const double* wt, double* scratch,
                                       double* f_out, double* e_out, int B,
                                       int M, int D, int n_whole,
                                       int n_ksplit, int cols_per_slice,
                                       int n_split, int rows_per_split,
                                       double c0, double q, void* stream) {
  return wide::launch(xq, xt, wt, scratch, f_out, e_out, B, M, D, n_whole,
                      n_ksplit, cols_per_slice, n_split, rows_per_split, c0,
                      q, static_cast<cudaStream_t>(stream));
}

// The wide route's geometry, for the caller's plan to be held against:
// out[0..12] as wide::geometry fills them.
extern "C" int mlff_fused_predict_wide_geometry(int* out) {
  return wide::geometry(out);
}
