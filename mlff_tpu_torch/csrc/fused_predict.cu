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
// kernel's own caller meets it in an f64 (B, M) distance array:
//  * wide_weights: block (training tile, query tile) of 64 x 64 pairs walks
//    D in steps of 16 through shared memory, S = xq wt^T and Gram = xq xt^T
//    on m16n8k4 mmas (a warp owns 16 queries x 64 rows, 64 accumulators),
//    and the row terms |xq|^2, |xt|^2, ct beside them; then the weights on
//    the C fragments, G = a dot and a1 = a (1 + dist) written to device
//    memory, and each query's sums of G and a1 dot over the tile written
//    as the tile's partial;
//  * wide_row_sums: each query's sum of G and its E over the training tiles,
//    in tile order;
//  * wide_forces: block (descriptor tile, query tile, slab of training rows)
//    of 64 queries x 64 columns: F += G xt + a1 wt over the slab, 16 rows at
//    a time through shared memory, on m16n8k4 mmas; with one slab it writes
//    F = xq sum G - that, with several each slab writes a partial that
//    wide_finish adds in slab order.
// Rows, queries and columns past the ends are staged as zeros and not
// stored; every sum runs in a fixed order, so a call gives the same bits
// every time.  Simple before fast: no copy overlaps the products yet.
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

constexpr int BQ = 64;       // queries per block tile
constexpr int BN = 64;       // training rows (pass 1) or columns (pass 2)
constexpr int KC = 16;       // depth staged per step
constexpr int NTHR = 128;    // 4 warps of 16 queries
constexpr int PA = KC + 4;   // pitch of [row][k] tiles, 4 mod 8 doubles
constexpr int PB = BN + 4;   // pitch of [k][column] tiles

constexpr size_t smem_weights() {
  return sizeof(double) * (size_t)((BQ + 2 * BN) * PA + BQ + 2 * BN);
}
constexpr size_t smem_forces() {
  return sizeof(double) * (size_t)(2 * BQ * PA + 2 * KC * PB);
}

__global__ void __launch_bounds__(NTHR)
wide_weights(const double* __restrict__ xq, const double* __restrict__ xt,
             const double* __restrict__ wt, double* __restrict__ gw,
             double* __restrict__ aw, double* __restrict__ gpart,
             double* __restrict__ epart, int B, int M, int D, double c0) {
  __shared__ __align__(16) double s_q[BQ * PA];
  __shared__ __align__(16) double s_x[BN * PA];
  __shared__ __align__(16) double s_w[BN * PA];
  __shared__ double s_nq[BQ], s_nt[BN], s_ct[BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BN, b0 = blockIdx.y * BQ;

  double S[8][4], Gm[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) S[n][i] = Gm[n][i] = 0.0;
  // thread r < 64 sums |xq|^2 of query row r; thread 64 + r sums |xt|^2 and
  // ct of training row r
  double r_nn = 0.0, r_ct = 0.0;

  for (int k0 = 0; k0 < D; k0 += KC) {
    for (int i = tid; i < BQ * KC; i += NTHR) {
      const int r = i / KC, c = i % KC, d = k0 + c;
      const bool dok = d < D;
      s_q[r * PA + c] =
          (dok && b0 + r < B) ? xq[(size_t)(b0 + r) * D + d] : 0.0;
      const bool mok = dok && m0 + r < M;
      s_x[r * PA + c] = mok ? xt[(size_t)(m0 + r) * D + d] : 0.0;
      s_w[r * PA + c] = mok ? wt[(size_t)(m0 + r) * D + d] : 0.0;
    }
    __syncthreads();
    if (tid < BQ) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const double x = s_q[tid * PA + c];
        r_nn = fma(x, x, r_nn);
      }
    } else {
      const int r = tid - BQ;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const double x = s_x[r * PA + c];
        r_nn = fma(x, x, r_nn);
        r_ct = fma(x, s_w[r * PA + c], r_ct);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KC / 4; ++kk) {
      double a[2];
      a[0] = s_q[(16 * warp + g) * PA + 4 * kk + t];
      a[1] = s_q[(16 * warp + g + 8) * PA + 4 * kk + t];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mma(S[n], a, s_w[(8 * n + g) * PA + 4 * kk + t]);
        mma(Gm[n], a, s_x[(8 * n + g) * PA + 4 * kk + t]);
      }
    }
    __syncthreads();
  }
  if (tid < BQ) {
    s_nq[tid] = r_nn;
  } else {
    s_nt[tid - BQ] = r_nn;
    s_ct[tid - BQ] = r_ct;
  }
  __syncthreads();

  // C fragment c[2 h + j] of tile n: query 16 warp + g + 8 h, training row
  // 8 n + 2 t + j
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bl = 16 * warp + g + 8 * h;
    const int b = b0 + bl;
    const double nq = s_nq[bl];
    double gsum = 0.0, esum = 0.0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ml = 8 * n + 2 * t + j;
        const int m = m0 + ml;
        const double d2 = fmax(nq + s_nt[ml] - 2.0 * Gm[n][2 * h + j], 0.0);
        const double ds = sqrt(d2);
        const double a = c0 * exp(-ds);
        const double dot = S[n][2 * h + j] - s_ct[ml];
        const double gv = a * dot, a1 = a * (1.0 + ds);
        if (m < M) {
          gsum += gv;
          esum = fma(a1, dot, esum);
          if (b < B) {
            gw[(size_t)b * M + m] = gv;
            aw[(size_t)b * M + m] = a1;
          }
        }
      }
    gsum = quad_sum(gsum);
    esum = quad_sum(esum);
    if (t == 0 && b < B) {
      gpart[(size_t)blockIdx.x * B + b] = gsum;
      epart[(size_t)blockIdx.x * B + b] = esum;
    }
  }
}

// gsum[b] and e_out[b] = (sum of E's partials) / q, over the n_mt training
// tiles in order
__global__ void __launch_bounds__(256)
wide_row_sums(const double* __restrict__ gpart,
              const double* __restrict__ epart, double* __restrict__ gsum,
              double* __restrict__ e_out, int B, int n_mt, double q) {
  const int b = blockIdx.x * 256 + threadIdx.x;
  if (b >= B) return;
  double gs = 0.0, es = 0.0;
  for (int k = 0; k < n_mt; ++k) {
    gs += gpart[(size_t)k * B + b];
    es += epart[(size_t)k * B + b];
  }
  gsum[b] = gs;
  e_out[b] = es / q;
}

__global__ void __launch_bounds__(NTHR)
wide_forces(const double* __restrict__ xq, const double* __restrict__ xt,
            const double* __restrict__ wt, const double* __restrict__ gw,
            const double* __restrict__ aw, const double* __restrict__ gsum,
            double* __restrict__ f_out, double* __restrict__ part, int B,
            int M, int D, int rows_per_split) {
  __shared__ __align__(16) double s_g[BQ * PA];
  __shared__ __align__(16) double s_a[BQ * PA];
  __shared__ __align__(16) double s_x[KC * PB];
  __shared__ __align__(16) double s_w[KC * PB];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int d0 = blockIdx.x * BN, b0 = blockIdx.y * BQ;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);

  double F[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) F[n][i] = 0.0;

  for (int k0 = m_begin; k0 < m_end; k0 += KC) {
    for (int i = tid; i < BQ * KC; i += NTHR) {
      const int r = i / KC, c = i % KC, m = k0 + c;
      const bool ok = b0 + r < B && m < m_end;
      s_g[r * PA + c] = ok ? gw[(size_t)(b0 + r) * M + m] : 0.0;
      s_a[r * PA + c] = ok ? aw[(size_t)(b0 + r) * M + m] : 0.0;
    }
    for (int i = tid; i < KC * BN; i += NTHR) {
      const int r = i / BN, c = i % BN, m = k0 + r, d = d0 + c;
      const bool ok = m < m_end && d < D;
      s_x[r * PB + c] = ok ? xt[(size_t)m * D + d] : 0.0;
      s_w[r * PB + c] = ok ? wt[(size_t)m * D + d] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC / 4; ++kk) {
      double ag[2], aa[2];
      ag[0] = s_g[(16 * warp + g) * PA + 4 * kk + t];
      ag[1] = s_g[(16 * warp + g + 8) * PA + 4 * kk + t];
      aa[0] = s_a[(16 * warp + g) * PA + 4 * kk + t];
      aa[1] = s_a[(16 * warp + g + 8) * PA + 4 * kk + t];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mma(F[n], ag, s_x[(4 * kk + t) * PB + 8 * n + g]);
        mma(F[n], aa, s_w[(4 * kk + t) * PB + 8 * n + g]);
      }
    }
    __syncthreads();
  }

  double* slab = part == nullptr
                     ? nullptr
                     : part + (size_t)blockIdx.z * ((size_t)B * D);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = b0 + 16 * warp + g + 8 * h;
    if (b >= B) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = d0 + 8 * n + 2 * t + j;
        if (d >= D) continue;
        const size_t i = (size_t)b * D + d;
        if (slab == nullptr)
          f_out[i] = fma(xq[i], gsum[b], -F[n][2 * h + j]);
        else
          slab[i] = F[n][2 * h + j];
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

// scratch layout, in doubles: gw, aw (B M each), gpart, epart (n_mt B each),
// gsum (B), and with n_split > 1 the slabs' partials (n_split B D)
int launch(const double* xq, const double* xt, const double* wt,
           double* scratch, double* f_out, double* e_out, int B, int M,
           int D, int n_split, int rows_per_split, double c0, double q,
           cudaStream_t s) {
  const int n_mt = (M + BN - 1) / BN, n_bt = (B + BQ - 1) / BQ;
  double* gw = scratch;
  double* aw = gw + (size_t)B * M;
  double* gpart = aw + (size_t)B * M;
  double* epart = gpart + (size_t)n_mt * B;
  double* gsum = epart + (size_t)n_mt * B;
  double* part = n_split > 1 ? gsum + B : nullptr;

  wide_weights<<<dim3(n_mt, n_bt), NTHR, 0, s>>>(xq, xt, wt, gw, aw, gpart,
                                                  epart, B, M, D, c0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_row_sums<<<(B + 255) / 256, 256, 0, s>>>(gpart, epart, gsum, e_out, B,
                                                n_mt, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_forces<<<dim3((D + BN - 1) / BN, n_bt, n_split), NTHR, 0, s>>>(
      xq, xt, wt, gw, aw, gsum, f_out, part, B, M, D, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const size_t total = (size_t)B * D;
  wide_finish<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      xq, gsum, part, f_out, B, D, n_split);
  return (int)cudaGetLastError();
}

// {queries per tile, training rows / columns per tile, depth per step,
//  threads, shared bytes of wide_weights and of wide_forces, resident blocks
//  per SM of each}
int geometry(int* out) {
  out[0] = BQ;
  out[1] = BN;
  out[2] = KC;
  out[3] = NTHR;
  out[4] = (int)smem_weights();
  out[5] = (int)smem_forces();
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[6], wide_weights, NTHR, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[7], wide_forces, NTHR, 0);
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

// The wide route, for any D (the caller takes it for D > 129): three or four
// launches on `stream`, returning cudaGetLastError().  `scratch` holds
// 2 B M + 2 ceil(M / 64) B + B doubles, plus n_split B D with n_split > 1;
// slab s is the training rows [s * rows_per_split, (s + 1) * rows_per_split).
extern "C" int mlff_fused_predict_wide(const double* xq, const double* xt,
                                       const double* wt, double* scratch,
                                       double* f_out, double* e_out, int B,
                                       int M, int D, int n_split,
                                       int rows_per_split, double c0,
                                       double q, void* stream) {
  return wide::launch(xq, xt, wt, scratch, f_out, e_out, B, M, D, n_split,
                      rows_per_split, c0, q,
                      static_cast<cudaStream_t>(stream));
}

// The wide route's geometry, for the caller's plan to be held against:
// out[0..7] = queries per tile, training rows (pass 1) and columns (pass 2)
// per tile, rows per staged step, threads per block, static shared bytes of
// the two passes, resident blocks per SM of the two passes.
extern "C" int mlff_fused_predict_wide_geometry(int* out) {
  return wide::geometry(out);
}
