// Fused descriptor-space force/energy contraction for prediction, f64.
//
// Replaces the TPU kernel mlff_tpu/ops/pallas_predict.py::_contract_kernel
// (reached through desc_forces_pallas).  For query descriptors xq (B, D), the
// permuted training descriptors xt (M, D), their cotangents wt (M, D) and the
// distances dist (B, M) (precomputed by the f64 Gram trick), it computes
//
//     a   = 5/(3 sig^2) exp(-dist)          a1 = a (1 + dist)
//     dot = xq . wt^T - sum(xt * wt)        G  = a dot
//     F   = xq * sum_m G - G xt - a1 wt     (B, D)
//     E   = sum_m (a1 dot) / q              (B,),  q = sqrt(5) / sig
//
// without writing any (B, M) intermediate to device memory.
//
// Precision.  The TPU kernel is f32 because Mosaic has no f64.  On a trained
// model f32 is not enough: the cotangents wt of a lam = 1e-10 ridge solve are
// orders of magnitude larger than the forces they sum to, and an f32
// contraction of the calibrated ethanol model (n = 31,482) misses the f64
// descriptor-space forces by ~6% relative (chip_smoke.py, predict phase,
// f32_contraction_rel_err), against an f32 tolerance of 2e-5.  The H100 has
// native f64, so this kernel reads, computes and accumulates in f64.
//
// What bounds it on the H100.  At the prediction shape (B = 512, M = 6996,
// D = 36) the work is ~108 FMAs per (query, training row) pair, 0.77 GFLOP,
// against 29 MB of f64 distances: the f64 FMA rate is the bound (34 TFLOP/s
// on the CUDA cores, which this kernel uses; 67 on the tensor cores).
//
// Design.  The TPU grid walked M sequentially on one core and carried F and
// E in VMEM between steps.  Here M is split across blocks as well as walked
// inside each block: block (i, s) owns query tile i (TB = 32 queries) and
// the s-th slab of training rows, loops over that slab in tiles of TM = 64
// rows staged in shared memory, and writes its partial F and E; a second
// small kernel sums the partials of all slabs in a fixed order (deterministic,
// no atomics).  The split count is chosen by the caller so that a batch of
// 512 queries (16 query tiles) fills the 132 SMs in one wave of 2 blocks per
// SM, the most the 90 KB of shared memory per block allows.  Ragged B
// and M edges are masked by bounds; there is no padding of the inputs.
// Energy and sum(G) terms accumulate in registers, F in shared memory.
// Shared rows of xt and wt are padded to D + 1 values so that the per-row
// reads of a half-warp fall in distinct banks.  The force phase issues about
// one shared-memory load per FMA, so this first version is limited by
// shared-memory bandwidth before the f64 rate; register tiling is the next
// step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TB = 32;   // queries per block
constexpr int TM = 64;   // training rows per shared-memory tile
constexpr int NT = 256;  // threads per block
constexpr int QPT = TB / (NT / TM);  // queries per thread in the score phase

__global__ void __launch_bounds__(NT)
contract_partial(const double* __restrict__ xq, const double* __restrict__ xt,
                 const double* __restrict__ wt, const double* __restrict__ dist,
                 double* __restrict__ f_part, double* __restrict__ e_part,
                 int B, int M, int D, int rows_per_split, double c0, double q) {
  extern __shared__ double smem[];
  const int DP = D + 1;
  double* s_xq = smem;                    // TB * D
  double* s_f = s_xq + TB * D;            // TB * D   F accumulators
  double* s_xt = s_f + TB * D;            // TM * DP
  double* s_wt = s_xt + TM * DP;          // TM * DP
  double* s_g = s_wt + TM * DP;           // TB * (TM + 1)
  double* s_a1 = s_g + TB * (TM + 1);     // TB * (TM + 1)

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TB;
  const int split = blockIdx.y;
  const int m_begin = split * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);

  for (int i = tid; i < TB * D; i += NT) {
    const int b = i / D;
    s_xq[i] = (b0 + b < B) ? xq[(size_t)(b0 + b) * D + (i % D)] : 0.0;
    s_f[i] = 0.0;
  }

  // score phase: thread owns row mm of each tile and queries bq + 4k
  const int mm = tid % TM;
  const int bq = tid / TM;
  double e_acc[QPT], g_acc[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    e_acc[k] = 0.0;
    g_acc[k] = 0.0;
  }

  for (int m0 = m_begin; m0 < m_end; m0 += TM) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TM * D; i += NT) {
      const int m = i / D, d = i % D;
      const bool ok = m0 + m < m_end;
      const size_t g = (size_t)(m0 + m) * D + d;
      s_xt[m * DP + d] = ok ? xt[g] : 0.0;
      s_wt[m * DP + d] = ok ? wt[g] : 0.0;
    }
    __syncthreads();

    const int m = m0 + mm;
    const bool m_ok = m < m_end;
    const double* xr = s_xt + mm * DP;
    const double* wr = s_wt + mm * DP;
    double ct = 0.0;
    double dot[QPT];
#pragma unroll
    for (int k = 0; k < QPT; ++k) dot[k] = 0.0;
    for (int d = 0; d < D; ++d) {
      const double w = wr[d];
      ct = fma(xr[d], w, ct);
#pragma unroll
      for (int k = 0; k < QPT; ++k)
        dot[k] = fma(s_xq[(bq + 4 * k) * D + d], w, dot[k]);
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const int b = bq + 4 * k;
      double g = 0.0, a1 = 0.0;
      const double dt = dot[k] - ct;
      if (m_ok && b0 + b < B) {
        const double ds = dist[(size_t)(b0 + b) * M + m];
        const double a = c0 * exp(-ds);
        g = a * dt;
        a1 = a * (1.0 + ds);
      }
      s_g[b * (TM + 1) + mm] = g;
      s_a1[b * (TM + 1) + mm] = a1;
      e_acc[k] = fma(a1, dt, e_acc[k]);
      g_acc[k] += g;
    }
    __syncthreads();

    // force phase: F[b, d] -= sum_m G[b, m] xt[m, d] + a1[b, m] wt[m, d]
    for (int o = tid; o < TB * D; o += NT) {
      const int b = o / D, d = o % D;
      const double* gr = s_g + b * (TM + 1);
      const double* ar = s_a1 + b * (TM + 1);
      double acc = 0.0;
#pragma unroll 8
      for (int j = 0; j < TM; ++j) {
        acc = fma(gr[j], s_xt[j * DP + d], acc);
        acc = fma(ar[j], s_wt[j * DP + d], acc);
      }
      s_f[o] -= acc;
    }
  }

  // reduce the energy and sum(G) terms over the 64 threads sharing bq:
  // within each warp by shuffles, then across the warp pair in shared memory
  __syncthreads();
  double* s_re = s_g;           // [2][TB]
  double* s_rg = s_g + 2 * TB;  // [2][TB]
  const int lane = tid % 32;
  const int half = (tid / 32) % 2;
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    double e = e_acc[k], g = g_acc[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      e += __shfl_down_sync(0xffffffffu, e, off);
      g += __shfl_down_sync(0xffffffffu, g, off);
    }
    if (lane == 0) {
      s_re[half * TB + bq + 4 * k] = e;
      s_rg[half * TB + bq + 4 * k] = g;
    }
  }
  __syncthreads();

  const size_t part = (size_t)split * B;
  for (int o = tid; o < TB * D; o += NT) {
    const int b = o / D;
    if (b0 + b < B) {
      const double gsum = s_rg[b] + s_rg[TB + b];
      f_part[(part + b0 + b) * D + (o % D)] = fma(s_xq[o], gsum, s_f[o]);
    }
  }
  if (tid < TB && b0 + tid < B)
    e_part[part + b0 + tid] = (s_re[tid] + s_re[TB + tid]) / q;
}

// out[i] = sum over the n_split slabs of part[s, i], in slab order
__global__ void sum_splits(const double* __restrict__ f_part,
                           const double* __restrict__ e_part,
                           double* __restrict__ f_out, double* __restrict__ e_out,
                           int B, int D, int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nf = B * D;
  if (i < nf) {
    double s = 0.0;
    for (int k = 0; k < n_split; ++k) s += f_part[(size_t)k * nf + i];
    f_out[i] = s;
  } else if (i < nf + B) {
    const int b = i - nf;
    double s = 0.0;
    for (int k = 0; k < n_split; ++k) s += e_part[(size_t)k * B + b];
    e_out[b] = s;
  }
}

size_t smem_bytes(int D) {
  return sizeof(double) *
         (size_t)(2 * TB * D + 2 * TM * (D + 1) + 2 * TB * (TM + 1));
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success).  f_part (n_split, B, D) and e_part (n_split, B) are scratch.
extern "C" int mlff_fused_predict(const double* xq, const double* xt,
                                  const double* wt, const double* dist,
                                  double* f_part, double* e_part, double* f_out,
                                  double* e_out, int B, int M, int D,
                                  int n_split, int rows_per_split, double c0,
                                  double q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      contract_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TB - 1) / TB, n_split);
  contract_partial<<<grid, NT, smem, s>>>(xq, xt, wt, dist, f_part, e_part, B,
                                          M, D, rows_per_split, c0, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = B * D + B;
  sum_splits<<<(total + 255) / 256, 256, 0, s>>>(f_part, e_part, f_out, e_out,
                                                 B, D, n_split);
  return (int)cudaGetLastError();
}
