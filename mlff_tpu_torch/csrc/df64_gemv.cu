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
// Accumulation order.  The TPU reduced each 512-row tile by pairwise halving
// and summed the tiles in order.  Here no thread runs a long sequential
// df64 sum: each keeps four interleaved accumulators over at most a few
// dozen elements, and the accumulators, warps, blocks and slabs are combined
// in fixed trees (deterministic, no atomics).
//
// What bounds it on the H100.  Both passes read the (hi, lo) pair once:
// 8 bytes per element, 387 MB at n = 31,482, m = 1536, against ~18 f32
// operations per element.  At 3.35 TB/s and 67 TFLOP/s f32 the bytes are
// the bound by ~9x, so the design is about coalesced reads and enough loads
// in flight:
//   bt_v  a block owns 32 consecutive columns (one per lane, so a warp reads
//         128 contiguous bytes of a row) and a slab of 256 rows, 32 per warp;
//         the 8 warps' partials meet in shared memory; a second small kernel
//         sums the slabs' (hi, lo) partials per column.
//   b_x   one warp per row, lanes striding along the row (coalesced); x is
//         staged once per block in shared memory as (hi, lo); the lanes'
//         partials meet in a compensated butterfly of shuffles.
// Ragged n and m edges are masked by bounds; nothing is padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 256;            // threads per block, both passes
constexpr int WARPS = NT / 32;
constexpr int ACC = 4;             // interleaved accumulators per thread
constexpr int BT_SLAB = 256;       // rows per bt_v block
constexpr int BT_RUN = BT_SLAB / WARPS;  // rows per thread
constexpr int BX_ROWS = 4;         // rows per b_x warp

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

__device__ __forceinline__ void split(double x, float& h, float& l) {
  h = __double2float_rn(x);
  l = __double2float_rn(x - (double)h);
}

// fold the ACC accumulators pairwise: (0 + 1) + (2 + 3)
__device__ __forceinline__ void fold(float (&h)[ACC], float (&l)[ACC]) {
  df64_acc(h[0], l[0], h[1], l[1]);
  df64_acc(h[2], l[2], h[3], l[3]);
  df64_acc(h[0], l[0], h[2], l[2]);
}

// Pass 1: the partial of slab blockIdx.y for columns blockIdx.x * 32 + lane.
// Warp w takes rows w, w + 8, ... of the slab, row i into accumulator i % 4.
__global__ void __launch_bounds__(NT)
bt_v_partial(const float* __restrict__ bh, const float* __restrict__ bl,
             const double* __restrict__ v, float* __restrict__ part_h,
             float* __restrict__ part_l, int n, int m) {
  __shared__ float s_h[WARPS][32], s_l[WARPS][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * BT_SLAB + w;
  float ah[ACC] = {0.f, 0.f, 0.f, 0.f}, al[ACC] = {0.f, 0.f, 0.f, 0.f};
  if (col < m) {
#pragma unroll
    for (int i = 0; i < BT_RUN; ++i) {
      const int r = r0 + WARPS * i;
      if (r < n) {
        float vh, vl;
        split(v[r], vh, vl);
        const size_t g = (size_t)r * m + col;
        df64_fma(ah[i % ACC], al[i % ACC], bh[g], bl[g], vh, vl);
      }
    }
  }
  fold(ah, al);
  s_h[w][lane] = ah[0];
  s_l[w][lane] = al[0];
  __syncthreads();
  for (int s = WARPS / 2; s > 0; s /= 2) {
    if (w < s) df64_acc(s_h[w][lane], s_l[w][lane], s_h[w + s][lane],
                        s_l[w + s][lane]);
    __syncthreads();
  }
  if (w == 0 && col < m) {
    const size_t o = (size_t)blockIdx.y * m + col;
    part_h[o] = s_h[0][lane];
    part_l[o] = s_l[0][lane];
  }
}

// Pass 1, second kernel: u[col] = sum over the n_slab partials, in a fixed
// order (group g of 8 takes slabs g, g + 8, ...; then a tree over groups).
__global__ void __launch_bounds__(NT)
bt_v_combine(const float* __restrict__ part_h, const float* __restrict__ part_l,
             double* __restrict__ u, int n_slab, int m) {
  __shared__ float s_h[WARPS][32], s_l[WARPS][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float ah[ACC] = {0.f, 0.f, 0.f, 0.f}, al[ACC] = {0.f, 0.f, 0.f, 0.f};
  if (col < m) {
    for (int s0 = w; s0 < n_slab; s0 += WARPS * ACC) {
#pragma unroll
      for (int k = 0; k < ACC; ++k) {
        const int s = s0 + WARPS * k;
        if (s < n_slab) {
          const size_t o = (size_t)s * m + col;
          df64_acc(ah[k], al[k], part_h[o], part_l[o]);
        }
      }
    }
  }
  fold(ah, al);
  s_h[w][lane] = ah[0];
  s_l[w][lane] = al[0];
  __syncthreads();
  for (int s = WARPS / 2; s > 0; s /= 2) {
    if (w < s) df64_acc(s_h[w][lane], s_l[w][lane], s_h[w + s][lane],
                        s_l[w + s][lane]);
    __syncthreads();
  }
  if (w == 0 && col < m) u[col] = (double)s_h[0][lane] + (double)s_l[0][lane];
}

// Pass 2: y = B x.  Warp w of block b owns rows (b * 8 + w) * 4 + k, k < 4;
// lane j takes columns j, j + 32, ..., column c into accumulator (c / 32) % 4.
__global__ void __launch_bounds__(NT)
b_x(const float* __restrict__ bh, const float* __restrict__ bl,
    const double* __restrict__ x, double* __restrict__ y, int n, int m) {
  extern __shared__ float s_x[];  // [m] hi, then [m] lo
  for (int j = threadIdx.x; j < m; j += NT) split(x[j], s_x[j], s_x[m + j]);
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  for (int k = 0; k < BX_ROWS; ++k) {
    const int r = (blockIdx.x * WARPS + w) * BX_ROWS + k;
    if (r >= n) break;  // the same for every lane of the warp
    const float* rh = bh + (size_t)r * m;
    const float* rl = bl + (size_t)r * m;
    float ah[ACC] = {0.f, 0.f, 0.f, 0.f}, al[ACC] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = lane; c0 < m; c0 += 32 * ACC) {
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int c = c0 + 32 * a;
        if (c < m) df64_fma(ah[a], al[a], rh[c], rl[c], s_x[c], s_x[m + c]);
      }
    }
    fold(ah, al);
    float h = ah[0], l = al[0];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float oh = __shfl_xor_sync(0xffffffffu, h, off);
      const float ol = __shfl_xor_sync(0xffffffffu, l, off);
      df64_acc(h, l, oh, ol);
    }
    if (lane == 0) y[r] = (double)h + (double)l;
  }
}

}  // namespace

// u = B^T v.  part_h, part_l: (ceil(n / 256), m) f32 scratch.  Launches both
// kernels on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mlff_df64_bt_v(const float* bh, const float* bl, const double* v,
                              float* part_h, float* part_l, double* u, int n,
                              int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_slab = (n + BT_SLAB - 1) / BT_SLAB;
  const int n_col = (m + 31) / 32;
  bt_v_partial<<<dim3(n_col, n_slab), NT, 0, s>>>(bh, bl, v, part_h, part_l,
                                                  n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bt_v_combine<<<n_col, NT, 0, s>>>(part_h, part_l, u, n_slab, m);
  return (int)cudaGetLastError();
}

// y = B x.  Shared memory holds x as (hi, lo): 8 m bytes.
extern "C" int mlff_df64_b_x(const float* bh, const float* bl, const double* x,
                             double* y, int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * sizeof(float) * (size_t)m;
  cudaError_t err = cudaFuncSetAttribute(
      b_x, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = WARPS * BX_ROWS;
  b_x<<<(n + rows_per_block - 1) / rows_per_block, NT, smem, s>>>(bh, bl, x, y,
                                                                  n, m);
  return (int)cudaGetLastError();
}
