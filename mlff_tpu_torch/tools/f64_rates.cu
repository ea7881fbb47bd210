// The f64 issue rates of the card that csrc/fused_predict.cu lives on:
// each mma.sync f64 shape alone, DFMA alone, and the 16x8x4 mma with DFMAs
// between (do the tensor cores and the CUDA cores' f64 pipe overlap?).
// Every warp runs `iters` rounds of 8 independent steps; the host times the
// launch with CUDA events.  Driven by
// python3 -m mlff_tpu_torch.tools.time_fused_predict --f64-rates.

#include <cuda_runtime.h>

namespace {

enum Mode { M8N8K4, M16N8K4, M16N8K8, M16N8K16, DFMA8, M16N8K4_DFMA8 };

template <int MODE>
__global__ void rate(double* out, int iters, double x) {
  double c[8][4], f[8];
  for (int i = 0; i < 8; ++i) {
    f[i] = threadIdx.x * 1e-9 + i;
    for (int j = 0; j < 4; ++j) c[i][j] = 0.0;
  }
  const double a = x + threadIdx.x, b = 0.5 * x + threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (MODE == M8N8K4)
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, "
            "{%3}, {%0,%1};"
            : "+d"(c[i][0]), "+d"(c[i][1]) : "d"(a), "d"(b));
      if (MODE == M16N8K4 || MODE == M16N8K4_DFMA8)
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
            "{%4,%5}, {%6}, {%0,%1,%2,%3};"
            : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
            : "d"(a), "d"(b), "d"(a));
      if (MODE == M16N8K8)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
            : "d"(a), "d"(b), "d"(a), "d"(b), "d"(a), "d"(b));
      if (MODE == M16N8K16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
            : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
            : "d"(a), "d"(b), "d"(a), "d"(b), "d"(a), "d"(b), "d"(a), "d"(b),
              "d"(a), "d"(b), "d"(a), "d"(b));
      if (MODE == DFMA8 || MODE == M16N8K4_DFMA8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = fma(f[j], a, b);
      }
    }
  }
  double s = 0.0;
  for (int i = 0; i < 8; ++i) {
    s += f[i];
    for (int j = 0; j < 4; ++j) s += c[i][j];
  }
  if (s == 12345.678) out[0] = s;  // keeps the loop alive
}

template <int MODE>
float timed(double* out, int blocks, int warps, int iters) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.0f;
  for (int rep = 0; rep < 3; ++rep) {  // the last of three launches counts
    cudaEventRecord(e0);
    rate<MODE><<<blocks, warps * 32>>>(out, iters, 1.0);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}

}  // namespace

// Milliseconds of one launch of `blocks` blocks of `warps` warps, each warp
// running 8 * iters steps of `mode` (the order of enum Mode); -1 on an error.
// `scratch` is 8 bytes of device memory.
extern "C" float mlff_f64_rate(int mode, double* scratch, int blocks,
                               int warps, int iters) {
  switch (mode) {
    case M8N8K4: return timed<M8N8K4>(scratch, blocks, warps, iters);
    case M16N8K4: return timed<M16N8K4>(scratch, blocks, warps, iters);
    case M16N8K8: return timed<M16N8K8>(scratch, blocks, warps, iters);
    case M16N8K16: return timed<M16N8K16>(scratch, blocks, warps, iters);
    case DFMA8: return timed<DFMA8>(scratch, blocks, warps, iters);
    case M16N8K4_DFMA8:
      return timed<M16N8K4_DFMA8>(scratch, blocks, warps, iters);
  }
  return -1.0f;
}
