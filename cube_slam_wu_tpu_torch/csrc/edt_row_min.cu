// Row pass of the exact Euclidean distance transform, batched, for sm_90a.
//
//   out[b, y, x] = sqrt(max(0, min_x' ((x - x')^2 + g2[b, y, x'])))
//
// evaluated in the reduced form x^2 + min_x' (a[x'] - 2*x*x') with
// a[x'] = x'^2 + g2[b, y, x'] computed once per row: one fused multiply-add
// per candidate and a min.  g2 is the squared, clamped column distance, so
// wherever a row can reach an edge every term is an integer below 2^24 and
// the float32 result equals the direct form bit for bit (fused or not).
//
// Replaces the Pallas TPU kernel ops/pallas_kernels.py::edt_row_min of the
// JAX package.  The work is B*H*W^2 candidates against 2*B*H*W*4 bytes, so
// the instruction rate of the SMs bounds it, not memory: FFMA runs on all
// 128 fp32 lanes of an SM per clock, a float min (FMNMX) on 64, and every
// instruction takes one of the 128 dispatch slots per clock.  No tensor cores,
// TMA or clusters apply: there is no matrix product and the input is read
// once.  The design for that bound:
//   * one block per (box, row); the row of a[] is staged in shared memory
//     once, so device memory is read once and written once;
//   * half the mins: a[] is staged with a constant K >= W^2 added, which
//     makes every candidate a[x'] + K - 2*x*x' >= K - x^2 > 0.  Non-negative
//     floats order like their bit patterns read as int32, so two candidates
//     fold into the running minimum with ONE three-input integer min
//     (__vimin3_s32, SASS VIMNMX3) instead of two FMNMX.  K comes off with
//     x^2 at the end; with K + W^2 + H^2 <= 2^24 all terms stay exact
//     integers, so the bits do not change.  This holds for the input the
//     distance transform gives, g2 integer-valued and at most H^2 or the
//     1e12 of a column without an edge (the wrapper checks the limit from the
//     shape).  A fractional g2 is NOT in the contract: it would be rounded
//     to the float32 spacing at K + W^2, up to 0.5 at the widest row;
//   * no instruction makes x': the source columns are walked in chunks of
//     32 with the offset inside the chunk as an FFMA immediate (see the
//     kernel's own comment), so a chunk costs 32 FFMA + 16 VIMNMX3 + 3 per
//     output column and 8 broadcast float4 shared loads per thread;
//   * every thread owns 5 output columns held in registers: 4 full warps at
//     W = 640, 8 at W = 1242, 46 registers;
//   * the ragged edge is handled by bounds: a[] is padded to a multiple of
//     32 inside shared memory only, with a value that can never win the min.
// No fast-math: sqrtf stays correctly rounded.

#include <cuda_runtime.h>

#define EDT_PAD 1.0e30f
#define EDT_INIT 3.0e38f
#define EDT_COLS 5  // output columns per thread

// x' as an immediate: the source columns are walked in chunks of 32,
// x' = xb + k.  Within a chunk the candidate less its part
// -2*x*xb, a[xb + k] - 2*x*k, has k as a compile-time constant, so no x' is
// computed or loaded; the chunk's minimum gets -2*x*xb added once and goes
// into the running minimum with one FMNMX.  K >= 62*W keeps the chunk's
// candidates non-negative.
__global__ void edt_row_min_kernel(const float* __restrict__ g2,
                                   float* __restrict__ out, int W, float K) {
  extern __shared__ __align__(16) float smem[];
  const size_t row = blockIdx.x;
  const float* src = g2 + row * (size_t)W;
  float* dst = out + row * (size_t)W;
  const int Wp = (W + 31) & ~31;
  float* a = smem;

  for (int i = threadIdx.x; i < Wp; i += blockDim.x) {
    const float xi = (float)i;
    a[i] = (i < W) ? (src[i] + (xi * xi + K)) : EDT_PAD;
  }
  __syncthreads();

  const float4* a4 = reinterpret_cast<const float4*>(a);
  const int n32 = Wp >> 5;

  float m2x[EDT_COLS], acc[EDT_COLS], s[EDT_COLS];
#pragma unroll
  for (int c = 0; c < EDT_COLS; ++c) {
    const int x = threadIdx.x + c * blockDim.x;
    m2x[c] = -2.0f * (float)x;
    acc[c] = EDT_INIT;
    s[c] = 0.0f;
  }
  for (int b = 0; b < n32; ++b) {
    int loc[EDT_COLS];
#pragma unroll
    for (int c = 0; c < EDT_COLS; ++c) loc[c] = __float_as_int(EDT_INIT);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = a4[b * 8 + j];
#pragma unroll
      for (int c = 0; c < EDT_COLS; ++c) {
        const float c0 = fmaf(m2x[c], (float)(4 * j), v.x);
        const float c1 = fmaf(m2x[c], (float)(4 * j + 1), v.y);
        const float c2 = fmaf(m2x[c], (float)(4 * j + 2), v.z);
        const float c3 = fmaf(m2x[c], (float)(4 * j + 3), v.w);
        loc[c] = __vimin3_s32(loc[c], __float_as_int(c0), __float_as_int(c1));
        loc[c] = __vimin3_s32(loc[c], __float_as_int(c2), __float_as_int(c3));
      }
    }
#pragma unroll
    for (int c = 0; c < EDT_COLS; ++c) {
      acc[c] = fminf(acc[c], __int_as_float(loc[c]) + s[c]);
      s[c] = fmaf(m2x[c], 32.0f, s[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < EDT_COLS; ++c) {
    const int x = threadIdx.x + c * blockDim.x;
    if (x < W) {
      const float xf = (float)x;
      dst[x] = sqrtf(fmaxf(acc[c] + (xf * xf - K), 0.0f));
    }
  }
}

static float edt_offset(int W) {
  // K: at least W^2 (a candidate is at least -x^2 before it is added) and at
  // least 62*W (a chunk's candidate is at least -2*x*31)
  const float w = (float)((W + 3) & ~3);
  return w * (w > 64.0f ? w : 64.0f);
}

// One block per row, one warp per 32 * EDT_COLS output columns.  Launches on
// `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() so that a refused launch is seen by the caller, or
// cudaErrorInvalidValue for what the kernel does not take (a block has at
// most 32 warps; the wrapper's MAX_WIDTH is below that).
extern "C" int edt_row_min_launch(const float* g2, float* out, long long rows,
                                  int W, void* stream) {
  if (rows <= 0 || W <= 0) return 0;
  const int warps = (W + 32 * EDT_COLS - 1) / (32 * EDT_COLS);
  if (rows > 2147483647LL || warps > 32) return (int)cudaErrorInvalidValue;
  const size_t row32 = (size_t)((W + 31) & ~31) * sizeof(float);
  edt_row_min_kernel<<<(unsigned int)rows, 32 * warps, row32,
                       (cudaStream_t)stream>>>(g2, out, W, edt_offset(W));
  return (int)cudaGetLastError();
}
