// Fused row gather + masked fanout reduction (forward).
//
// Replaces the Pallas TPU kernel `gather_seg_aggr_pallas` /
// `_gather_seg_aggr_kernel` (src/repro/kernels/seg_aggr/kernel.py).
// out[i] = reduce_j { table[idx[i, j]] : mask[i, j] } over the fanout j,
// with reduce = sum, mean (sum / max(count, 1)) or max (-inf fill); a
// fully-masked row gives 0 in every mode.  The (n, fanout, d) gathered
// block is never written to device memory.
//
// Bound: bytes.  It reads n*fanout*(4 + 1) index/mask bytes, up to
// n*fanout*d*4 bytes of table rows and writes n*d*4; one add (or max)
// per loaded float.  Design: one block per tile of dst rows; the threads
// of a row run across d with 16-byte (float4) loads when d % 4 == 0
// (d = 64 -> 16 threads per row, 16 rows per 256-thread block), loop
// over the fanout and accumulate in fp32 registers.  Each thread reads
// the row's idx/mask words itself (they sit in one cached line), and
// counts the valid entries for the mean.  No atomics: every output
// element is written by exactly one thread, so results are
// deterministic run to run.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py);
// the launch function returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

enum Reduce { kSum = 0, kMean = 1, kMax = 2 };

template <int VEC, int REDUCE>
__global__ void gather_seg_aggr_kernel(const float* __restrict__ table,
                                       const int32_t* __restrict__ idx,
                                       const bool* __restrict__ mask,
                                       float* __restrict__ out, long long n,
                                       int fanout, int d, int lanes) {
  const int rows_per_block = blockDim.x / lanes;
  const long long row =
      (long long)blockIdx.x * rows_per_block + threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  if (row >= n) return;
  const int32_t* row_idx = idx + row * fanout;
  const bool* row_mask = mask + row * fanout;
  for (int c = lane * VEC; c < d; c += lanes * VEC) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = REDUCE == kMax ? -CUDART_INF_F : 0.f;
    int count = 0;
    for (int j = 0; j < fanout; ++j) {
      if (!row_mask[j]) continue;
      ++count;
      const float* src = table + (long long)row_idx[j] * d + c;
      float x[VEC];
      if constexpr (VEC == 4) {
        float4 q = *reinterpret_cast<const float4*>(src);
        x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
      } else {
        x[0] = src[0];
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] = REDUCE == kMax ? fmaxf(acc[v], x[v]) : acc[v] + x[v];
    }
    float* dst = out + row * d + c;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float r = acc[v];
      if (REDUCE == kMean) r = r / (float)(count > 1 ? count : 1);
      if (REDUCE == kMax && count == 0) r = 0.f;
      dst[v] = r;
    }
  }
}

template <int VEC, int REDUCE>
void launch(const float* table, const int32_t* idx, const bool* mask,
            float* out, long long n, int fanout, int d, cudaStream_t stream) {
  int chunks = (d + VEC - 1) / VEC;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  const int threads = 256;
  const int rows_per_block = threads / lanes;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  gather_seg_aggr_kernel<VEC, REDUCE><<<(unsigned)blocks, threads, 0, stream>>>(
      table, idx, mask, out, n, fanout, d, lanes);
}

template <int VEC>
void dispatch_reduce(int reduce, const float* table, const int32_t* idx,
                     const bool* mask, float* out, long long n, int fanout,
                     int d, cudaStream_t stream) {
  if (reduce == kSum)
    launch<VEC, kSum>(table, idx, mask, out, n, fanout, d, stream);
  else if (reduce == kMean)
    launch<VEC, kMean>(table, idx, mask, out, n, fanout, d, stream);
  else
    launch<VEC, kMax>(table, idx, mask, out, n, fanout, d, stream);
}

}  // namespace

// reduce: 0 = sum, 1 = mean, 2 = max.  vec4 != 0 requires d % 4 == 0 and
// a 16-byte aligned table (checked by the Python wrapper).
extern "C" int gather_seg_aggr_launch(const void* table, const void* idx,
                                      const void* mask, void* out,
                                      long long n, long long fanout,
                                      long long d, long long reduce,
                                      long long vec4, void* stream) {
  if (reduce < 0 || reduce > 2) return (int)cudaErrorInvalidValue;
  if (n > 0 && d > 0) {
    auto s = (cudaStream_t)stream;
    if (vec4)
      dispatch_reduce<4>((int)reduce, (const float*)table,
                         (const int32_t*)idx, (const bool*)mask,
                         (float*)out, n, (int)fanout, (int)d, s);
    else
      dispatch_reduce<1>((int)reduce, (const float*)table,
                         (const int32_t*)idx, (const bool*)mask,
                         (float*)out, n, (int)fanout, (int)d, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
