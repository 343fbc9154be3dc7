// Segmented random gather for neighbor sampling.
//
// Replaces the Pallas TPU kernel `nbr_sample_pallas` / `_nbr_sample_kernel`
// (src/repro/kernels/nbr_sample/kernel.py).  Row i owns the CSR segment
// [starts[i], starts[i] + degs[i]) of the per-etype col_idx / edge_id
// tables and draws `fanout` entries with replacement, one per uniform
// 32-bit word of `bits`: pos = starts[i] + bits % max(deg, 1), clamped
// into [0, E-1], then gathered from both tables.  mask = deg > 0.
//
// Bound: bytes.  Per draw it reads one 4-byte word of bits and two
// 4-byte table entries and writes 9 bytes; there is no arithmetic to
// speak of.  Design: one thread per (row, draw), so consecutive threads
// read consecutive words of `bits` and write consecutive outputs
// (coalesced); the `fanout` threads of a row share its starts/degs
// words (one cached line) and read table entries inside the row's
// segment.  The modulo is the native 32-bit unsigned one, as in the
// reference.  The bits are drawn outside the kernel (threefry in
// repro_torch/core/prng.py), so kernel and plain version take the same
// words.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py);
// the launch function returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void nbr_sample_kernel(const uint32_t* __restrict__ bits,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ degs,
                                  const int32_t* __restrict__ col_idx,
                                  const int32_t* __restrict__ edge_id,
                                  int32_t* __restrict__ nbr,
                                  int32_t* __restrict__ eid,
                                  bool* __restrict__ mask,
                                  long long total, int fanout,
                                  long long num_entries) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long row = i / fanout;
  int deg = degs[row];
  uint32_t span = deg > 1 ? (uint32_t)deg : 1u;
  long long pos = (long long)starts[row] + (long long)(bits[i] % span);
  if (pos < 0) pos = 0;
  if (pos > num_entries - 1) pos = num_entries - 1;
  nbr[i] = col_idx[pos];
  eid[i] = edge_id[pos];
  mask[i] = deg > 0;
}

}  // namespace

extern "C" int nbr_sample_launch(const void* bits, const void* starts,
                                 const void* degs, const void* col_idx,
                                 const void* edge_id, void* nbr, void* eid,
                                 void* mask, long long n, long long fanout,
                                 long long num_entries, void* stream) {
  long long total = n * fanout;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    nbr_sample_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)bits, (const int32_t*)starts, (const int32_t*)degs,
        (const int32_t*)col_idx, (const int32_t*)edge_id, (int32_t*)nbr,
        (int32_t*)eid, (bool*)mask, total, (int)fanout, num_entries);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
