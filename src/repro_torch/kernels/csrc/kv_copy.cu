// Batched KV-pool row copy: pool[dst[i]] = pool[src[i]], src[i] < 0 a no-op.
//
// Replaces the Pallas TPU kernel kv_copy_tpu (body _copy_kernel),
// src/repro/kernels/kv_copy.py:21 and :29, pallas_call at :52.
//
// Bound on the card: device-memory bytes, 2 x rows x row bytes (each row
// read once, written once; a 2 MiB llama3-8b row moves 4 MiB) over
// 3.35 TB/s. The design streams 16-byte vectors, neighbouring threads on
// neighbouring addresses, over a grid of (row chunks, descriptors) so that
// one launch keeps every SM busy however few rows the batch holds. The
// TPU grid ran descriptors in order; here they run in parallel, so the
// wrapper admits only batches whose valid dst rows are unique and disjoint
// from the valid src rows. A no-op descriptor returns without writing
// (the Pallas index map aimed such steps at row 0; the plain version
// writes nothing, and so does this kernel).
#include "common.cuh"

namespace {

__global__ void kv_copy_kernel(uint4* __restrict__ pool, const int* __restrict__ src,
                               const int* __restrict__ dst, long long row_vecs) {
  const int s = src[blockIdx.y];
  if (s < 0) return;
  const uint4* from = pool + (long long)s * row_vecs;
  uint4* to = pool + (long long)dst[blockIdx.y] * row_vecs;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < row_vecs;
       v += (long long)gridDim.x * blockDim.x)
    to[v] = from[v];
}

}  // namespace

// pool: base of the (rows, row_bytes) pool, 16-byte aligned; src/dst:
// device int32 arrays of n descriptors; row_bytes a multiple of 16.
extern "C" int repro_kv_copy(void* pool, const void* src, const void* dst, int n,
                             long long row_bytes, void* stream) {
  const int threads = 256;
  const long long row_vecs = row_bytes / 16;
  long long chunks = (row_vecs + threads * 4 - 1) / (threads * 4);
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)chunks, (unsigned)n);
  kv_copy_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint4*)pool, (const int*)src, (const int*)dst, row_vecs);
  return (int)cudaGetLastError();
}
