// Batched KV-pool row copy: pool[dst[i]] = pool[src[i]], src[i] < 0 a no-op.
//
// Replaces the Pallas TPU kernel kv_copy_tpu (body _copy_kernel),
// src/repro/kernels/kv_copy.py:21 and :29, pallas_call at :52.
//
// Bound on the card: device-memory bytes, 2 x rows x row bytes (each row
// read once, written once; a 2 MiB llama3-8b row moves 4 MiB) over
// 3.35 TB/s. The design streams 16-byte vectors, neighbouring threads on
// neighbouring addresses, over a grid of (row chunks, descriptors) so that
// one launch keeps every SM busy however few rows the batch holds. Rows
// whose byte count (or base) is not a multiple of 16 — the int8 tier's
// fp32 scale rows are 8 x L x Hkv bytes, 8 bytes for L = Hkv = 1 — take
// the same kernel with 4-byte words, or single bytes where even 4 does
// not divide. The TPU grid ran descriptors in order; here they run in
// parallel, so the wrapper admits only batches whose valid dst rows are
// unique and disjoint from the valid src rows. A no-op descriptor returns
// without writing (the Pallas index map aimed such steps at row 0; the
// plain version writes nothing, and so does this kernel).
#include "common.cuh"

namespace {

template <typename W>
__global__ void kv_copy_kernel(W* __restrict__ pool, const int* __restrict__ src,
                               const int* __restrict__ dst, long long row_words) {
  const int s = src[blockIdx.y];
  if (s < 0) return;
  const W* from = pool + (long long)s * row_words;
  W* to = pool + (long long)dst[blockIdx.y] * row_words;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < row_words;
       v += (long long)gridDim.x * blockDim.x)
    to[v] = from[v];
}

template <typename W>
int launch(void* pool, const void* src, const void* dst, int n, long long row_bytes,
           cudaStream_t stream) {
  const int threads = 256;
  const long long row_words = row_bytes / (long long)sizeof(W);
  long long chunks = (row_words + threads * 4 - 1) / (threads * 4);
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  kv_copy_kernel<W><<<dim3((unsigned)chunks, (unsigned)n), threads, 0, stream>>>(
      (W*)pool, (const int*)src, (const int*)dst, row_words);
  return (int)cudaGetLastError();
}

}  // namespace

// pool: base of the (rows, row_bytes) pool; src/dst: device int32 arrays of
// n descriptors. The word is 16 bytes when the base and row_bytes allow it.
extern "C" int repro_kv_copy(void* pool, const void* src, const void* dst, int n,
                             long long row_bytes, void* stream) {
  const unsigned long long a = (unsigned long long)pool | (unsigned long long)row_bytes;
  cudaStream_t st = (cudaStream_t)stream;
  if (a % 16 == 0) return launch<uint4>(pool, src, dst, n, row_bytes, st);
  if (a % 4 == 0) return launch<unsigned int>(pool, src, dst, n, row_bytes, st);
  return launch<unsigned char>(pool, src, dst, n, row_bytes, st);
}
