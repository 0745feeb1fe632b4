// Paged decode attention over the block-first KV pool: one query token per
// sequence, K/V read through the block table, GQA, fp32 online softmax.
//
// Replaces the Pallas TPU kernel paged_attention_tpu (body _paged_kernel),
// src/repro/kernels/paged_attention.py:31 and :84, pallas_call at :149,
// in its bf16/fp32 mode (the int8 kv_scales mode is not ported yet).
//
// Bound on the card: device-memory bytes. Each sequence's context is read
// once, sum_b ctx_b x Hkv x D x 2 (K and V) x element bytes, against a few
// hundred FLOPs per kilobyte: far below the H100's ridge. The design
// therefore reads every K/V byte exactly once: one thread block per
// (kv head, sequence), whose G = H / Hkv warps are the G query heads that
// share that kv head. The block walks only the blocks its context covers
// (the TPU grid walked all MB and masked), stages each (P, D) K and V tile
// in shared memory with 16-byte loads, and all G warps read the tile from
// there. It addresses (row, layer) by strides, so no slice of the pool is
// ever copied. Lane t scores token t of the tile (K rows padded to D + 1
// floats, so the 32 lanes hit 32 banks); the P.V product broadcasts each
// probability by shuffle, lanes striding D. Padded batch lanes point at
// the trash row with context 1 and get a finite output.
#include "common.cuh"

namespace {

using repro_torch::Vec;
using repro_torch::kNegInf;
using repro_torch::warp_max;
using repro_torch::warp_sum;

template <typename T, int D>
__global__ void paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                                    const int* __restrict__ bt, const int* __restrict__ cl,
                                    T* __restrict__ out, int H, int Hkv, int MB, int P,
                                    long long s_row, long long layer_off, long long s_side,
                                    long long s_tok, float scale) {
  constexpr int VEC = Vec<T>::VEC;
  constexpr int EPL = (D + 31) / 32;   // elements of D per lane
  constexpr int VPR = D / VEC;         // 16-byte vectors per token row
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ float smem[];
  float* Qs = smem;                    // G x D, pre-scaled
  float* Ks = Qs + G * D;              // P x (D + 1)
  float* Vs = Ks + P * (D + 1);        // P x D

  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    Qs[i] = Vec<T>::to_float(qb[i]) * scale;

  const int ctx = cl[b];
  int nblk = (ctx + P - 1) / P;
  if (nblk > MB) nblk = MB;
  float m = kNegInf, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    const long long base =
        (long long)bt[(long long)b * MB + j] * s_row + layer_off + (long long)kvh * D;
    __syncthreads();                   // the previous tile is consumed
    for (int i = threadIdx.x; i < P * VPR; i += blockDim.x) {
      const int t = i / VPR, c = (i % VPR) * VEC;
      float tmp[VEC];
      Vec<T>::load(pool + base + t * s_tok + c, tmp);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Ks[t * (D + 1) + c + e] = tmp[e];
      Vec<T>::load(pool + base + s_side + t * s_tok + c, tmp);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vs[t * D + c + e] = tmp[e];
    }
    __syncthreads();

    const bool ok = lane < P && j * P + lane < ctx;
    float s = kNegInf;
    if (ok) {
      float a = 0.f;
      const float* qr = Qs + warp * D;
      const float* kr = Ks + lane * (D + 1);
#pragma unroll 16
      for (int d = 0; d < D; ++d) a += qr[d] * kr[d];
      s = a;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = ok ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
    for (int t = 0; t < P; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc[e] += pt * Vs[t * D + d];
      }
    }
    m = m_new;
  }

  T* ob = out + ((long long)b * H + (long long)kvh * G + warp) * D;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    if (d < D) ob[d] = Vec<T>::from_float(acc[e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* pool, const void* bt, const void* cl, void* out,
           int B, int H, int Hkv, int MB, int P, long long s_row, long long layer_off,
           long long s_side, long long s_tok, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * ((size_t)G * D + (size_t)P * (D + 1) + (size_t)P * D);
  paged_decode_kernel<T, D><<<dim3(Hkv, B), G * 32, smem, stream>>>(
      (const T*)q, (const T*)pool, (const int*)bt, (const int*)cl, (T*)out, H, Hkv, MB, P,
      s_row, layer_off, s_side, s_tok, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* pool, const void* bt, const void* cl,
               void* out, int B, int H, int Hkv, int MB, int P, long long s_row,
               long long layer_off, long long s_side, long long s_tok, float scale,
               cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, pool, bt, cl, out, B, H, Hkv, MB, P, s_row, layer_off, s_side, s_tok, scale, st);
    case 32: return launch<T, 32>(q, pool, bt, cl, out, B, H, Hkv, MB, P, s_row, layer_off, s_side, s_tok, scale, st);
    case 64: return launch<T, 64>(q, pool, bt, cl, out, B, H, Hkv, MB, P, s_row, layer_off, s_side, s_tok, scale, st);
    case 128: return launch<T, 128>(q, pool, bt, cl, out, B, H, Hkv, MB, P, s_row, layer_off, s_side, s_tok, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/out: (B, H, D); pool: block-first, element strides s_row (pool row),
// s_side (K -> V), s_tok (token in block), kv head stride D, layer_off the
// element offset of the selected layer inside a row (0 for a flat pool);
// bt: (B, MB) int32; cl: (B,) int32. dtype 0 = fp32, 1 = bf16.
extern "C" int repro_paged_attention(const void* q, const void* pool, const void* bt,
                                     const void* cl, void* out, int dtype, int B, int H,
                                     int Hkv, int D, int MB, int P, long long s_row,
                                     long long layer_off, long long s_side, long long s_tok,
                                     float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(D, q, pool, bt, cl, out, B, H, Hkv, MB, P, s_row, layer_off,
                             s_side, s_tok, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, pool, bt, cl, out, B, H, Hkv, MB, P, s_row,
                                     layer_off, s_side, s_tok, scale, st);
  return (int)cudaErrorInvalidValue;
}
