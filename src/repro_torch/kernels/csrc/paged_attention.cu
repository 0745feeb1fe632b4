// Paged decode attention over the block-first KV pool: one query token per
// sequence, K/V read through the block table, GQA, fp32 online softmax.
//
// Replaces the Pallas TPU kernel paged_attention_tpu (body _paged_kernel),
// src/repro/kernels/paged_attention.py:31 and :84, pallas_call at :149, in
// both its modes: bf16/fp32 (entry repro_paged_attention) and the int8
// kv_scales mode with fused dequant (entry repro_paged_attention_q; the TPU
// body at :52-57, the scale BlockSpec at :121-128 and :134-136).
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
//
// In the int8 mode the pool stays int8 in device memory (16 values per
// 16-byte load, half the bf16 bytes): each tile is widened to fp32 on its
// way into shared memory and multiplied there by its (side, kv head) fp32
// scale, read through the same bt[b, j] row with the scale array's own
// strides (s_srow = L*2*Hkv per row, layer offset layer*2*Hkv, side stride
// Hkv). No dequantized copy of the pool exists.
#include "common.cuh"

namespace {

using repro_torch::Vec;
using repro_torch::kNegInf;
using repro_torch::warp_max;
using repro_torch::warp_sum;

// T: q/out type; KV: pool type (T, or int8_t with QUANT).
template <typename T, typename KV, int D, bool QUANT>
__global__ void paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ pool,
                                    const float* __restrict__ scales,
                                    const int* __restrict__ bt, const int* __restrict__ cl,
                                    T* __restrict__ out, int H, int Hkv, int MB, int P,
                                    long long s_row, long long layer_off, long long s_side,
                                    long long s_tok, long long s_srow, long long s_layer_off,
                                    float scale) {
  constexpr int VEC = Vec<KV>::VEC;
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
    const long long row = bt[(long long)b * MB + j];
    const long long base = row * s_row + layer_off + (long long)kvh * D;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (QUANT) {
      const float* sc = scales + row * s_srow + s_layer_off + kvh;
      ksc = sc[0];
      vsc = sc[Hkv];
    }
    __syncthreads();                   // the previous tile is consumed
    for (int i = threadIdx.x; i < P * VPR; i += blockDim.x) {
      const int t = i / VPR, c = (i % VPR) * VEC;
      float tmp[VEC];
      Vec<KV>::load(pool + base + t * s_tok + c, tmp);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Ks[t * (D + 1) + c + e] = QUANT ? tmp[e] * ksc : tmp[e];
      Vec<KV>::load(pool + base + s_side + t * s_tok + c, tmp);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vs[t * D + c + e] = QUANT ? tmp[e] * vsc : tmp[e];
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

struct Args {
  const void *q, *pool, *scales, *bt, *cl;
  void* out;
  int B, H, Hkv, MB, P;
  long long s_row, layer_off, s_side, s_tok, s_srow, s_layer_off;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D, bool QUANT>
int launch(const Args& a) {
  const int G = a.H / a.Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)a.P * (D + 1) + (size_t)a.P * D);
  auto kernel = paged_decode_kernel<T, KV, D, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(a.Hkv, a.B), G * 32, smem, a.stream>>>(
      (const T*)a.q, (const KV*)a.pool, (const float*)a.scales, (const int*)a.bt,
      (const int*)a.cl, (T*)a.out, a.H, a.Hkv, a.MB, a.P, a.s_row, a.layer_off, a.s_side,
      a.s_tok, a.s_srow, a.s_layer_off, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, bool QUANT>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, KV, 16, QUANT>(a);
    case 32: return launch<T, KV, 32, QUANT>(a);
    case 64: return launch<T, KV, 64, QUANT>(a);
    case 128: return launch<T, KV, 128, QUANT>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/out: (B, H, D); pool: block-first, element strides s_row (pool row),
// s_side (K -> V), s_tok (token in block), kv head stride D, layer_off the
// element offset of the selected layer inside a row (0 for a flat pool);
// bt: (B, MB) int32; cl: (B,) int32. dtype 0 = fp32, 1 = bf16 (q, pool and
// out alike).
extern "C" int repro_paged_attention(const void* q, const void* pool, const void* bt,
                                     const void* cl, void* out, int dtype, int B, int H,
                                     int Hkv, int D, int MB, int P, long long s_row,
                                     long long layer_off, long long s_side, long long s_tok,
                                     float scale, void* stream) {
  const Args a{q,     pool,  nullptr, bt,        cl,     out,   B, H, Hkv, MB, P,
               s_row, layer_off, s_side, s_tok, 0, 0, scale, (cudaStream_t)stream};
  if (dtype == 0) return dispatch_d<float, float, false>(D, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, __nv_bfloat16, false>(D, a);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: pool int8 with the strides above (in elements = bytes);
// scales fp32, s_srow floats per pool row, s_layer_off the selected layer's
// offset (0 for a flat pool), the V scale Hkv floats after the K scale.
// dtype (0 = fp32, 1 = bf16) is q's and out's.
extern "C" int repro_paged_attention_q(const void* q, const void* pool, const void* scales,
                                       const void* bt, const void* cl, void* out, int dtype,
                                       int B, int H, int Hkv, int D, int MB, int P,
                                       long long s_row, long long layer_off, long long s_side,
                                       long long s_tok, long long s_srow,
                                       long long s_layer_off, float scale, void* stream) {
  const Args a{q,     pool,      scales, bt,    cl,     out,         B,     H, Hkv, MB, P,
               s_row, layer_off, s_side, s_tok, s_srow, s_layer_off, scale, (cudaStream_t)stream};
  if (dtype == 0) return dispatch_d<float, int8_t, true>(D, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, int8_t, true>(D, a);
  return (int)cudaErrorInvalidValue;
}
