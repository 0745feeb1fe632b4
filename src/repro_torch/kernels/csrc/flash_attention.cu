// Forward flash attention for chunked prefill: causal and/or sliding
// window, native GQA, an explicit query offset, fp32 online softmax.
//
// Replaces the Pallas TPU kernel flash_attention_tpu (body _flash_kernel),
// src/repro/kernels/flash_attention.py:22 and :72, pallas_call at :102. On
// the paged runner's prefill it takes the call site of the jnp
// models/attention.py::flash_attention (src/repro/serving/paged_runner.py:798),
// whose queries start at q_offset = start over a pow2-padded block context,
// so q_offset is a parameter here (the TPU kernel fixed it at Skv - Sq).
//
// Bound on the card: at prefill widths (T = 512 queries over a context of
// a thousand tokens, D = 128) the work is tensor-core FLOPs,
// 4 x (visible query-key pairs) x H x D, over 989 TFLOP/s in bf16. This
// first version runs on the CUDA cores in fp32 and sits far above that
// bound; wgmma and TMA come later. What its design does: one thread block
// per (16-query tile, query head, batch), four warps of four query rows
// each. K/V tiles of 32 tokens go through shared memory once per block and
// serve its 16 rows; the kv head is h / (H / Hkv), so GQA never repeats K/V
// in memory. The block visits only the kv tiles its rows can see (causal
// end, window start), so masked work is skipped rather than computed. Lane
// t scores key t of a tile for all four rows of its warp (K rows padded to
// D + 1 floats: conflict-free banks), and the P.V product broadcasts each
// probability by shuffle. A row that sees no key writes zeros.
#include "common.cuh"

namespace {

using repro_torch::Vec;
using repro_torch::kNegInf;
using repro_torch::warp_max;
using repro_torch::warp_sum;

constexpr int kRows = 4;                 // query rows per warp
constexpr int kWarps = 4;
constexpr int kBQ = kRows * kWarps;      // query rows per block
constexpr int kBK = 32;                  // keys per tile (one per lane)

template <typename T, int D>
__global__ void flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                                 int H, int Hkv, int q_offset, int causal, int window,
                                 float scale) {
  constexpr int VEC = Vec<T>::VEC;
  constexpr int EPL = (D + 31) / 32;
  constexpr int VPR = D / VEC;
  extern __shared__ float smem[];
  float* Qs = smem;                      // kBQ x D, pre-scaled
  float* Ks = Qs + kBQ * D;              // kBK x (D + 1)
  float* Vs = Ks + kBK * (D + 1);        // kBK x D
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kBQ * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    float tmp[VEC];
    if (q0 + r < Sq) {
      Vec<T>::load(q + (((long long)b * Sq + q0 + r) * H + h) * D + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qs[r * D + c + e] = tmp[e] * scale;
  }

  // the kv range any row of this block can see
  const int nrows = min(kBQ, Sq - q0);
  const int qlo = q_offset + q0, qhi = q_offset + q0 + nrows - 1;
  int kv_end = Skv;
  if (causal && qhi + 1 < kv_end) kv_end = qhi + 1;
  int kv_begin = 0;
  if (window > 0 && qlo - window + 1 > 0) kv_begin = qlo - window + 1;
  kv_begin -= kv_begin % kBK;

  float m[kRows], l[kRows], acc[kRows][EPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();                     // Qs written / previous tile consumed
    for (int i = threadIdx.x; i < kBK * VPR; i += blockDim.x) {
      const int t = i / VPR, c = (i % VPR) * VEC;
      float kt[VEC], vt[VEC];
      if (k0 + t < Skv) {
        const long long off = (((long long)b * Skv + k0 + t) * Hkv + kvh) * D + c;
        Vec<T>::load(k + off, kt);
        Vec<T>::load(v + off, vt);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kt[e] = vt[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[t * (D + 1) + c + e] = kt[e];
        Vs[t * D + c + e] = vt[e];
      }
    }
    __syncthreads();

    const int kpos = k0 + lane;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    const float* qw = Qs + warp * kRows * D;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += qw[r * D + d] * kd;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q_offset + q0 + warp * kRows + r;
      const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      const float sr = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = ok ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
      m[r] = m_new;
      s[r] = p;
    }
    for (int t = 0; t < kBK; ++t) {
      float pt[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pt[r] = __shfl_sync(0xffffffffu, s[r], t);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        if (d < D) {
          const float vd = Vs[t * D + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][e] += pt[r] * vd;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i >= Sq) continue;
    T* orow = o + (((long long)b * Sq + i) * H + h) * D;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) orow[d] = Vec<T>::from_float(acc[r][e] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int Hkv, int q_offset, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, Hkv, q_offset, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Sq,
               int Skv, int H, int Hkv, int q_offset, int causal, int window, float scale,
               cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, causal, window, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); all contiguous. Query row i
// sits at absolute kv position q_offset + i. dtype 0 = fp32, 1 = bf16.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int dtype, int B, int Sq, int Skv, int H, int Hkv, int D,
                                     int q_offset, int causal, int window, float scale,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, causal, window,
                             scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, causal,
                                     window, scale, st);
  return (int)cudaErrorInvalidValue;
}
