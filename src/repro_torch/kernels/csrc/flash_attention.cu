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
// 4 x (visible query-key pairs) x H x D, over 989 TFLOP/s in bf16.
//
// Two kernels, chosen by dtype:
//
// * bf16: flash_fwd_wg_kernel, on the tensor cores through wgmma. One
//   warpgroup per (64-query tile, query head, batch); S = Q.K^T and
//   O += P.V are wgmma m64n64k16 (bf16 in, fp32 accumulate). Q (K-major)
//   is the shared-memory A operand of S, read by the tensor cores through
//   a descriptor; P's fragments are the register A operand of O, so P
//   never leaves registers: the online softmax runs on the accumulator
//   layout and P is rounded to bf16 in place. K (K-major) and V (MN-major,
//   transposed by the descriptor) are the shared-memory B operand,
//   128B-swizzled. Q's tile (once) and K/V tiles of 64 tokens of one kv
//   head (into a two-stage ring) arrive by TMA: one thread asks for each
//   64 x 64 box (the hardware swizzles it and fills rows past Sq or Skv
//   and columns past D with zeros) and an mbarrier per stage says when its
//   bytes have landed, so tile j+1 loads while tile j is computed. The tensor maps are built on
//   the host at each call through cudaGetDriverEntryPoint, so nothing
//   links libcuda. Keeping Q out of the registers leaves them to the O
//   accumulator, 128 fp32 a thread at D = 256.
// * fp32: flash_fwd_kernel, on the CUDA cores in fp32. The reduced model's
//   lossless checks hold fp32 to 1e-5, which TF32 tensor cores would not.
//   One block per (16-query tile, query head, batch), four warps of four
//   rows; K/V tiles of 32 keys through shared memory.
//
// Both: the kv head is h / (H / Hkv), so GQA never repeats K/V in memory;
// a block visits only the kv tiles its rows can see (causal end, window
// start), so masked work is skipped rather than computed; ragged Sq and
// Skv edges are masked; a row that sees no key writes zeros.
#include <cuda.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

// ------------------------------------------------- fp32: the CUDA cores

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

// ------------------------------------------------ bf16: the tensor cores

constexpr int kWgM = 64;                 // query rows per block: one warpgroup
constexpr int kWgN = 64;                 // keys per kv tile
constexpr int kWgStages = 2;             // kv tiles in flight
constexpr int kWgThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// d (64x64 fp32, the m64n64 accumulator layout) += a (64x16 bf16, this
// warp's 16 rows in the mma.sync A-fragment layout) . b (16x64 bf16 in
// shared memory, described by desc; TRANS_B: b is MN-major), as one
// asynchronous warpgroup operation; scale_d = 0 overwrites d. (_ss: a
// too is in shared memory, K-major, described by desc_a.)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a, uint64_t desc,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// shared-memory matrix descriptor of a 128B-swizzled operand: rows of 64
// bf16 (128 bytes), 8-row atoms of 1024 bytes at 1024-byte alignment
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// mbarriers and TMA: one thread expects a stage's bytes and asks for its
// boxes; every thread waits on the stage's phase
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// A lost transfer traps (a launch error) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}
// box (c0, c1, c2, c3) of the 4-d tensor map into shared memory at dst
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep registers an asynchronous wgmma reads or writes in place around it
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// One warpgroup per (64 query rows, query head, batch): S = Q.K^T and
// O += P.V are wgmma m64n64k16, Q (K-major) and K (K-major) and V
// (MN-major, transposed by the descriptor) read from 128B-swizzled shared
// memory and P's fragments the register A operand of O; the online
// softmax runs on the accumulators. Head dims below 64 are zero-padded to
// 64. tmq, tmk and tmv map q, k and v as (D, heads, S, B) with 64 x 1 x
// 64 x 1 boxes, 128B-swizzled.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                    int Sq, int Skv, int H, int Hkv, int q_offset, int causal, int window,
                    float scale) {
  constexpr int DP = D < 64 ? 64 : D;    // padded head dim
  constexpr int DB = DP / 64;            // 64-wide column blocks
  constexpr int KS = DP / 16, NT = kWgN / 8;
  constexpr uint32_t kBlk = kWgN * 128;                   // one 64-wide block of a tile
  constexpr uint32_t kTile = DB * kBlk;                   // a K or V tile
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t sKV = base;                              // stage s: K then V
  const uint32_t sQ = base + kWgStages * 2 * kTile;       // DB blocks of kBlk
  const uint32_t sBar = sQ + kTile;                       // an mbarrier per stage, then Q's
  const uint32_t qBar = sBar + kWgStages * 8;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kWgM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nrows = min(kWgM, Sq - q0);
  const int qlo = q_offset + q0, qhi = q_offset + q0 + nrows - 1;
  int kv_end = Skv;
  if (causal && qhi + 1 < kv_end) kv_end = qhi + 1;
  int kv_begin = 0;
  if (window > 0 && qlo - window + 1 > 0) kv_begin = qlo - window + 1;
  const int t_begin = kv_begin / kWgN;
  const int n_tiles = kv_end > kv_begin ? (kv_end + kWgN - 1) / kWgN - t_begin : 0;

  // tile j of this kv head into a stage: K's and V's 64-column blocks
  auto load_tile = [&](int j, int stage) {
    if (tid != 0) return;
    const int k0 = (t_begin + j) * kWgN;
    const uint32_t sk = sKV + stage * 2 * kTile, sv = sk + kTile, bar = sBar + stage * 8;
    mbar_expect_tx(bar, 2 * DB * kBlk);
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      tma_load_4d(sk + d * kBlk, &tmk, bar, d * 64, kvh, k0, b);
      tma_load_4d(sv + d * kBlk, &tmv, bar, d * 64, kvh, k0, b);
    }
  };
  if (tid == 0) {
    for (int st = 0; st <= kWgStages; ++st) mbar_init(sBar + st * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                       // the barriers are initialised

  if (tid == 0) {
    mbar_expect_tx(qBar, kTile);
#pragma unroll
    for (int d = 0; d < DB; ++d) tma_load_4d(sQ + d * kBlk, &tmq, qBar, d * 64, h, q0, b);
  }
#pragma unroll
  for (int j = 0; j < kWgStages - 1; ++j)
    if (j < n_tiles) load_tile(j, j);
  mbar_wait(qBar, 0);                    // Q has landed

  float acc[DB][32];
#pragma unroll
  for (int d = 0; d < DB; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[d][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl = scale * kLog2e;
  const int row0 = q_offset + q0 + warp * 16 + (lane >> 2);
  const int tc = 2 * (lane & 3);

  for (int j = 0; j < n_tiles; ++j) {
    const int nx = j + kWgStages - 1;
    if (nx < n_tiles) load_tile(nx, nx % kWgStages);
    mbar_wait(sBar + (j % kWgStages) * 8, (j / kWgStages) & 1);   // tile j has landed
    const uint32_t sk = sKV + (j % kWgStages) * 2 * kTile, sv = sk + kTile;
    const int k0 = (t_begin + j) * kWgN;

    // S = Q . K^T (K-major A and B: 16 of a row's 64 columns per step)
    float s[32];
    fence_regs<32>(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t col = (ks / 4) * kBlk + (ks % 4) * 32;
      wgmma_m64n64k16_ss<0>(s, sw128_desc(sQ + col, 0, 1024), sw128_desc(sk + col, 0, 1024),
                            ks > 0);
    }
    wgmma_commit_wait();
    fence_regs<32>(s);

    const bool edge = k0 + kWgN > Skv || (causal && k0 + kWgN - 1 > qlo + warp * 16) ||
                      (window > 0 && k0 <= qhi - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * sl;
        if (edge) {
          const int kpos = k0 + n * 8 + tc + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) x = -INFINITY;
        }
        s[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - mu[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int d = 0; d < DB; ++d)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[d][i] *= corr[(i >> 1) & 1];

    // O += P . V (V MN-major: transposed by the descriptor)
    uint32_t pa[kWgN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // every register the wgmmas read (P's fragments, the rescaled O) is
    // written before wgmma.fence: the fences pin those writes above it
    fence_regs<4 * (kWgN / 16)>(&pa[0][0]);
#pragma unroll
    for (int d = 0; d < DB; ++d) fence_regs<32>(acc[d]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgN / 16; ++kk)
#pragma unroll
      for (int d = 0; d < DB; ++d)
        wgmma_m64n64k16<1>(acc[d], pa[kk], sw128_desc(sv + d * kBlk + kk * 2048, kBlk, 1024), 1);
    wgmma_commit_wait();
#pragma unroll
    for (int d = 0; d < DB; ++d) fence_regs<32>(acc[d]);
    fence_regs<4 * (kWgN / 16)>(&pa[0][0]);
    __syncthreads();                     // this stage may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + warp * 16 + (lane >> 2) + r * 8;
    if (i >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + (((long long)b * Sq + i) * H + h) * D + tc;
#pragma unroll
    for (int d = 0; d < DB; ++d)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (d * 64 + n * 8 < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d * 64 + n * 8) = __floats2bfloat162_rn(
              acc[d][4 * n + 2 * r] * inv, acc[d][4 * n + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int Hkv, int q_offset, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, H, Hkv, q_offset, causal,
      window, scale);
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no libcuda link)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
      p = nullptr;
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// x (B, S, Hx, D) bf16 as a 4-d tensor map (D, Hx, S, B): 64 x 1 x 64 x 1
// boxes, 128B-swizzled; elements outside the tensor read as zero
bool bshd_map(CUtensorMap* map, const void* x, int B, int Skv, int Hkv, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)Skv * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kWgN, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wg(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
              int H, int Hkv, int q_offset, int causal, int window, float scale,
              cudaStream_t stream) {
  constexpr int DB = (D < 64 ? 64 : D) / 64;
  CUtensorMap tmq, tmk, tmv;
  if (!bshd_map(&tmq, q, B, Sq, H, D) || !bshd_map(&tmk, k, B, Skv, Hkv, D) ||
      !bshd_map(&tmv, v, B, Skv, Hkv, D))
    return (int)cudaErrorInvalidValue;
  // 1024-byte alignment slack, then per stage K and V tiles of DB
  // 64-column blocks (kWgN rows of 128 bytes each), then the Q tile (DB
  // blocks of kWgM rows), then an 8-byte mbarrier per stage and Q's
  const size_t smem = 1024 + (size_t)(kWgStages * 2 + 1) * DB * kWgN * 128 + 8 * (kWgStages + 1);
  auto kernel = flash_fwd_wg_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + kWgM - 1) / kWgM, H, B);
  kernel<<<grid, kWgThreads, smem, stream>>>(tmq, tmk, tmv, (__nv_bfloat16*)o, Sq, Skv, H, Hkv,
                                             q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

#define REPRO_FLASH_ARGS q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, causal, window, scale, st

}  // namespace

// q/o: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); all contiguous. Query row i
// sits at absolute kv position q_offset + i. dtype 0 = fp32 (the CUDA-core
// kernel), 1 = bf16 (the wgmma kernel).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int dtype, int B, int Sq, int Skv, int H, int Hkv, int D,
                                     int q_offset, int causal, int window, float scale,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (D) {
      case 16: return launch<float, 16>(REPRO_FLASH_ARGS);
      case 32: return launch<float, 32>(REPRO_FLASH_ARGS);
      case 64: return launch<float, 64>(REPRO_FLASH_ARGS);
      case 128: return launch<float, 128>(REPRO_FLASH_ARGS);
      case 256: return launch<float, 256>(REPRO_FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_wg<16>(REPRO_FLASH_ARGS);
      case 32: return launch_wg<32>(REPRO_FLASH_ARGS);
      case 64: return launch_wg<64>(REPRO_FLASH_ARGS);
      case 128: return launch_wg<128>(REPRO_FLASH_ARGS);
      case 256: return launch_wg<256>(REPRO_FLASH_ARGS);
    }
  }
  return (int)cudaErrorInvalidValue;
}
