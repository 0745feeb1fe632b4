// Paged decode attention over the block-first KV pool: one query token per
// sequence, K/V read through the block table, GQA, fp32 online softmax,
// split-K over the context across a thread-block cluster.
//
// Replaces the Pallas TPU kernel paged_attention_tpu (body _paged_kernel),
// src/repro/kernels/paged_attention.py:31 and :84, pallas_call at :149, in
// both its modes: bf16/fp32 (entry repro_paged_attention) and the int8
// kv_scales mode with fused dequant (entry repro_paged_attention_q; the TPU
// body at :52-57, the scale BlockSpec at :121-128 and :134-136).
//
// Bound on the card: device-memory bytes. Each sequence's context is read
// once, sum_b ctx_b x Hkv x D x 2 (K and V) x element bytes, against a few
// hundred FLOPs per kilobyte: far below the H100's ridge. What the design
// does about it:
//
// * Every K/V byte is read from device memory once. A thread block serves
//   one (kv head, sequence, split) and all G = H / Hkv query heads of that
//   kv head read each tile from its shared memory.
// * Two kernels behind one entry, each serving both pool types. With bf16
//   q (the serving path) and G <= 16, paged_decode_tc_kernel runs both
//   products on the tensor cores: the G heads are the rows of one
//   mma.sync m16n8k16 tile, so a K/V element is widened and multiplied
//   once for all heads. With fp32 q (held to 1e-5, which bf16 tensor cores
//   would not keep) or wider groups, paged_decode_kernel runs on the CUDA
//   cores: warp g is query head g, lane t scores token t of a stage. On
//   bf16 q the tensor-core kernel is 11-32% faster than the CUDA-core one
//   at llama3-8b's decode shapes, both modes, B = 8 and 32, measured in one
//   run on one card (PERF.md), so it stays.
// * Split-K in one launch. A cluster of S CTAs (S <= 8, a power of two the
//   wrapper picks from the block table's width) serves one (kv head,
//   sequence); CTA s walks split s of the context (split_of). A sequence's
//   splits depend only on its own context length and two constants, so
//   its output does not depend on the batch it sits in. Splits past the
//   context are empty. After cluster.sync() the partials (m, l, acc of
//   each query head) are combined through distributed shared memory
//   (map_shared_rank), in split order, skipping empty splits; a second
//   cluster.sync() keeps each CTA's shared memory alive until read. No
//   second kernel, no workspace in device memory.
// * An asynchronous tile ring. A stage (64 tokens on the tensor cores, 32
//   on the CUDA cores) fetches each token's K and V rows by 16-byte
//   cp.async through the block table into rows padded by 16 bytes, so
//   ldmatrix, or 32 lanes on 32 tokens, hit distinct banks; 2-4 stages
//   are in flight, so stage j+1 loads while stage j is computed, with one
//   barrier pair per stage. A stage's block-table rows are read before
//   any of its copies is issued.
// * The int8 mode keeps the tile int8 in shared memory: scores are taken
//   on the raw values (widened exactly to bf16 on the tensor-core path)
//   and multiplied by the token's K scale, and the V scale is folded into
//   its probability before P.V. The (side, kv head) fp32 scales ride the
//   same ring, read through the same bt[b, j] row with the scale array's
//   own strides. No dequantized copy exists.
// * (row, layer) of the pool and of the scales are addressed by strides,
//   so no slice of either is copied. Padded batch lanes point at the trash
//   row with context 1 and get a finite output.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace repro_torch;

constexpr int kTS = 32;                  // tokens per stage, one per lane

// The split plan, as kernels/ref.py has it (SPLIT_UNIT, MAX_SPLITS; a CPU
// test holds the constants equal): each split of a context holds
// kSplitUnit * ceil(ctx / (kSplitUnit * kMaxSplits)) tokens, so a
// sequence's splits depend on its own context length alone.
constexpr int kSplitUnit = 128;
constexpr int kMaxSplits = 8;
static_assert(kSplitUnit % kTS == 0, "a split starts on a stage boundary");

struct Split {
  int n, lo, hi;                         // non-empty splits; split s's tokens
};
__device__ __forceinline__ Split split_of(int ctx, int s) {
  constexpr int kPer = kSplitUnit * kMaxSplits;
  const int tps = kSplitUnit * max(1, (ctx + kPer - 1) / kPer);
  return {(ctx + tps - 1) / tps, s * tps, min(ctx, (s + 1) * tps)};
}

// N contiguous KV values from shared memory (one aligned vector), as fp32
template <typename KV, int N>
__device__ __forceinline__ void load_cols(const unsigned char* p, float* dst) {
  constexpr int BYTES = N * (int)sizeof(KV);
  union {
    uint4 u4; uint2 u2; uint32_t w[4]; uint16_t h[8]; uint8_t c[16];
  } t;
  if constexpr (BYTES == 16) t.u4 = *reinterpret_cast<const uint4*>(p);
  else if constexpr (BYTES == 8) t.u2 = *reinterpret_cast<const uint2*>(p);
  else if constexpr (BYTES == 4) t.w[0] = *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (BYTES == 2) t.h[0] = *reinterpret_cast<const uint16_t*>(p);
  else t.c[0] = *p;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (sizeof(KV) == 4) dst[e] = __uint_as_float(t.w[e]);
    else if constexpr (sizeof(KV) == 2) dst[e] = __uint_as_float((uint32_t)t.h[e] << 16);
    else dst[e] = static_cast<float>(static_cast<int8_t>(t.c[e]));
  }
}

template <typename KV>
struct Ring {
  static constexpr int kStages = sizeof(KV) == 1 ? 4 : (sizeof(KV) == 2 ? 3 : 2);
};

template <typename KV, int D>
struct Layout {
  static constexpr int ROW = D * (int)sizeof(KV) + 16;   // padded token row, bytes
  static constexpr int CH = D * (int)sizeof(KV) / 16;    // 16-byte chunks per row
  static constexpr int STAGE = 2 * kTS * ROW;            // K rows, then V rows
};

// The cluster's CTAs share the G x D outputs of one (kv head, sequence):
// each output adds the partials (m, l, acc) of the nsplit non-empty splits
// in split order, reading all of them from the other CTAs' shared memory
// at once. part: G x D acc, then G m, then G l, at the same offset in
// every CTA of the cluster.
template <typename T>
__device__ __forceinline__ void cluster_combine(cg::cluster_group cluster, float* part,
                                                int G, int D, int nsplit, T* ob) {
  const int S = (int)cluster.num_blocks(), nthr = blockDim.x;
  for (int i = (int)cluster.block_rank() * nthr + threadIdx.x; i < G * D; i += S * nthr) {
    const int g = i / D;
    float mr[kMaxSplits], lr[kMaxSplits], ar[kMaxSplits];
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < nsplit) {
        const float* pr = cluster.map_shared_rank(part, r);
        mr[r] = pr[G * D + g];
        lr[r] = pr[G * D + G + g];
        ar[r] = pr[i];
        M = fmaxf(M, mr[r]);
      }
    }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < nsplit) {
        const float w = expf(mr[r] - M);
        num += w * ar[r];
        den += w * lr[r];
      }
    }
    ob[i] = Vec<T>::from_float(num / fmaxf(den, 1e-30f));
  }
}

// T: q/out type; KV: pool type (T, or int8_t with QUANT). One warp per
// query head, up to 32 (1024 threads: at most 64 registers each).
template <typename T, typename KV, int D, bool QUANT>
__global__ void __launch_bounds__(1024) paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ pool,
                                    const float* __restrict__ scales,
                                    const int* __restrict__ bt, const int* __restrict__ cl,
                                    T* __restrict__ out, int H, int Hkv, int MB, int P,
                                    long long s_row, long long layer_off, long long s_side,
                                    long long s_tok, long long s_srow, long long s_layer_off,
                                    float scale) {
  using LY = Layout<KV, D>;
  constexpr int NST = Ring<KV>::kStages;
  constexpr int VEC = Vec<KV>::VEC;      // values per 16-byte chunk
  constexpr int CPL = D >= 32 ? D / 32 : 1;   // P.V columns per lane
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                // NST stages
  float* Qs = reinterpret_cast<float*>(smem + NST * LY::STAGE);   // G x D, pre-scaled
  float* Part = Qs + G * D;              // G x D acc, then G m, then G l
  float* Sc = Part + G * (D + 2);        // NST x (K, V) x kTS token scales

  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < G * D; i += nthr) Qs[i] = Vec<T>::to_float(qb[i]) * scale;

  // this sequence's splits: a function of its context length only
  const int ctx = max(0, min(cl[b], MB * P));
  const Split sp = split_of(ctx, split);
  const int lo = sp.lo, hi = sp.hi;
  const int nstage = hi > lo ? (hi - lo + kTS - 1) / kTS : 0;
  const int* btb = bt + (long long)b * MB;
  const int pshift = __ffs(P) - 1;       // P is a power of two dividing kTS

  // A stage spans kTS / P whole blocks. Lane j of every warp reads block j's
  // pool row once, before any copy is issued; each copy takes its row by
  // shuffle. (Read per copy, each 16-byte cp.async would wait on its own
  // block-table read: the copy's asm volatile keeps the next read below it.)
  // Every warp runs the copy loops whole: their trip counts and the thread
  // count are multiples of 32.
  auto load = [&](int st, int slot) {
    unsigned char* kbuf = ring + slot * LY::STAGE;
    const int t0 = lo + st * kTS;
    const int row = (lane < (kTS >> pshift) && t0 + (lane << pshift) < hi)
                        ? __ldg(btb + (t0 >> pshift) + lane) : 0;
    for (int i = tid; i < kTS * 2 * LY::CH; i += nthr) {
      const int t = i / (2 * LY::CH), side = (i / LY::CH) & 1, c = i % LY::CH;
      const int tok = t0 + t;
      const bool ok = tok < hi;
      const long long r = __shfl_sync(0xffffffffu, row, t >> pshift);
      const KV* src = ok ? pool + r * s_row + layer_off + side * s_side +
                               (long long)(tok & (P - 1)) * s_tok + (long long)kvh * D + c * VEC
                         : pool;
      cp_async16(smem_u32(kbuf + (side * kTS + t) * LY::ROW + c * 16), src, ok);
    }
    if constexpr (QUANT) {
      float* sc = Sc + slot * 2 * kTS;
      for (int i = tid; i < 2 * kTS; i += nthr) {
        const int side = i / kTS, t = i % kTS, tok = t0 + t;
        const bool ok = tok < hi;
        const long long r = __shfl_sync(0xffffffffu, row, t >> pshift);
        const float* src = ok ? scales + r * s_srow + s_layer_off + side * Hkv + kvh : scales;
        cp_async4(smem_u32(sc + i), src, ok);
      }
    }
  };

  float m = -INFINITY, l = 0.f, acc[CPL];
#pragma unroll
  for (int e = 0; e < CPL; ++e) acc[e] = 0.f;
  const float* qr = Qs + warp * D;

#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < nstage) load(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < nstage; ++st) {
    const int nx = st + NST - 1;
    if (nx < nstage) load(nx, nx % NST);
    cp_async_commit();
    cp_async_wait<NST - 1>();            // stage st has landed
    __syncthreads();

    const int slot = st % NST;
    const unsigned char* kbuf = ring + slot * LY::STAGE;
    const unsigned char* vbuf = kbuf + kTS * LY::ROW;
    const int t0 = lo + st * kTS;
    const bool ok = t0 + lane < hi;
    float s = -INFINITY;
    if (ok) {
      float a = 0.f;
      const unsigned char* kr = kbuf + lane * LY::ROW;
#pragma unroll
      for (int c = 0; c < LY::CH; ++c) {
        float kv[VEC];
        Vec<KV>::load(reinterpret_cast<const KV*>(kr + c * 16), kv);
        const float4* q4 = reinterpret_cast<const float4*>(qr + c * VEC);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qv = q4[e];
          a += qv.x * kv[4 * e] + qv.y * kv[4 * e + 1] + qv.z * kv[4 * e + 2] +
               qv.w * kv[4 * e + 3];
        }
      }
      if constexpr (QUANT) a *= Sc[slot * 2 * kTS + lane];
      s = a;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float mu = m_new == -INFINITY ? 0.f : m_new;   // nothing visible yet
    float p = expf(s - mu);
    const float corr = expf(m - mu);
    l = l * corr + warp_sum(p);
    m = m_new;
    if constexpr (QUANT) p *= Sc[slot * 2 * kTS + kTS + lane];
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[e] *= corr;
    const int nt = min(kTS, hi - t0);
    const bool cols = lane * CPL < D;    // D = 16 leaves half the lanes idle
    const unsigned char* vc = vbuf + lane * CPL * (int)sizeof(KV);
    for (int t = 0; t < nt; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
      if (cols) {
        float vv[CPL];
        load_cols<KV, CPL>(vc + t * LY::ROW, vv);
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[e] += pt * vv[e];
      }
    }
    __syncthreads();                     // this slot may be refilled
  }
  cp_async_wait<0>();

  if (lane * CPL < D) {
#pragma unroll
    for (int e = 0; e < CPL; ++e) Part[warp * D + lane * CPL + e] = acc[e];
  }
  if (lane == 0) {
    Part[G * D + warp] = m;
    Part[G * D + G + warp] = l;
  }
  cluster.sync();                        // every split's partials are written

  cluster_combine(cluster, Part, G, D, sp.n,
                  out + ((long long)b * H + (long long)kvh * G) * D);
  cluster.sync();                        // partials stay until all are read
}

// ------------------------------------------- bf16 q: the tensor cores

constexpr int kTcTok = 64;               // tokens per stage: 16 per warp
constexpr int kTcWarps = 4;
static_assert(kSplitUnit % kTcTok == 0, "a split starts on a stage boundary");

template <typename KV>
struct TcRing {
  static constexpr int kStages = sizeof(KV) == 1 ? 3 : 2;
};

// two int8 K/V values (lo first) as a bf16 pair: exact, |x| <= 128
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t two) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(two & 0xffu)),
                   static_cast<float>(static_cast<int8_t>((two >> 8) & 0xffu)));
}

// The bf16-q kernel (both pool types): the G query heads of a kv head are
// the rows of one m16 tile (rows >= G zero), so S = Q.K^T and O += P.V are
// mma.sync.m16n8k16 for all heads at once. Warp w takes tokens
// 16w..16w+15 of each 64-token stage and keeps its own (m, l, O) for the
// 16 rows; the CTA adds its warps' partials in warp order, then the
// cluster adds the splits' in split order.
// bf16 K/V fragments come by ldmatrix (V by ldmatrix.trans); int8 ones are
// read as byte pairs and widened to bf16 exactly. The K scale multiplies a
// token's score, the V scale its probability before P.V. Scores scale in
// fp32 after the product, so q enters the tensor cores as given.
template <typename KV, int D, bool QUANT>
__global__ void __launch_bounds__(kTcWarps * 32)
paged_decode_tc_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ pool,
                       const float* __restrict__ scales, const int* __restrict__ bt,
                       const int* __restrict__ cl, __nv_bfloat16* __restrict__ out, int H,
                       int Hkv, int MB, int P, long long s_row, long long layer_off,
                       long long s_side, long long s_tok, long long s_srow,
                       long long s_layer_off, float scale) {
  constexpr int ES = (int)sizeof(KV);
  constexpr int ROW = D * ES + 16;       // padded token row: conflict-free ldmatrix
  constexpr int CH = D * ES / 16;
  constexpr int STAGE = 2 * kTcTok * ROW;
  constexpr int NST = TcRing<KV>::kStages;
  constexpr int QROW = D * 2 + 16;
  constexpr int KS = D / 16, OT = D / 8;
  constexpr int VEC = 16 / ES;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* ring = tc_smem;                   // NST stages; partials after
  unsigned char* qt = tc_smem + NST * STAGE;       // 16 x D bf16 q rows
  float* Sc = reinterpret_cast<float*>(qt + 16 * QROW);   // NST x (K, V) x 64

  const __nv_bfloat16* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < 16 * (D / 8); i += kTcWarps * 32) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < G) v = *reinterpret_cast<const uint4*>(qb + r * D + c * 8);
    *reinterpret_cast<uint4*>(qt + r * QROW + c * 16) = v;
  }

  const int ctx = max(0, min(cl[b], MB * P));
  const Split sp = split_of(ctx, split);
  const int lo = sp.lo, hi = sp.hi;
  const int nstage = hi > lo ? (hi - lo + kTcTok - 1) / kTcTok : 0;
  const int* btb = bt + (long long)b * MB;
  const int pshift = __ffs(P) - 1;

  // thread tid always copies chunk tid % CH of side (tid / CH) % 2, for
  // tokens tid / (2 CH) + k * TSTEP; their block-table rows are read
  // together before any copy is issued
  constexpr int TSTEP = kTcWarps * 32 / (2 * CH), NIT = kTcTok / TSTEP;
  const int lc = tid % CH, lside = (tid / CH) & 1, lt = tid / (2 * CH);
  auto load = [&](int st, int slot) {
    unsigned char* buf = ring + slot * STAGE;
    const int t0 = lo + st * kTcTok;
    int row[NIT];
#pragma unroll
    for (int k = 0; k < NIT; ++k) {
      const int tok = t0 + lt + k * TSTEP;
      row[k] = tok < hi ? __ldg(btb + (tok >> pshift)) : -1;
    }
#pragma unroll
    for (int k = 0; k < NIT; ++k) {
      const int t = lt + k * TSTEP, tok = t0 + t;
      const KV* src = pool;
      if (row[k] >= 0)
        src = pool + (long long)row[k] * s_row + layer_off + lside * s_side +
              (long long)(tok & (P - 1)) * s_tok + (long long)kvh * D + lc * VEC;
      cp_async16(smem_u32(buf + (lside * kTcTok + t) * ROW + lc * 16), src, row[k] >= 0);
    }
    if constexpr (QUANT) {               // one (side, token) scale per thread
      const int side = tid / kTcTok, tok = t0 + tid % kTcTok;
      const bool ok = tok < hi;
      const float* src = scales;
      if (ok)
        src = scales + (long long)__ldg(btb + (tok >> pshift)) * s_srow + s_layer_off +
              side * Hkv + kvh;
      cp_async4(smem_u32(Sc + slot * 2 * kTcTok + tid), src, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < nstage) load(st, st);
    cp_async_commit();
  }
  __syncthreads();                       // q rows written
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(smem_u32(qt + (lane & 15) * QROW + (ks * 2 + (lane >> 4)) * 16), qa[ks][0],
                qa[ks][1], qa[ks][2], qa[ks][3]);

  float acc[OT][4];
#pragma unroll
  for (int d = 0; d < OT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows lane/4, +8
  const int wt = warp * 16;              // this warp's tokens in a stage
  const int tc = 2 * (lane & 3);         // its columns in an 8-token tile

  for (int st = 0; st < nstage; ++st) {
    const int nx = st + NST - 1;
    if (nx < nstage) load(nx, nx % NST);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();
    const int slot = st % NST;
    const unsigned char* kbuf = ring + slot * STAGE;
    const unsigned char* vbuf = kbuf + kTcTok * ROW;
    const float* ksc = Sc + slot * 2 * kTcTok;
    const int t0 = lo + st * kTcTok + wt;

    if (t0 < hi) {                       // a warp past the context idles
      // S = Q . K^T: 16 rows x 16 tokens (two 8-token tiles)
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b0, b1, b2, b3;
        if constexpr (ES == 2) {
          ldmatrix_x4(smem_u32(kbuf + (wt + ((lane >> 4) << 3) + (lane & 7)) * ROW +
                               (ks * 2 + ((lane >> 3) & 1)) * 16),
                      b0, b1, b2, b3);
        } else {
          const unsigned char* k0 = kbuf + (wt + (lane >> 2)) * ROW + ks * 16 + tc;
          const unsigned char* k1 = k0 + 8 * ROW;
          b0 = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(k0));
          b1 = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(k0 + 8));
          b2 = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(k1));
          b3 = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(k1 + 8));
        }
        mma_bf16(s[0], qa[ks], b0, b1);
        mma_bf16(s[1], qa[ks], b2, b3);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = n * 8 + tc + (e & 1);          // token within the warp's 16
          float x = s[n][e] * scale;
          if constexpr (QUANT) x *= ksc[wt + t];
          if (t0 + t >= hi) x = -INFINITY;
          s[n][e] = x;
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
        corr[r] = expf(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(s[n][e] - mu[e >> 1]);
          l[e >> 1] += p;
          if constexpr (QUANT) p *= ksc[kTcTok + wt + n * 8 + tc + (e & 1)];
          s[n][e] = p;
        }
      }
#pragma unroll
      for (int d = 0; d < OT; ++d) {
        acc[d][0] *= corr[0]; acc[d][1] *= corr[0];
        acc[d][2] *= corr[1]; acc[d][3] *= corr[1];
      }
      // O += P . V, P's accumulators as the A fragments
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int d = 0; d < OT; d += 2) {
        uint32_t b0, b1, b2, b3;
        if constexpr (ES == 2) {
          ldmatrix_x4_trans(smem_u32(vbuf + (wt + (((lane >> 3) & 1) << 3) + (lane & 7)) * ROW +
                                     (d + (lane >> 4)) * 16),
                            b0, b1, b2, b3);
        } else {
          const unsigned char* v0 = vbuf + (wt + tc) * ROW + d * 8 + (lane >> 2);
          auto pair = [&](const unsigned char* p) {
            return i8x2_bf16x2((uint32_t)p[0] | ((uint32_t)p[ROW] << 8));
          };
          b0 = pair(v0);
          b1 = pair(v0 + 8 * ROW);
          b2 = pair(v0 + 8);
          b3 = pair(v0 + 8 * ROW + 8);
        }
        mma_bf16(acc[d], pa, b0, b1);
        mma_bf16(acc[d + 1], pa, b2, b3);
      }
    }
    __syncthreads();                     // this slot may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring now holds the partials

  // warp partials: kTcWarps x (G x D acc, G m, G l), then the CTA's
  float* Pw = reinterpret_cast<float*>(ring) + warp * G * (D + 2);
  float* Part = reinterpret_cast<float*>(ring) + kTcWarps * G * (D + 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int g = (lane >> 2) + 8 * r;
    if (g < G) {
#pragma unroll
      for (int d = 0; d < OT; ++d) {
        Pw[g * D + d * 8 + tc] = acc[d][2 * r];
        Pw[g * D + d * 8 + tc + 1] = acc[d][2 * r + 1];
      }
      if ((lane & 3) == 0) {
        Pw[G * D + g] = m[r];
        Pw[G * D + G + g] = l[r];
      }
    }
  }
  __syncthreads();
  // the CTA's partial: its warps' in warp order, empty ones skipped
  const float* P0 = reinterpret_cast<const float*>(ring);
  for (int i = tid; i < G * D; i += kTcWarps * 32) {
    const int g = i / D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) M = fmaxf(M, P0[w * G * (D + 2) + G * D + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      const float* pw = P0 + w * G * (D + 2);
      const float mw = pw[G * D + g];
      if (mw == -INFINITY) continue;     // no token of this warp in the split
      const float wgt = expf(mw - M);
      num += wgt * pw[i];
      den += wgt * pw[G * D + G + g];
    }
    Part[i] = num;
    if (i % D == 0) {
      Part[G * D + g] = M;
      Part[G * D + G + g] = den;
    }
  }
  cluster.sync();                        // every split's partial is written
  cluster_combine(cluster, Part, G, D, sp.n,
                  out + ((long long)b * H + (long long)kvh * G) * D);
  cluster.sync();
}

struct Args {
  const void *q, *pool, *scales, *bt, *cl;
  void* out;
  int B, H, Hkv, MB, P;
  long long s_row, layer_off, s_side, s_tok, s_srow, s_layer_off;
  float scale;
  int cluster;
  cudaStream_t stream;
};

// One launch of ``kernel`` over (cluster, Hkv, B) with a cluster of
// a.cluster CTAs along x.
template <typename T, typename KV>
int launch_cluster(void (*kernel)(const T*, const KV*, const float*, const int*, const int*,
                                  T*, int, int, int, int, long long, long long, long long,
                                  long long, long long, long long, float),
                   const Args& a, int threads, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.Hkv, a.B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)a.q, (const KV*)a.pool, (const float*)a.scales,
      (const int*)a.bt, (const int*)a.cl, (T*)a.out, a.H, a.Hkv, a.MB, a.P, a.s_row,
      a.layer_off, a.s_side, a.s_tok, a.s_srow, a.s_layer_off, a.scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// bf16 q with at most 16 heads per kv head: the tensor cores; otherwise
// (fp32 q, held to 1e-5, or wider groups) the CUDA cores.
template <typename T, typename KV, int D, bool QUANT>
int launch(const Args& a) {
  const int G = a.H / a.Hkv;
  if constexpr (sizeof(T) == 2) {
    if (G <= 16) {
      constexpr int ES = (int)sizeof(KV);
      const size_t ring = (size_t)TcRing<KV>::kStages * 2 * kTcTok * (D * ES + 16);
      const size_t part = sizeof(float) * (kTcWarps + 1) * (size_t)G * (D + 2);
      const size_t smem = (ring > part ? ring : part) + 16 * (D * 2 + 16) +
                          (QUANT ? sizeof(float) * TcRing<KV>::kStages * 2 * kTcTok : 0);
      return launch_cluster<T, KV>(paged_decode_tc_kernel<KV, D, QUANT>, a, kTcWarps * 32,
                                   smem);
    }
  }
  using LY = Layout<KV, D>;
  const size_t smem = (size_t)Ring<KV>::kStages * LY::STAGE +
                      sizeof(float) * ((size_t)G * D + (size_t)G * (D + 2) +
                                       (QUANT ? (size_t)Ring<KV>::kStages * 2 * kTS : 0));
  return launch_cluster<T, KV>(paged_decode_kernel<T, KV, D, QUANT>, a, G * 32, smem);
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

int check_plan(int P, int cluster) {
  const bool ok = P > 0 && kTS % P == 0 && cluster >= 1 && cluster <= kMaxSplits &&
                  (cluster & (cluster - 1)) == 0;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out: (B, H, D); pool: block-first, element strides s_row (pool row),
// s_side (K -> V), s_tok (token in block), kv head stride D, layer_off the
// element offset of the selected layer inside a row (0 for a flat pool);
// bt: (B, MB) int32; cl: (B,) int32. dtype 0 = fp32, 1 = bf16 (q, pool and
// out alike). cluster: CTAs per (kv head, sequence), a power of two <= 8,
// at least the most splits (split_of) any context <= MB * P gets; P
// divides 32.
extern "C" int repro_paged_attention(const void* q, const void* pool, const void* bt,
                                     const void* cl, void* out, int dtype, int B, int H,
                                     int Hkv, int D, int MB, int P, long long s_row,
                                     long long layer_off, long long s_side, long long s_tok,
                                     float scale, int cluster, void* stream) {
  if (const int err = check_plan(P, cluster)) return err;
  const Args a{q,     pool, nullptr, bt,    cl,      out,     B,
               H,     Hkv,  MB,      P,     s_row,   layer_off, s_side,
               s_tok, 0,    0,       scale, cluster, (cudaStream_t)stream};
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
                                       long long s_layer_off, float scale, int cluster,
                                       void* stream) {
  if (const int err = check_plan(P, cluster)) return err;
  const Args a{q,     pool,   scales,      bt,    cl,      out,     B,
               H,     Hkv,    MB,          P,     s_row,   layer_off, s_side,
               s_tok, s_srow, s_layer_off, scale, cluster, (cudaStream_t)stream};
  if (dtype == 0) return dispatch_d<float, int8_t, true>(D, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, int8_t, true>(D, a);
  return (int)cudaErrorInvalidValue;
}
