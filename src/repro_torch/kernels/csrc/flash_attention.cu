// Causal online-softmax attention (FlashAttention) with GQA.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the TPU
// Pallas kernel _kernel).  q (B, Hq, Tq, Dqk), k (B, Hkv, Tk, Dqk), v
// (B, Hkv, Tk, Dv) with any strides over B, H, T and the head dim
// contiguous; out (B, Hq, Tq, Dv) contiguous in q's dtype.  A q head h
// reads kv head h / (Hq / Hkv): the shared kv rows are never repeated in
// memory.  Scores and sums are f32, with the reference's NEG_INF = −1e30
// running max start and max(l, 1e−30) denominator; query i sits at
// position q_offset + i and sees keys 0 … q_offset + i (all keys when not
// causal).  Two kernels, chosen by dtype:
//
//   * flash_attention_mma_kernel, bf16 q, k and v (every path through
//     generate: the caches are bf16).  FlashAttention-2 on the tensor
//     cores: mma.sync m16n8k16, bf16 operands, f32 sums.
//   * flash_attention_kernel, any f32 operand: the SIMT kernel below, f32
//     throughout (a bf16 product could not hold f32's tolerance).
//
// What bounds K2 on the H100 at the main paths' prefill shapes (Tq ≈ Tk ≈
// 200; D = 64 for Llama-3.2-1B, Dqk/Dv = 192/128 for DeepSeek-V2-Lite's
// MLA; the smoke configs' 16 and 24/16 are built too): neither the bytes
// nor the operations, but latency and load.
// Llama moves 7.2 MB of q/k/v/o (2.1 µs at 3.35 TB/s) and does 0.5 GFLOP
// (0.5 µs on the tensor cores); a block's few tiles leave the launch, the
// first tile's loads and the serial softmax between the two products as
// what fills its time.  At long prompts the operations bound it.
//
// The tensor-core kernel's design:
//   * A block of 4 warps owns 64 query rows of one (b, q head), 16 rows a
//     warp; Q is copied once to shared memory by 16-byte cp.async and
//     kept in registers as mma A fragments (ldmatrix).
//   * K and V come in tiles of 64 keys, bf16, double-buffered by
//     cp.async (the next tile's copy in flight while this one is used);
//     rows are padded by 16 bytes so ldmatrix has no bank conflicts, and
//     keys at or past Tk are zero-filled, so a masked p = 0 never meets a
//     garbage value.  Tiles past the block's last visible key are not
//     loaded (the causal block skip), and a warp whose rows see none of a
//     tile skips its products.
//   * S = Q·Kᵀ on the tensor cores, K's rows read as the B operand; the
//     scale folds log2(e) in so the softmax takes exp2; the mask is built
//     only on tiles that cross the diagonal or the tail.  The row max and
//     sum live in the quad of lanes that holds a row (two shuffles).
//   * O += P·V: P is split in registers into bf16 hi + lo (the m16n8
//     accumulator layout pairs into the m16n8k16 A layout, so it never
//     touches shared memory) and both go through the tensor cores against
//     V (ldmatrix.trans).  P rounded to bf16 alone (FlashAttention-2's
//     choice) passes every check, but at its edge: the output one bf16 ulp
//     off at |out| in [2, 4), 0.015625 against the 1.6e-2 tolerance, and
//     the 2-layer card-vs-CPU logits of both paths 0.046875 off against
//     5e-2 (0.03125 and 0.039 with hi + lo).  hi + lo keeps 16 bits of P,
//     so K2 errs as little as the f32 SIMT kernel (0.0039), for 13–17 %
//     more kernel time, 0.03 ms of a prefill (PERF.md).  O stays
//     f32 in registers (32 a thread at Dv = 64, 64 at 128) until the end,
//     which divides by max(l, 1e-30), rounds to bf16 and stores two values
//     at a time.
//   * One q head a block.  A block per GQA group, loading each K/V tile
//     once for the group's q heads, is the next step to measure.
//
// The SIMT kernel: one thread per query row (LANES threads for MLA's wide
// rows, see below) keeps q and the output accumulator in registers; a
// block of 64 rows stages key/value tiles in shared memory as f32 (every
// row reads the same key row: a broadcast).  Scores are taken 16 keys at a
// time, with the same causal block skip and ragged tails masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kSub = 16; // keys per online-softmax step
constexpr float kNegInf = -1e30f;

// Element i of a bf16 or f32 array.  The dtype is a runtime flag rather
// than a template parameter: loads sit outside the inner loops, and one
// instantiation per head-dim pair keeps the build short.
__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store(void* p, long long i, int bf16,
                                      float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// DQK: the q/k head dim; DV: the v (and output) head dim.  LANES threads
// share one query row: each keeps every LANES-th element of the row's q and
// output accumulator (element d = i · LANES + part), the score's partial
// dot products are summed across the row's lanes by shuffles, and each lane
// updates its own accumulator elements.  LANES = 1 keeps a whole row in one
// thread (head dims 64 and 128); MLA's 192 + 128 values per row would not
// fit in one thread's registers, so it takes LANES = 2 (96 + 64 per
// thread, 254 registers, no spills; at the DeepSeek-V2-Lite prefill 4%
// faster than LANES = 4 on an H100 80GB HBM3 at 700 W, PERF.md).
template <int DQK, int DV, int LANES>
__global__ void __launch_bounds__(kBQ * LANES)
flash_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                       const void* __restrict__ v, void* __restrict__ out,
                       int q_bf16, int kv_bf16, int Hq, int Hkv, int Tq,
                       int Tk, long long qsb,
                       long long qsh, long long qst, long long ksb,
                       long long ksh, long long kst, long long vsb,
                       long long vsh, long long vst, float sm_scale,
                       int causal, int q_offset) {
  // 32 KiB of f32 keys + values, in whole steps of kSub keys
  constexpr int BKV = 8192 / (DQK + DV) / kSub * kSub;
  constexpr int QPL = DQK / LANES, VPL = DV / LANES;
  static_assert(BKV >= kSub && QPL * LANES == DQK && VPL * LANES == DV,
                "head dims must split evenly over the lanes");
  __shared__ float ks[BKV][DQK];
  __shared__ float vs[BKV][DV];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int part = threadIdx.x % LANES;
  const int qi = q0 + threadIdx.x / LANES;
  const bool live = qi < Tq;
  const int qpos = q_offset + qi;
  // the lanes of one row: a group of LANES neighbours in the warp
  const unsigned gmask =
      (LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u))
      << ((threadIdx.x & 31) & ~(LANES - 1));
  // last key any row of this block may see
  const int last_key = causal ? min(Tk - 1, q_offset + min(q0 + kBQ, Tq) - 1)
                              : Tk - 1;

  float qr[QPL], acc[VPL];
  const long long qrow = b * qsb + h * qsh + (long long)(live ? qi : 0) * qst;
#pragma unroll
  for (int i = 0; i < QPL; ++i)
    qr[i] = live ? load(q, qrow + i * LANES + part, q_bf16) : 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const long long kbase = b * ksb + kvh * ksh;
  const long long vbase = b * vsb + kvh * vsh;
  for (int k0 = 0; k0 <= last_key; k0 += BKV) {
    const int nk = min(BKV, last_key + 1 - k0);
    for (int i = threadIdx.x; i < nk * DQK; i += kBQ * LANES) {
      int j = i / DQK, d = i - j * DQK;
      ks[j][d] = load(k, kbase + (long long)(k0 + j) * kst + d, kv_bf16);
      if (DQK == DV)
        vs[j][d] = load(v, vbase + (long long)(k0 + j) * vst + d, kv_bf16);
    }
    if (DQK != DV) {
      for (int i = threadIdx.x; i < nk * DV; i += kBQ * LANES) {
        int j = i / DV, d = i - j * DV;
        vs[j][d] = load(v, vbase + (long long)(k0 + j) * vst + d, kv_bf16);
      }
    }
    __syncthreads();
    // keys this row sees in the tile: [0, jmax)
    int jmax = nk;
    if (causal) jmax = min(jmax, qpos - k0 + 1);
    if (!live) jmax = 0;
    for (int j0 = 0; j0 < jmax; j0 += kSub) {
      float s[kSub];
      float mt = m;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        s[u] = kNegInf;
        if (j0 + u < jmax) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < QPL; ++i)
            dot = fmaf(qr[i], ks[j0 + u][i * LANES + part], dot);
#pragma unroll
          for (int o = 1; o < LANES; o <<= 1)
            dot += __shfl_xor_sync(gmask, dot, o);
          s[u] = dot * sm_scale;
          mt = fmaxf(mt, s[u]);
        }
      }
      float alpha = expf(m - mt);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        if (j0 + u < jmax) {
          float p = expf(s[u] - mt);
          l += p;
#pragma unroll
          for (int i = 0; i < VPL; ++i)
            acc[i] = fmaf(p, vs[j0 + u][i * LANES + part], acc[i]);
        }
      }
      m = mt;
    }
    __syncthreads();
  }
  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    const long long orow = ((long long)bh * Tq + qi) * DV;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      store(out, orow + i * LANES + part, q_bf16, acc[i] / denom);
  }
}

template <int DQK, int DV, int LANES>
int launch(const void* q, const void* k, const void* v, void* out, int q_bf16,
           int kv_bf16, int B, int Hq, int Hkv, int Tq, int Tk,
           const long long* qs, const long long* kstr, const long long* vstr,
           float sm_scale, int causal, int q_offset, cudaStream_t stream) {
  dim3 grid((Tq + kBQ - 1) / kBQ, B * Hq);
  flash_attention_kernel<DQK, DV, LANES><<<grid, kBQ * LANES, 0, stream>>>(
      q, k, v, out, q_bf16, kv_bf16, Hq, Hkv, Tq, Tk, qs[0], qs[1], qs[2],
      kstr[0], kstr[1], kstr[2], vstr[0], vstr[1], vstr[2], sm_scale, causal,
      q_offset);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 q, k, v).

using qmoe::cp_async16;
using qmoe::cp_async_commit;
using qmoe::cp_async_wait;
using qmoe::ldmatrix_x4;
using qmoe::ldmatrix_x4_trans;
using qmoe::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kTcKeys = 64;             // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// The q/k head dim as the tensor cores take it: whole k16 steps.  A DQK
// of 8s but not 16s (the smoke configs' MLA, 24) is staged with zero
// columns up to DQKP, which add nothing to Q·Kᵀ.
template <int DQK>
__host__ __device__ constexpr int tc_dqk() {
  return (DQK + 15) / 16 * 16;
}

// Shared memory of one block: Q (64 rows), then two stages of K and of V
// (64 keys each), every row padded by 8 bf16 (16 bytes).
template <int DQK, int DV>
constexpr size_t tc_smem_bytes() {
  return ((size_t)kTcRows * (tc_dqk<DQK>() + 8) +
          2 * (size_t)kTcKeys * (tc_dqk<DQK>() + 8) +
          2 * (size_t)kTcKeys * (DV + 8)) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p as two bf16 pairs hi + lo, hi = bf16(p) and lo = bf16(p − hi): 16
// significant bits, where bf16 alone keeps 8.
__device__ __forceinline__ void split_bf16x2(float p0, float p1,
                                             uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(p0, p1);
  lo = pack_bf16x2(p0 - __uint_as_float(hi << 16),
                   p1 - __uint_as_float(hi & 0xFFFF0000u));
}


// Fragment coordinates (mma.sync m16n8k16): lane = 4·g + t.  An m16n8
// accumulator holds rows g and g + 8, columns 2t and 2t + 1 of its tile;
// each thread keeps two query rows' running max, sum and output.
template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           int Hq, int Hkv, int Tq, int Tk, long long qsb,
                           long long qsh, long long qst, long long ksb,
                           long long ksh, long long kst, long long vsb,
                           long long vsh, long long vst, float scale_log2,
                           int causal, int q_offset) {
  constexpr int DQKP = tc_dqk<DQK>();
  constexpr int LDQ = DQKP + 8, LDV = DV + 8;  // bf16 per staged row
  constexpr int QCH = DQK / 8, VCH = DV / 8;   // 16-byte chunks copied a row
  constexpr int KS = DQKP / 16;                // k16 steps of Q·Kᵀ
  constexpr int NS = kTcKeys / 8;              // n8 tiles of S
  constexpr int NO = DV / 8;                   // n8 tiles of O
  static_assert(DQK % 8 == 0 && DV % 16 == 0, "Dqk of 8s, Dv of 16s");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTcRows * LDQ;               // 2 stages
  bf16* vs = ks + 2 * kTcKeys * LDQ;           // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, Tq - q0);
  // last key any row of this block sees, and the tiles up to it
  const int last_key =
      causal ? min(Tk - 1, q_offset + q0 + rows - 1) : Tk - 1;
  const int ntiles = (last_key + kTcKeys) / kTcKeys;

  const bf16* qg = q + b * qsb + h * qsh;
  const bf16* kg = k + b * ksb + kvh * ksh;
  const bf16* vg = v + b * vsb + kvh * vsh;

  if constexpr (DQKP > DQK) {
    // the columns DQK … DQKP of Q and of both K stages (rows laid out one
    // after another) are zero once: no copy writes them
    for (int r = tid; r < kTcRows + 2 * kTcKeys; r += kTcThreads)
#pragma unroll
      for (int c = DQK; c < DQKP; c += 8)
        *reinterpret_cast<uint4*>(qs + r * LDQ + c) = make_uint4(0, 0, 0, 0);
  }
  // Q rows past Tq and K/V rows past Tk read nothing and are zero
  for (int i = tid; i < kTcRows * QCH; i += kTcThreads) {
    const int r = i / QCH, c = (i - r * QCH) * 8;
    cp_async16(qs + r * LDQ + c, qg + (long long)min(q0 + r, Tq - 1) * qst + c,
               r < rows ? 16 : 0);
  }
  auto load_kv = [&](int tile) {
    const int k0 = tile * kTcKeys;
    bf16* kd = ks + (tile & 1) * kTcKeys * LDQ;
    bf16* vd = vs + (tile & 1) * kTcKeys * LDV;
    for (int i = tid; i < kTcKeys * QCH; i += kTcThreads) {
      const int r = i / QCH, c = (i - r * QCH) * 8;
      const int key = k0 + r;
      cp_async16(kd + r * LDQ + c, kg + (long long)min(key, Tk - 1) * kst + c,
                 key < Tk ? 16 : 0);
    }
    for (int i = tid; i < kTcKeys * VCH; i += kTcThreads) {
      const int r = i / VCH, c = (i - r * VCH) * 8;
      const int key = k0 + r;
      cp_async16(vd + r * LDV + c, vg + (long long)min(key, Tk - 1) * vst + c,
                 key < Tk ? 16 : 0);
    }
  };
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  const int wrow = warp * 16;                  // the warp's first row
  const bool warp_live = q0 + wrow < Tq;
  const int qi0 = q0 + wrow + g;               // rows qi0 and qi0 + 8
  // the last key any row of the warp sees
  const int warp_last_key =
      causal ? q_offset + min(q0 + wrow + 15, Tq - 1) : Tk - 1;

  uint32_t qa[KS][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();          // this tile (and Q) is in
    __syncthreads();
    if (tile == 0 && warp_live) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qa[kk], qs + (wrow + (lane & 15)) * LDQ + kk * 16 +
                                (lane >> 4) * 8);
    }
    const int k0 = tile * kTcKeys;
    const bool run = warp_live && k0 <= warp_last_key;
    const bf16* kt = ks + (tile & 1) * kTcKeys * LDQ;
    const bf16* vt = vs + (tile & 1) * kTcKeys * LDV;
    uint32_t ph[NS / 2][4], pl[NS / 2][4];   // P = hi + lo, A fragments
    if (run) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q·Kᵀ: ldmatrix x4 gives the B fragments of two n8 key tiles
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LDQ + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * p], qa[kk], bk[0], bk[1]);
          mma_bf16(s[2 * p + 1], qa[kk], bk[2], bk[3]);
        }
      }
      // scale (log2 units), then mask where a key is past Tk or, causally,
      // past the row's position — only on a tile that crosses either
      const bool edge = k0 + kTcKeys > Tk ||
                        (causal && k0 + kTcKeys - 1 > q_offset + q0 + wrow);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qpos = q_offset + qi0 + (e >> 1) * 8;
            if (key >= Tk || (causal && key > qpos)) x = kNegInf;
          }
          s[j][e] = x;
        }
      // online softmax: the new row max over the quad, the rescale
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
      // P = exp2(S − m): the f32 sums go to l, bf16 hi + lo pairs to the
      // A fragments of P·V (n8 tiles 2kk and 2kk + 1 make k16 step kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
        const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        const int kk = j >> 1, a = 2 * (j & 1);
        split_bf16x2(p0, p1, ph[kk][a], pl[kk][a]);
        split_bf16x2(p2, p3, ph[kk][a + 1], pl[kk][a + 1]);
      }
      // O += P·V: ldmatrix.trans x4 gives the B fragments of two n8 tiles
      // of V's columns
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * LDV +
                                    np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], ph[kk], bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], ph[kk], bv[2], bv[3]);
          mma_bf16(o[2 * np], pl[kk], bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pl[kk], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();             // every warp is done with this stage
  }
  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = qi0 + 8 * r;
    if (qi >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((long long)bh * Tq + qi) * DV + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int DQK, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int Tq, int Tk, const long long* qs,
               const long long* kstr, const long long* vstr, float sm_scale,
               int causal, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DQK, DV>();
  auto kern = &flash_attention_mma_kernel<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kTcRows - 1) / kTcRows, B * Hq);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Hq, Hkv, Tq, Tk,
      qs[0], qs[1], qs[2], kstr[0], kstr[1], kstr[2], vstr[0], vstr[1],
      vstr[2], sm_scale * kLog2e, causal, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes.  Each returns the CUDA error code (0 =
// ok).  Strides are in elements, (batch, head, time) for each of q, k, v.
// Head dims (Dqk, Dv): (64, 64), (128, 128) and MLA's (192, 128), and the
// smoke configs' (16, 16) and MLA (24, 16).
//
// qmoe_flash_attention_mma: bf16 q, k, v and out; every base pointer and
// stride a multiple of 8 elements (16 bytes, for cp.async).
extern "C" int qmoe_flash_attention_mma(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int Tq, int Tk, int Dqk, int Dv, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, float sm_scale, int causal,
    int q_offset, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // This library links its own CUDA runtime: select the tensors' device.
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long qs[3] = {qsb, qsh, qst};
  const long long kstr[3] = {ksb, ksh, kst};
  const long long vstr[3] = {vsb, vsh, vst};
#define QMOE_ARGS q, k, v, out, B, Hq, Hkv, Tq, Tk, qs, kstr, vstr, \
                  sm_scale, causal, q_offset, s
  if (Dqk == 64 && Dv == 64) return launch_mma<64, 64>(QMOE_ARGS);
  if (Dqk == 128 && Dv == 128) return launch_mma<128, 128>(QMOE_ARGS);
  if (Dqk == 192 && Dv == 128) return launch_mma<192, 128>(QMOE_ARGS);
  if (Dqk == 16 && Dv == 16) return launch_mma<16, 16>(QMOE_ARGS);
  if (Dqk == 24 && Dv == 16) return launch_mma<24, 16>(QMOE_ARGS);
#undef QMOE_ARGS
  return (int)cudaErrorInvalidValue;
}

// qmoe_flash_attention_simt: the SIMT kernel; q and k/v each bf16 or f32
// (q_bf16, kv_bf16), out in q's dtype.
extern "C" int qmoe_flash_attention_simt(
    const void* q, const void* k, const void* v, void* out, int q_bf16,
    int kv_bf16, int B, int Hq, int Hkv, int Tq, int Tk, int Dqk, int Dv,
    long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, float sm_scale, int causal, int q_offset, int device,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long qs[3] = {qsb, qsh, qst};
  const long long kstr[3] = {ksb, ksh, kst};
  const long long vstr[3] = {vsb, vsh, vst};
#define QMOE_ARGS q, k, v, out, q_bf16, kv_bf16, B, Hq, Hkv, Tq, Tk, qs, \
                  kstr, vstr, sm_scale, causal, q_offset, s
  if (Dqk == 64 && Dv == 64) return launch<64, 64, 1>(QMOE_ARGS);
  if (Dqk == 128 && Dv == 128) return launch<128, 128, 1>(QMOE_ARGS);
  if (Dqk == 192 && Dv == 128) return launch<192, 128, 2>(QMOE_ARGS);
  if (Dqk == 16 && Dv == 16) return launch<16, 16, 1>(QMOE_ARGS);
  if (Dqk == 24 && Dv == 16) return launch<24, 16, 1>(QMOE_ARGS);
#undef QMOE_ARGS
  return (int)cudaErrorInvalidValue;
}
