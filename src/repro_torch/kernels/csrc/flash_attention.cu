// Causal online-softmax attention (FlashAttention) with GQA.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the TPU
// Pallas kernel _kernel).  q (B, Hq, Tq, Dqk), k (B, Hkv, Tk, Dqk), v
// (B, Hkv, Tk, Dv) with any strides over B, H, T and the head dim
// contiguous; out (B, Hq, Tq, Dv) contiguous.  A q head h reads kv head
// h / (Hq / Hkv): the shared kv rows are never repeated in memory.  Scores
// and sums are f32, with the reference's NEG_INF = −1e30 running max start
// and max(l, 1e−30) denominator; query i sits at position q_offset + i and
// sees keys 0 … q_offset + i (all keys when not causal).  Two kernels, both
// on the tensor cores (mma.sync), chosen by dtype:
//
//   * flash_attention_mma_kernel, bf16 q, k and v (every path through
//     generate: the caches are bf16): m16n8k16, bf16 operands, f32 sums.
//   * flash_attention_tf32x3_kernel, f32 q, k and v (every training
//     forward; the wrapper upcasts a bf16 operand beside an f32 one, which
//     is exact): m16n8k8 on TF32 operands, three products per product.
//
// What bounds K2 on the H100 at the serving paths' prefill shapes (Tq ≈ Tk
// ≈ 200; D = 64 for Llama-3.2-1B, Dqk/Dv = 192/128 for DeepSeek-V2-Lite's
// MLA; the smoke configs' 16 and 24/16 are built too): neither the bytes
// nor the operations, but latency and load.
// Llama moves 7.2 MB of q/k/v/o (2.1 µs at 3.35 TB/s) and does 0.5 GFLOP
// (0.5 µs on the tensor cores); a block's few tiles leave the launch, the
// first tile's loads and the serial softmax between the two products as
// what fills its time.  At long prompts the operations bound it.
//
// The bf16 kernel's design:
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
//     so K2 errs as little as f32 P would (0.0039), for 13–17 % more
//     kernel time, 0.03 ms of a prefill (PERF.md).  O stays f32 in
//     registers (32 a thread at Dv = 64, 64 at 128) until the end, which
//     divides by max(l, 1e-30), rounds to bf16 and stores two values at a
//     time.
//   * One q head a block.  A block per GQA group, loading each K/V tile
//     once for the group's q heads, is the next step to measure.
//
// The f32 kernel, at the training shapes (4 × 256 tokens, causal: Llama's
// 32/8 heads at D 64, MLA's 16 heads at 192/128).  Its work is 1.08 GFLOP
// at Llama's shape and 1.35 at MLA's: 0.016 / 0.020 ms at f32's 67
// TFLOP/s outside the tensor cores, which one thread a query row (the
// kernel this one replaced: one shared-memory load a fused multiply-add)
// did not come near (0.138 / 0.26 ms).  TF32 on the tensor cores runs at
// 495 TFLOP/s, but one TF32 pass keeps 10 of f32's 23 mantissa bits: the
// output errs by ~1e-3 on randn inputs, 10× K2's f32 tolerance (1e-4).
// So each operand x is split into hi = tf32(x) and lo = tf32(x − hi)
// (rounded as cvt.rna.tf32.f32 rounds), which together keep 21 bits, and
// each product is taken as hi·hi + hi·lo + lo·hi (lo·lo is below f32's
// roundoff): ~2e-6 on the same inputs, near f32 FMA's ~1e-6.  Three
// passes cost 3 × 1.08 GFLOP, 0.0065 ms at 495 TFLOP/s: Llama's shape stays
// bound by its operations (its 21 MB of q/k/v/o take 0.0063 ms), MLA's
// becomes bound by its 41.9 MB (0.0125 ms; 0.0082 for its operations).
// The design (0.035 ms at Llama's shape, 0.082 at MLA's on an H100 at
// 700 W: PERF.md):
//   * Blocks and warps as the bf16 kernel's: 4 warps, 64 query rows of one
//     (b, q head), the causal block skip, a warp skipping tiles its rows
//     cannot see; the last query blocks, which see the most keys, are
//     launched first.
//   * K and V come in f32 tiles by 16-byte cp.async, double-buffered, keys
//     at or past Tk zero-filled.  Fragments are read straight from shared
//     memory (ldmatrix moves 16-bit elements): the k index of an m16n8k8
//     step is permuted so that k = t, t + 4 (lane t of a quad) are the
//     columns 2t, 2t + 1 of the step — the sum over k does not care — so a
//     lane reads K's two values as one float2, and rows are padded to 8 mod
//     16 floats, which makes those reads conflict-free; V's B values (keys
//     2t and 2t + 1 of column g) are single floats, rows padded to 4 mod 8
//     floats.
//   * Q never goes through shared memory: each lane loads its A fragments
//     (f32, the same permutation) from device memory once, while tile 0
//     loads, and splits them each tile (split fragments would take twice
//     the registers).
//   * S = Q·Kᵀ: each k8 step splits its fragments and runs the three
//     products as three passes over the n8 key tiles (no product waits on
//     the one before it).
//   * The online softmax runs on the m16n8 accumulators as in the bf16
//     kernel.  P·V takes P from registers: with the same permutation, the
//     accumulator's columns 2t, 2t + 1 of n8 tile j are the A fragment's k
//     = t, t + 4 of k8 step j, if V's rows are read in that order (key
//     8j + 2t for k = t, 8j + 2t + 1 for k = t + 4).  P and V are split and
//     multiplied in three terms too; O stays f32 in registers until the
//     end divides it by max(l, 1e−30).
//   * MLA (192 + 128 floats a key): Q's 96 registers a lane and O's 64 fill
//     the 255 (about 1.3 KB spilled).  A 64-key stage of K and V is 85 KB,
//     so two stages allow one block an SM; kMlaKeys = 32 halves them and
//     fits two blocks (0.082 ms against 0.087 with 64 keys).  This shape
//     stays 1.3× SDPA's time; fewer registers a lane (Dv split across
//     warps) is its next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr float kNegInf = -1e30f;

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

// ---------------------------------------------------------------------------
// The three-term TF32 kernel (f32 q, k, v).

// Keys a K/V tile at MLA's (192, 128) (see the head comment), and the
// blocks an SM the D 64 kernel's registers are capped for (3: 168
// registers, spills, 15 % slower; PERF.md).
constexpr int kMlaKeys = 32;
constexpr int kMinBlocks64 = 2;

// Floats per staged row: K rows 8 mod 16 (a quad's float2 reads at rows
// g, columns 2t: conflict-free), V rows 4 mod 8 (single floats at rows 2t
// and 2t + 1, column g: conflict-free).  Both multiples of 4, so each row
// starts on 16 bytes for cp.async.
template <int D>
__host__ __device__ constexpr int f32_ld_k() {
  return D % 16 == 8 ? D : D + 8;
}
template <int D>
__host__ __device__ constexpr int f32_ld_v() {
  return D % 8 == 4 ? D : D + 4;
}

// Shared memory of one block: two stages of K and of V (KT keys each), f32.
template <int DQK, int DV, int KT>
constexpr size_t f32_smem_bytes() {
  return 2 * (size_t)KT * (f32_ld_k<DQK>() + f32_ld_v<DV>()) * sizeof(float);
}

// x as TF32, the low 13 bits zero, rounded as cvt.rna.tf32.f32 rounds
// (to nearest, ties away from zero): half the dropped range added to the
// sign-magnitude bits, which carries into the exponent where it must.  The
// same bits for every finite x in two integer instructions; with the cvt
// instruction itself the kernel was 25 % slower at D 64 (PERF.md).  A NaN
// x still gives a NaN output: its lo = x − hi is NaN.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 · |x|: hi = tf32(x), lo = tf32(x − hi) (the
// difference is exact in f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a · b for one m16n8k8 tile, TF32 in, f32 sums.  Lane 4·g + t holds
// a = (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b = (k t, col
// g), (t + 4, g); d as in m16n8k16.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[first + n] += a·b_n as hi·hi + hi·lo + lo·hi for n < N, in three
// passes (the small terms first; no product waits on the one before it).
template <int N, int M>
__device__ __forceinline__ void mma_tf32x3(float (&d)[M][4], int first,
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[first + n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[first + n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[first + n], ah, bh[n]);
}

// DQK, DV: head dims; KT: keys a K/V tile; MINB: blocks an SM to fit
// (caps the registers a thread at 65536 / (128 · MINB)).
template <int DQK, int DV, int KT, int MINB>
__global__ void __launch_bounds__(kTcThreads, MINB)
flash_attention_tf32x3_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ out, int Hq, int Hkv,
                              int Tq, int Tk, long long qsb, long long qsh,
                              long long qst, long long ksb, long long ksh,
                              long long kst, long long vsb, long long vsh,
                              long long vst, float scale_log2, int causal,
                              int q_offset) {
  constexpr int LDK = f32_ld_k<DQK>(), LDV = f32_ld_v<DV>();
  constexpr int KCH = DQK / 4, VCH = DV / 4;  // 16-byte chunks a row
  constexpr int KS = DQK / 8;                 // k8 steps of Q·Kᵀ
  constexpr int NS = KT / 8;                  // n8 tiles of S (k8 of P·V)
  constexpr int NO = DV / 8;                  // n8 tiles of O
  // O tiles split at a time: 8 at Dv ≤ 64, 4 at 128 (fewer registers
  // beside O's 64 and Q's 96 at MLA's dims)
  constexpr int NC = NO <= 8 ? NO : 4;
  static_assert(DQK % 8 == 0 && DV % 8 == 0 && KT % 8 == 0 && NO % NC == 0,
                "head dims and keys of 8s");
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // 2 stages
  float* vs = ks + 2 * KT * LDK;               // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // blockIdx.x: (b, q head); the last query blocks, which see the most
  // keys, are launched first
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  const int rows = min(kTcRows, Tq - q0);
  const int last_key =
      causal ? min(Tk - 1, q_offset + q0 + rows - 1) : Tk - 1;
  const int ntiles = (last_key + KT) / KT;

  const float* kg = k + b * ksb + kvh * ksh;
  const float* vg = v + b * vsb + kvh * vsh;
  // K/V rows past Tk read nothing and are zero
  auto load_kv = [&](int tile) {
    const int k0 = tile * KT;
    float* kd = ks + (tile & 1) * KT * LDK;
    float* vd = vs + (tile & 1) * KT * LDV;
    for (int i = tid; i < KT * KCH; i += kTcThreads) {
      const int r = i / KCH, c = (i - r * KCH) * 4;
      const int key = k0 + r;
      cp_async16(kd + r * LDK + c, kg + (long long)min(key, Tk - 1) * kst + c,
                 key < Tk ? 16 : 0);
    }
    for (int i = tid; i < KT * VCH; i += kTcThreads) {
      const int r = i / VCH, c = (i - r * VCH) * 4;
      const int key = k0 + r;
      cp_async16(vd + r * LDV + c, vg + (long long)min(key, Tk - 1) * vst + c,
                 key < Tk ? 16 : 0);
    }
  };
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  const int wrow = warp * 16;                 // the warp's first row
  const bool warp_live = q0 + wrow < Tq;
  const int qi0 = q0 + wrow + g;              // rows qi0 and qi0 + 8
  const int warp_last_key =
      causal ? q_offset + min(q0 + wrow + 15, Tq - 1) : Tk - 1;

  // Q's A fragments, f32, straight from device memory while tile 0 loads:
  // k8 step kk's k = t, t + 4 are columns 8kk + 2t, + 1 (rows past Tq: 0)
  float qa[KS][4];
  {
    const float* qg = q + b * qsb + h * qsh + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qi0 + 8 * r;
      const float* row = qg + (long long)min(qi, Tq - 1) * qst;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float2 x = make_float2(0.f, 0.f);
        if (qi < Tq) x = *reinterpret_cast<const float2*>(row + 8 * kk);
        qa[kk][r] = x.x;
        qa[kk][r + 2] = x.y;
      }
    }
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();          // this tile is in
    __syncthreads();
    const int k0 = tile * KT;
    const bool run = warp_live && k0 <= warp_last_key;
    const float* kt = ks + (tile & 1) * KT * LDK;
    const float* vt = vs + (tile & 1) * KT * LDV;
    if (run) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q·Kᵀ: key 8j + g's columns 8kk + 2t, + 1 as the B fragment
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4], kh[NS][2], kl[NS][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(qa[kk][e], ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              kt + (8 * j + g) * LDK + 8 * kk + 2 * t4);
          split_tf32(kv.x, kh[j][0], kl[j][0]);
          split_tf32(kv.y, kh[j][1], kl[j][1]);
        }
        mma_tf32x3(s, 0, ah, al, kh, kl);
      }
      // scale (log2 units), then mask where a key is past Tk or, causally,
      // past the row's position — only on a tile that crosses either
      const bool edge = k0 + KT > Tk ||
                        (causal && k0 + KT - 1 > q_offset + q0 + wrow);
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
      // O += P·V, k8 step j = S's n8 tile j: A = (p0, p2, p1, p3), keys
      // 8j + 2t (k = t) and 8j + 2t + 1 (k = t + 4); V's rows in that order
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
        const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        uint32_t ph[4], pl[4];
        split_tf32(p0, ph[0], pl[0]);
        split_tf32(p2, ph[1], pl[1]);
        split_tf32(p1, ph[2], pl[2]);
        split_tf32(p3, ph[3], pl[3]);
        const float* v0 = vt + (8 * j + 2 * t4) * LDV + g;
#pragma unroll
        for (int c = 0; c < NO; c += NC) {
          uint32_t vh[NC][2], vl[NC][2];
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            split_tf32(v0[8 * (c + n)], vh[n][0], vl[n][0]);
            split_tf32(v0[LDV + 8 * (c + n)], vh[n][1], vl[n][1]);
          }
          mma_tf32x3(o, c, ph, pl, vh, vl);
        }
      }
    }
    __syncthreads();             // every warp is done with this stage
  }
  cp_async_wait<0>();            // no copy outlives the block (Tk = 0)
  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = qi0 + 8 * r;
    if (qi >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = out + ((long long)bh * Tq + qi) * DV + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int DQK, int DV, int KT, int MINB>
int launch_tf32x3(const void* q, const void* k, const void* v, void* out,
                  int B, int Hq, int Hkv, int Tq, int Tk, const long long* qs,
                  const long long* kstr, const long long* vstr,
                  float sm_scale, int causal, int q_offset,
                  cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<DQK, DV, KT>();
  auto kern = &flash_attention_tf32x3_kernel<DQK, DV, KT, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (Tq + kTcRows - 1) / kTcRows);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hkv, Tq,
      Tk, qs[0], qs[1], qs[2], kstr[0], kstr[1], kstr[2], vstr[0], vstr[1],
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

// qmoe_flash_attention_tf32x3: f32 q, k, v and out; every base pointer and
// stride a multiple of 4 elements (16 bytes, for cp.async).
extern "C" int qmoe_flash_attention_tf32x3(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int Tq, int Tk, int Dqk, int Dv, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, float sm_scale, int causal,
    int q_offset, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long qs[3] = {qsb, qsh, qst};
  const long long kstr[3] = {ksb, ksh, kst};
  const long long vstr[3] = {vsb, vsh, vst};
#define QMOE_ARGS q, k, v, out, B, Hq, Hkv, Tq, Tk, qs, kstr, vstr, \
                  sm_scale, causal, q_offset, s
  if (Dqk == 64 && Dv == 64)
    return launch_tf32x3<64, 64, 64, kMinBlocks64>(QMOE_ARGS);
  if (Dqk == 128 && Dv == 128)
    return launch_tf32x3<128, 128, 32, 2>(QMOE_ARGS);
  if (Dqk == 192 && Dv == 128)
    return launch_tf32x3<192, 128, kMlaKeys, 2>(QMOE_ARGS);
  if (Dqk == 16 && Dv == 16)
    return launch_tf32x3<16, 16, 64, 2>(QMOE_ARGS);
  if (Dqk == 24 && Dv == 16)
    return launch_tf32x3<24, 16, 64, 2>(QMOE_ARGS);
#undef QMOE_ARGS
  return (int)cudaErrorInvalidValue;
}
