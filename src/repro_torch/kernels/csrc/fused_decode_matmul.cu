// Fused decode -> dequant -> matmul over tile-major compressed planes.
//
// Replaces two TPU Pallas kernels of repro/kernels/fused_decode_matmul.py:
//   * K1 fused_decode_matmul (_kernel, _decode_tile, _accumulate), with its
//     column groups: planes (G, nb, slots) of a TiledPackedLinear, group g
//     the tile-major planes of the (N, K/G) sub-weight over x columns
//     [g·K/G, (g+1)·K/G).  A block walks the K tiles of all G groups in
//     order into one accumulator and applies the affine epilogue once, as
//     the TPU grid (M/bm, N/tile_n, G, K/(G·tile_k)) does; each K tile
//     finds its own compressed block (tile_block), so a warp's tiles, a
//     split or a decoded span may cross a group boundary.  G = 1 is the
//     untiled PackedLinear;
//   * K3 grouped_fused_decode_matmul (_grouped_kernel): the same product for
//     every expert of a stacked MoE weight in one launch.  The device code
//     is K1's; a block finds its expert from its index (gridDim.z =
//     expert · splits + split, or the decode kernel's row group) and
//     offsets x, planes, scale/zero and output by per-expert strides (the
//     LUT is shared).
//
// Three kernels, picked by the wrapper's plan (launch_plan): the decode
// kernel at M ≤ 16 (tile_k ≥ 4: one warp per compressed block, 1 or 4
// row groups of 4 rows, below), the tensor-core kernel above 16 rows (any
// tile_k ≥ 4), and the SIMT kernel only for tiles 1 or 2 weights wide (K
// odd or 2 mod 4) or compressed blocks past the decode kernel's limits:
// no model the port serves has either.
//
//   y[m, n] = s[n] · (Σ_k bf16(x[m, k]) · q[n, k] − z[n] · Σ_k bf16(x[m, k]))
//
// with q decoded in shared memory from the blocks of each (tile_n, tile_k)
// weight tile: a LUT row for codes != ESCAPE, and for escapes the literal
// row rank = (escapes before it in the block), clipped to [0, cap − 1] as
// _decode_tile clips it.  The decoded weight never reaches device memory.
//
// What bounds it on the H100:
//   * At decode (M = batch or engine slots, 1–16) it reads the compressed
//     planes once — 2 bytes of code per 4 weights plus the literal rows —
//     against 2·M operations a weight, far below the ridge, so the bound is
//     memory bytes (the decode kernel's note below says how it answers
//     that; at 5–16 rows also the x each block stages, below).
//   * At prefill (M = 4 prompts × up to 200 tokens) the bound is the
//     operations: 2·M·N·K on the tensor cores, about 0.024 ms for
//     8192 × 2048 at M = 700 against 0.008 ms for its planes' bytes.  What
//     fills the time is the decode and the product's 64-column steps:
//     their x copies, barriers and row sums, more than the tensor cores'
//     own rate (PERF.md).  A kernel that decodes each tile again for every
//     128-row band of M pays the decode ⌈M/128⌉ times (6 at M = 700).
// Design:
//   * SIMT and prefill kernels: blocks own 128 output columns.  The SIMT
//     kernel holds BM = 4 or 16 rows and the product runs on the SIMT
//     cores; at prefill-sized M the product runs on the tensor cores
//     (mma.sync, bf16 in, f32 sums) and a block walks a group of 128-row
//     bands over each span of K tiles it decoded, so a tile is decoded
//     once per band group (the wrapper's plan: at least two bands per
//     group, one group per launch where the grid still fills the card).
//     Tiles narrower than the 64-column K step sit side by side in the
//     span; the plan cuts K into splits of whole steps, so only a split's
//     last span may end inside one, padded with q = 0 and x = 0.  (The
//     SIMT kernel it replaces there, at tile_k 32, took 5.5 ms for 2048 ×
//     10944 at M = 700 against 0.38: a decode → barrier → stage → barrier
//     → product chain every 32 columns, the product on the CUDA cores.)
//   * The TPU grid carries its accumulator across K steps; blocks here run
//     in no order, so a block loops over its K tiles itself.  In the SIMT
//     and prefill kernels, to put more blocks on the card — and at
//     prefill, to give a block with several
//     bands a span that fits in shared memory — K tiles are split over
//     gridDim.z and a second kernel sums the splits in a fixed order before
//     the epilogue (no atomics: deterministic, exact for integer-valued
//     inputs).
//   * The LUT (up to 65 536 rows × 4 B = 256 KiB) does not fit in shared
//     memory, so rows are read through the read-only cache (__ldg); it
//     stays in the 50 MB L2.
//   * The escape rank is a prefix count within a compressed block: one
//     warp per block, each lane a contiguous run of slots, a shuffle scan
//     across lanes — no block-wide barrier inside the decode.
//   * The decode loop is kept short per slot: codes are read 16 bytes at a
//     time, a slot's place in the tile is a shift and a mask (tile_k is a
//     power of two), and eight gram loads per lane are in flight before
//     their stores.  The packer gives tile_k 1 or 2 to some K (odd, or
//     2 mod 4): a gram then spans rows and is stored weight by weight, and
//     the SIMT kernel stages 4 columns, the ones past tile_k zero in x.
#include "matmul_common.cuh"
#include "mma_sm80.cuh"

namespace {

using qmoe::cp_async16;
using qmoe::cp_async_commit;
using qmoe::cp_async_wait;
using qmoe::decode_block;
using qmoe::ldmatrix_x4;
using qmoe::mma_bf16;

// Per-expert operands of a grouped launch: blockIdx.z = expert · splits +
// split.  Each expert's x (M × K), planes, scale/zero (N), output (M × N)
// and split-K workspaces lie one after another; the LUT is shared.  All
// offsets are taken in 64 bits, as a stack's planes may pass 2^31 bytes.
// K1 is the case E = 1, and its kernels are instantiated with kGrouped
// false: no expert index, no offsets.
struct Expert {
  long long codes, lits;   // elements (uint16 codes, uint32 grams) per expert
  int splits;
};

template <typename TOut>
__device__ __forceinline__ void to_expert(
    int e, const Expert& ex, int M, int N, int K,
    const __nv_bfloat16* __restrict__& x, const uint16_t* __restrict__& codes,
    const uint32_t* __restrict__& lits, const float* __restrict__& scale,
    const float* __restrict__& zero, TOut* __restrict__& out,
    float* __restrict__& part, float* __restrict__& sxpart) {
  x += (long long)e * M * K;
  codes += e * ex.codes;
  lits += e * ex.lits;
  scale += (long long)e * N;
  zero += (long long)e * N;
  out += (long long)e * M * N;
  if (part != nullptr) {
    part += (long long)e * ex.splits * M * N;
    sxpart += (long long)e * ex.splits * M;
  }
}

// The first compressed block, bb = 0, of weight tile (j, kt) — kt counts the
// K tiles of the whole K — with every later block of the tile at + bb.  K
// tile kt lies in column group g = kt / nkt_g, whose tile-major planes
// follow those of the groups before it (nnt · nkt_g · bpt blocks each); its
// x columns start at kt · tile_k in every group.  At one group (nkt_g =
// K / tile_k) this is (j · nkt + kt) · bpt.
__device__ __forceinline__ long long tile_block(int j, int kt, int nnt,
                                                int nkt_g, int bpt) {
  const int g = kt / nkt_g;
  return (((long long)g * nnt + j) * nkt_g + (kt - g * nkt_g)) * bpt;
}

// ---------------------------------------------------------------------------
// Decode batch (M ≤ 4): one warp per compressed block, decoded into
// registers, all of K reduced inside the launch.
//
// What bounds it: bytes.  Every weight is read once as 2 bytes of code per
// 4 weights plus a 4-byte literal row per escaped gram (with random
// weights nearly every gram escapes: 1.5 bytes a weight), against 4·M
// multiply-adds per weight.  Streaming at 3.35 TB/s needs ~25 KB in
// flight on each SM (3.35 TB/s × ~1 µs of latency / 132 SMs), no barrier
// inside the stream, and no second pass over device memory.
// The SIMT kernel it replaces at M ≤ 4 (PERF.md) lost to four things; the
// design's answer to each:
//   1. A per-call floor: one 128-column stripe per block, K split only at
//      tile granularity (16 blocks for 512 × 2048), and a serial decode →
//      barrier → stage x → barrier → dot chain per K tile.  Here a CUDA
//      block owns one row group — compressed-block position bb of tile row
//      j (of expert e for K3): rpb = 4·slots / tile_k output columns — over
//      every K tile, and warp w takes K tiles w, w + W, ... (W from the
//      wrapper's plan: a power of two that keeps the grid within one wave
//      of 16 warps a SM, at most min(K tiles, 16)).  A warp decodes its
//      tile's block straight into registers and multiplies it against x
//      with no block-wide barrier until the epilogue: 64 blocks of 4 warps
//      for 512 × 2048, 1024 of 2 for 8192 × 2048, 11 264 of 1 for a 64 ×
//      1408 × 2048 expert stack (one warp walks all of K).
//   2. A second launch: the split-K workspace and splitk_epilogue.  Here
//      the warps' partial sums meet in shared memory and are added in
//      (warp, column group) order before qmoe::affine and the store: no
//      workspace, no atomics, no second kernel, and two calls give the
//      same bits.
//   3. The literal stream gathered lane-strided.  Here a step is 256
//      consecutive slots: lane L reads slots 8L .. 8L + 7 as one 16-byte
//      load (neighbouring lanes on neighbouring slots), counts its escapes,
//      and a shuffle scan over the warp gives each lane its first literal
//      rank, the step's total carried to the next step; the escaped rows
//      of a step are one contiguous run.  All of a block's (≤ 4) steps'
//      codes, then all 32 gram loads a lane, are issued before the first
//      product: ~6 KB in flight per warp, 16 warps per SM (128
//      registers a thread).
//   4. x staged as f32 by scalar loads, and the row sums a pass of their
//      own.  Here a warp copies its tile's x (4 rows × tile_k bf16) into
//      shared memory by cp.async before it reads its codes, so the copy
//      hides behind the decode, and Σx comes from the same mma as the
//      product (against ones).
// The product (tile_k ≥ 32) runs on the tensor cores although M ≤ 4: the
// SIMT version of this kernel spent its issue slots on 4 FMA and 2
// conversions per weight and measured slower (PERF.md).  With mma.sync
// m16n8k16 each lane's gram is its own B fragment (K order permuted), the
// A rows carry x at the columns of one lane group each, and the cross
// terms between groups are dropped (below).  tile_k 4, 8 or 16: a lane
// holds whole rows (tile_k / 4 grams each), multiplies them on the SIMT
// cores and adds each row's sum to shared memory as it completes.
//
// Rows 5–16 (an engine tick of 5–16 slots, generate at batch 5–16, K3 at
// capacities 5–16): the same kernel, instantiated for four row groups of
// 4 rows.  The bound is still bytes (2·16 operations a weight against
// ~1.5 bytes), so a block decodes each compressed block once, whatever M
// is, and runs every row group's product on the grams it holds.  The
// contract is the reference's row independence: a row's bits at any M
// from 1 to 16 are its bits at M = 1.  So each group of 4 rows runs
// exactly the M ≤ 4 arithmetic — the same block-diagonal mma with x in
// the same A rows, the same Σx mma, the same (warp, column block) order
// in the epilogue — and W, the warps a row group's K tiles are dealt to,
// is the plan's, a function of (E, N, tile_k, slots, SMs) and never of M.
// Registers: four groups' accumulators (4 × 20 f32 a lane) beside the 32
// grams do not fit the 128 registers a thread has at 16 warps a block, so
// this instantiation runs at most kDecRowWarps warps a block (255
// registers a thread), and a warp walks the K tiles of virtual warps
// warp, warp + 8, ... < W one after another, each into its own partial
// sums: the bits of W warps.  x: a block owns 4·slots / tile_k output
// columns (8 at tile_k 512) and reads all of x, 32·K bytes at 16 rows
// against ~1.5·8·K of planes, and every block of the launch reads the
// same x.  So a lane reads its A pieces straight from x through L1,
// 16 bytes (two mma steps) a load, where the SM's other blocks find them:
// staging 16 rows in shared memory, as at M ≤ 4, was 9–14 % slower
// (shared memory taken from L1), and staging them past L1 40–70 %
// (PERF.md).
constexpr int kDecM = 4;          // rows of x in a row group
constexpr int kDecRG = 4;         // row groups of the wide instantiation
constexpr int kDecSteps = 4;      // 256-slot steps: blocks of ≤ 1024 slots
constexpr int kDecMaxWarps = 16;  // warps per CUDA block (K tiles at once)
constexpr int kDecRowWarps = 8;   // warps per CUDA block at 5–16 rows

using qmoe::bf16x2_of;   // the weight-byte conversions (matmul_common.cuh)
using qmoe::gram_byte;

// The four bf16 of v (two packed pairs) as f32.
__device__ __forceinline__ void bf16x4_to_float(uint2 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xFFFF0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

// One warp decodes one compressed block (slots ≤ 256·kSteps) into
// g[step][u]: the gram of slot step·256 + 8·lane + u, 0 past the block.
// A LUT row for codes != ESCAPE, and for an escape the literal row
// rank = escapes before it in the block, clipped to [0, cap − 1] as
// _decode_tile clips it.  kVec: slots is a multiple of 8, so codes are
// read 16 bytes a lane and a lane's 8 slots are all in the block or all
// past it.  All 32 lanes must call it together.
template <bool kVec, int kSteps>
__device__ __forceinline__ void decode_grams(
    const uint16_t* __restrict__ codes, const uint32_t* __restrict__ lits,
    const uint32_t* __restrict__ lut, int slots, int cap, int lane,
    uint32_t (&g)[kSteps][8]) {
  uint32_t w[kSteps][4];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int s0 = st * 256 + lane * 8;
    w[st][0] = w[st][1] = w[st][2] = w[st][3] = 0u;
    if (kVec) {
      if (s0 < slots) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + s0));
        w[st][0] = v.x, w[st][1] = v.y, w[st][2] = v.z, w[st][3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < slots)
          w[st][u >> 1] |= (uint32_t)__ldg(codes + s0 + u) << (16 * (u & 1));
    }
  }
  // a literal row as an offset from the LUT, so that one 64-bit add
  // addresses either plane
  const long long dlit = lits - lut;
  int base = 0;   // escapes in the block before this step
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int s0 = st * 256 + lane * 8;
    const int nval = min(max(slots - s0, 0), 8);
    uint32_t c[8], esc = 0u;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      c[u] = (u & 1) ? w[st][u >> 1] >> 16 : w[st][u >> 1] & 0xFFFFu;
      esc |= (uint32_t)(c[u] == qmoe::kEscape) << u;
    }
    esc &= (1u << nval) - 1u;
    const int cnt = __popc(esc);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int rank = base + incl - cnt;
    base += __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int u = 0; u < 8; ++u) g[st][u] = 0u;
    if (nval > 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (kVec || u < nval) {
          const bool e = (esc >> u) & 1u;
          const long long idx = e ? dlit + min(rank, cap - 1) : c[u];
          rank += e;
          g[st][u] = __ldg(lut + idx);
        }
      }
    }
  }
}

// A warp's copy of x for one K tile (wide kernel, M ≤ 4): kDecM rows ×
// tile_k columns in 8-byte pieces of 4 columns, piece (m, u, l) holding
// columns 32·l + 4·u .. + 3 of row m at (m·8 + u)·16 + l, so that the
// lanes of a product step (lane l of each row reading piece (m, u, l))
// hit neighbouring words at offsets known to the compiler.  Rows past M
// read row M − 1.  Copied by cp.async, issued before the block's codes
// are read so that its latency hides behind theirs.
constexpr int kXsPieces = kDecM * 8 * 16;   // uint2 per warp
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        int M, int K, int k0, int tile_k,
                                        int lane, uint2* __restrict__ xs) {
  // lane copies pieces kc = lane + 32i of each row: (u, l) = (lane % 8,
  // lane / 8 + 4i)
  const int n = max((tile_k / 4 - lane + 31) >> 5, 0);
  const unsigned d0 = (unsigned)__cvta_generic_to_shared(
      xs + (lane & 7) * 16 + (lane >> 3));
#pragma unroll
  for (int m = 0; m < kDecM; ++m) {
    const __nv_bfloat16* src = x + (long long)min(m, M - 1) * K + k0 + 4 * lane;
    unsigned dst = d0 + m * 8 * 16 * 8;
    for (int i = 0; i < n; ++i, src += 128, dst += 4 * 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                   "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// kWide: tile_k ≥ 32 (so slots is a multiple of 8), product on the tensor
// cores; else tile_k 4, 8, 16, product on the SIMT cores.  kRG: row groups
// of 4 rows (1: M ≤ 4; kDecRG: M 5–16).  W: the plan's warps, over which
// the K tiles are dealt (tile kt to warp kt mod W); a block of P = W warps
// (kRG = 1) or min(W, kDecRowWarps) runs them, warp p those of p, p + P...
template <typename TOut, bool kGrouped, bool kWide, int kRG>
__global__ void __launch_bounds__(kRG == 1 ? kDecMaxWarps * 32
                                           : kDecRowWarps * 32)
fused_decode_matmul_decode_kernel(const __nv_bfloat16* __restrict__ x,
                                  const uint16_t* __restrict__ codes,
                                  const uint32_t* __restrict__ lits,
                                  const uint32_t* __restrict__ lut,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ zero,
                                  TOut* __restrict__ out, int M, int N,
                                  int K, int tile_n, int tile_k, int slots,
                                  int cap, int bpt, int nkt_g, int W,
                                  Expert ex) {
  constexpr int kM = kDecM * kRG;           // rows of x a block holds
  extern __shared__ float dsm[];
  const int P = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tk_shift = __ffs(tile_k) - 1;   // tile_k is a power of two
  const int rpb = (4 * slots) >> tk_shift;  // output columns of the group
  const int lpr = kWide ? tile_k >> 5 : 1;  // lanes per row of a step
  const int H = lpr >= 4 ? lpr >> 2 : 1;    // partial sums per row (below)
  // row groups holding a row < M: the others are not run
  const int rgs = kRG == 1 ? 1 : (M + kDecM - 1) / kDecM;
  float* red = dsm;                         // [W][rpb][H][kM]
  float* redsx = dsm + W * rpb * H * kM;    // [W][4][kM]
  uint2* xs = reinterpret_cast<uint2*>(redsx + W * 4 * kM) +
              warp * kXsPieces;             // the warp's x tile (M ≤ 4)
  const int nkt = K / tile_k, nnt = N / tile_n;
  int rg = blockIdx.x;
  if (kGrouped) {
    const int groups = nnt * bpt;
    const int e = rg / groups;
    rg -= e * groups;
    float* __restrict__ none = nullptr;
    float* __restrict__ none_sx = nullptr;
    to_expert(e, ex, M, N, K, x, codes, lits, scale, zero, out, none,
              none_sx);
  }
  const int j = rg >> (__ffs(bpt) - 1), bb = rg & (bpt - 1);  // powers of 2
  const int n0 = j * tile_n + bb * rpb;
  // the epilogue's first scale and zero, read now: not at the block's end
  float sc = 0.f, zr = 0.f;
  if (tid < rpb * M) {
    sc = __ldg(scale + n0 + tid % rpb);
    zr = __ldg(zero + n0 + tid % rpb);
  }
  if (!kWide) {
    for (int i = tid; i < W * rpb * kM; i += blockDim.x) red[i] = 0.f;
    __syncthreads();
  }
  // 0x4B000000, not known to the compiler (M ≥ 1): see gram_byte
  const uint32_t magic = 0x4B000000u | ((uint32_t)M >> 31);

  // Tensor-core mapping (wide).  Lane L = 4·gq + tq holds, in step st,
  // the grams of row st·(32 / lpr) + L / lpr, columns 32·(L % lpr) + 4u
  // .. + 3 (u = 0..7).  mma u of step st takes them as its B fragment:
  // column n = gq, K slots {2tq, 2tq + 1, 2tq + 8, 2tq + 9} = the gram's 4
  // columns (the product's K order permuted).  The 16 A rows are (s, m),
  // s = r / 4, m = r % 4: row (s, m) holds x row m (of the row group) at
  // the columns of the lanes of "group" s — lanes whose tq reads column
  // block 4s + tq (lpr ≥ 4: the gq with gq % H = s), or lanes with tq /
  // lpr = s (lpr 1 or 2) — and zero at the other K slots.  So C[(s, m)][n]
  // is x row m against weight row (n, s)'s columns of lane group s: a
  // partial sum when s belongs to column n (lpr ≥ 4: s = n % H, H column
  // blocks of 128 per row), a cross term to drop otherwise.  One more mma
  // against ones sums x: Σ_{s < H} C[(s, m)][·] is Σ_k x[m][k] over the
  // tile.  Each row group has its own A, C and Σx mma.
  const int gq = lane >> 2, tq = lane & 3;
  const uint2* xa[2];   // A rows gq and gq + 8 (M ≤ 4: in xs)
  int xc[2];            // ... their column in the tile (5–16 rows: in x)
  bool av[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int sg = (gq >> 2) + 2 * i;
    av[i] = lpr >= 4 ? sg < H : sg == tq / lpr;
    const int blk = lpr >= 4 ? 4 * sg + tq : (tq & (lpr - 1));
    xa[i] = xs + (gq & 3) * 8 * 16 + (av[i] ? blk : 0);
    xc[i] = 32 * (av[i] ? blk : 0);
  }
  constexpr uint32_t kOnes = 0x3F803F80u;   // bf16x2 (1, 1)

  for (int vw = warp; vw < W; vw += P) {
    float acc[kRG][kDecSteps][4], csx[kRG][4];
#pragma unroll
    for (int r = 0; r < kRG; ++r)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        csx[r][v] = 0.f;
#pragma unroll
        for (int st = 0; st < kDecSteps; ++st) acc[r][st][v] = 0.f;
      }
    float sx[kM];                            // narrow: Σ_k x
#pragma unroll
    for (int m = 0; m < kM; ++m) sx[m] = 0.f;
    float* wred = red + vw * rpb * kM;      // narrow: [rpb][kM]

    for (int kt = vw; kt < nkt; kt += W) {
      const long long blk = tile_block(j, kt, nnt, nkt_g, bpt) + bb;
      const int k0 = kt * tile_k;
      if (kWide && kRG == 1) {
        __syncwarp();                  // the last tile's reads of xs are done
        stage_x(x, M, K, k0, tile_k, lane, xs);
      }
      // narrow tiles have at most 512 slots (rows ≤ tile_n ≤ 128): 2 steps
      constexpr int kSteps = kWide ? kDecSteps : 2;
      uint32_t g[kSteps][8];
      decode_grams<kWide, kSteps>(codes + blk * slots, lits + blk * cap, lut,
                                  slots, cap, lane, g);
      if constexpr (kWide && kRG > 1) {
        // two mma steps (u = 2v, 2v + 1) a 16-byte read of each row
        // group's A pieces (x columns 32·blk + 8v .. + 7 of its row, pieces
        // u = 2v and 2v + 1 of M ≤ 4's layout); each accumulator sees
        // u = 0..7 in order, as at M ≤ 4
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          uint32_t bq[2][kDecSteps][2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int st = 0; st < kDecSteps; ++st) {
              const uint32_t gr = g[st][2 * v + h];
              bq[h][st][0] = bf16x2_of(gram_byte(gr, magic, 0),
                                       gram_byte(gr, magic, 1));
              bq[h][st][1] = bf16x2_of(gram_byte(gr, magic, 2),
                                       gram_byte(gr, magic, 3));
            }
#pragma unroll
          for (int r = 0; r < kRG; ++r) {
            if (r >= rgs) break;
            // rows past M read row M − 1: their sums are never stored
            const __nv_bfloat16* xrow =
                x + (long long)min(kDecM * r + (gq & 3), M - 1) * K + k0 +
                8 * v;
            uint4 q0 = make_uint4(0u, 0u, 0u, 0u), q1 = q0;
            if (av[0]) q0 = __ldg(reinterpret_cast<const uint4*>(xrow + xc[0]));
            if (av[1]) q1 = __ldg(reinterpret_cast<const uint4*>(xrow + xc[1]));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t a[4] = {h ? q0.z : q0.x, h ? q1.z : q1.x,
                                     h ? q0.w : q0.y, h ? q1.w : q1.y};
              qmoe::mma_bf16(csx[r], a, kOnes, kOnes);
#pragma unroll
              for (int st = 0; st < kDecSteps; ++st)
                qmoe::mma_bf16(acc[r][st], a, bq[h][st][0], bq[h][st][1]);
            }
          }
        }
      } else if constexpr (kWide) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
        // steps past the block hold zero grams: their sums are never stored
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          uint32_t bq[kDecSteps][2];
#pragma unroll
          for (int st = 0; st < kDecSteps; ++st) {
            bq[st][0] = bf16x2_of(gram_byte(g[st][u], magic, 0),
                                  gram_byte(g[st][u], magic, 1));
            bq[st][1] = bf16x2_of(gram_byte(g[st][u], magic, 2),
                                  gram_byte(g[st][u], magic, 3));
          }
          const uint2 p0 = av[0] ? xa[0][u * 16] : make_uint2(0u, 0u);
          const uint2 p1 = av[1] ? xa[1][u * 16] : make_uint2(0u, 0u);
          const uint32_t a[4] = {p0.x, p1.x, p0.y, p1.y};
          qmoe::mma_bf16(csx[0], a, kOnes, kOnes);
#pragma unroll
          for (int st = 0; st < kDecSteps; ++st)
            qmoe::mma_bf16(acc[0][st], a, bq[st][0], bq[st][1]);
        }
      } else {
        // tile_k 4, 8, 16: gpr grams per row, whole rows in one lane
        const int gpr = tile_k >> 2;
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          float ra[kM];
#pragma unroll
          for (int m = 0; m < kM; ++m) ra[m] = 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int slot = st * 256 + lane * 8 + u;
            if (slot >= slots) continue;
            const int c0 = k0 + (((lane * 8 + u) & (gpr - 1)) << 2);
#pragma unroll
            for (int m = 0; m < kM; ++m) {
              if (m >= kDecM * rgs) break;
              float xf[4];
              bf16x4_to_float(__ldg(reinterpret_cast<const uint2*>(
                                  x + (long long)min(m, M - 1) * K + c0)),
                              xf);
#pragma unroll
              for (int b = 0; b < 4; ++b)
                ra[m] = fmaf(xf[b], gram_byte(g[st][u], magic, b), ra[m]);
            }
            if (((lane * 8 + u + 1) & (gpr - 1)) == 0) {
              float* r = wred + (slot >> (tk_shift - 2)) * kM;
#pragma unroll
              for (int m = 0; m < kM; ++m) {
                r[m] += ra[m];
                ra[m] = 0.f;
              }
            }
          }
        }
        // Σ_k x over this tile's columns, 4 per lane at a time
        for (int c = k0 + lane * 4; c < k0 + tile_k; c += 128) {
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            if (m >= kDecM * rgs) break;
            float xf[4];
            bf16x4_to_float(__ldg(reinterpret_cast<const uint2*>(
                                x + (long long)min(m, M - 1) * K + c)),
                            xf);
            sx[m] += (xf[0] + xf[1]) + (xf[2] + xf[3]);
          }
        }
      }
    }

    if (kWide) {
      // each (row, s, m) partial is one C entry of one lane
      const int rps = 32 / lpr;   // rows per step
#pragma unroll
      for (int r = 0; r < kRG; ++r) {
        if (r >= rgs) break;
#pragma unroll
        for (int st = 0; st < kDecSteps; ++st) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int ar = gq + 8 * (v >> 1), n = 2 * tq + (v & 1);
            const int sg = ar >> 2, m = ar & 3;
            bool use;
            int row;
            if (lpr >= 4) {
              use = sg == (n & (H - 1));
              row = n / H;
            } else {
              use = sg < 4 / lpr;
              row = (4 / lpr) * n + sg;
            }
            row += st * rps;
            if (use && row < rpb)
              red[((vw * rpb + row) * H + (lpr >= 4 ? sg : 0)) * kM +
                  kDecM * r + m] = acc[r][st][v];
          }
        }
        if (tq == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int ar = gq + 8 * i;
            if ((ar >> 2) < H)
              redsx[(vw * 4 + (ar >> 2)) * kM + kDecM * r + (ar & 3)] =
                  csx[r][2 * i];
          }
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sx[m] += __shfl_xor_sync(0xffffffffu, sx[m], off);
      if (lane == 0)
#pragma unroll
        for (int m = 0; m < kM; ++m) redsx[vw * 4 * kM + m] = sx[m];
    }
  }
  __syncthreads();

  // the partials in (warp, s) order, then the affine epilogue
  for (int t = tid; t < rpb * M; t += blockDim.x) {
    const int m = t >> (__ffs(rpb) - 1), row = t & (rpb - 1);
    float a = 0.f, sum = 0.f;
#pragma unroll 4
    for (int w = 0; w < W; ++w)
#pragma unroll 4
      for (int h = 0; h < H; ++h) {
        a += red[((w * rpb + row) * H + h) * kM + m];
        sum += redsx[(w * 4 + h) * kM + m];
      }
    const int n = n0 + row;
    if (t >= blockDim.x) sc = scale[n], zr = zero[n];
    qmoe::store(out + (long long)m * N + n, qmoe::affine(sc, zr, a, sum));
  }
}

// The SIMT kernel: BM = 2·RPT rows (4 or 16) × 128 columns a block, K
// split over gridDim.z, the product on the CUDA cores.  It serves only
// tiles 1 or 2 weights wide (a gram spans rows: the tile is staged 4
// columns wide, x zero past tile_k) and compressed blocks past the decode
// kernel's limits; every served model's tiles take the other two.
template <int RPT, typename TOut, bool kGrouped>
__global__ void __launch_bounds__(qmoe::kThreads)
fused_decode_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                           const uint16_t* __restrict__ codes,
                           const uint32_t* __restrict__ lits,
                           const uint32_t* __restrict__ lut,
                           const float* __restrict__ scale,
                           const float* __restrict__ zero,
                           TOut* __restrict__ out, float* __restrict__ part,
                           float* __restrict__ sxpart, int M, int N, int K,
                           int tile_n, int tile_k, int slots, int cap,
                           int bpt, int nkt_g, int tiles_per_split,
                           Expert ex) {
  constexpr int BM = 2 * RPT;
  extern __shared__ __align__(16) unsigned char smem[];
  // a staged row holds at least 4 columns (one uint32 / float4 read); below
  // tile_k 4 the columns past tile_k are x = 0, so any weight byte there
  // adds nothing
  const int tkw = max(tile_k, 4);
  const int qstride = tkw + 4;
  unsigned char* qs = smem;                                     // 128 × qstride
  float* xs = reinterpret_cast<float*>(smem + qmoe::kBN * qstride);  // BM × tkw
  float* sumx = xs + BM * tkw;                                   // BM

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = tid % qmoe::kBN, g = tid / qmoe::kBN;
  const int nkt = K / tile_k, nnt = N / tile_n;
  const int tpb = qmoe::kBN / tile_n;                 // N tiles per block
  const int j0 = blockIdx.x * tpb;
  const int tcount = min(tpb, nnt - j0);
  const int m0 = blockIdx.y * BM;
  const int split = kGrouped ? blockIdx.z % ex.splits : blockIdx.z;
  const int kt0 = split * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, nkt);
  const int block_bytes = 4 * slots;
  const int tk_shift = __ffs(tile_k) - 1;   // tile_k is a power of two
  if (kGrouped)
    to_expert(blockIdx.z / ex.splits, ex, M, N, K, x, codes, lits, scale,
              zero, out, part, sxpart);

  if (tid < BM) sumx[tid] = 0.f;
  __syncthreads();
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    for (int idx = warp; idx < tcount * bpt; idx += qmoe::kThreads / 32) {
      int jj = idx / bpt, bb = idx - jj * bpt;
      long long blk = tile_block(j0 + jj, kt, nnt, nkt_g, bpt) + bb;
      decode_block(codes + blk * slots, lits + blk * cap, lut, slots, cap,
                   qs + jj * tile_n * qstride, qstride, tk_shift,
                   bb * block_bytes, lane);
    }
    qmoe::load_x_tile(x, M, K, m0, kt * tile_k, tile_k, tkw, BM, tkw, xs);
    __syncthreads();
    qmoe::add_row_sums(xs, BM, tkw, tkw, sumx);
    qmoe::dot_chunk<RPT>(qs + n * qstride, xs, tkw, tkw, g, acc);
    __syncthreads();
  }
  qmoe::finish_block<RPT, TOut>(acc, sumx, scale, zero, out, part, sxpart,
                                M, N, m0, blockIdx.x * qmoe::kBN + n, g,
                                split);
}

// Prefill-sized M: the same decode, with the product on the tensor cores
// (mma.sync m16n8k16, bf16 × bf16 → f32; q ≤ 255 and bf16 x are exact in
// bf16, and the sums of integer-valued inputs stay exact in f32, so the
// bitwise contract with the plain version holds).
//
// A block owns one 128-column stripe of N, one K split (tiles [kt0, kt1))
// and a group of consecutive 128-row bands of M.  It decodes its K tiles a
// span at a time (at most 512 columns in the wrapper's plan), widened to
// bf16 side by side in shared memory, and every band of the group runs its
// product over the decoded span, so a weight tile is decoded once per band
// group, not once per band.  The wrapper's plan keeps that consistent: a
// block with several bands gets a split of one span (its partial sums go
// to the split-K workspace after each band); a block with one band may
// walk many spans, accumulating.  Per band, x comes in 64-column steps by
// cp.async into three stages, two steps' copies in flight while the
// tensor cores run the current one.  Sixteen warps hold 4 × 4 tiles of
// 32 × 32 f32 accumulators, their A (x) and B (q) fragments read by
// ldmatrix.  At the band's end each thread writes its accumulators: raw
// into the workspace, or through the affine epilogue into out when the
// launch has one split.  One 512-thread block per SM: a 512-column span in
// bf16 and the x stages take 185 KiB of shared memory, and 32
// accumulators a thread stay in the 128 registers a thread may hold.
constexpr int kMmaThreads = 512;
constexpr int kMmaBM = 128;
constexpr int kSubK = 64;
constexpr int kLdX = kSubK + 8;     // bf16 per staged x row (16-byte multiple)
constexpr int kStages = 3;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

constexpr size_t kXStage = align128((size_t)kMmaBM * kLdX * 2);  // bytes

// The columns a span of span_cols decoded columns takes in shared memory:
// whole 64-column steps (tile_k < 64 can leave a span short of a step).
__host__ __device__ constexpr int span_alloc(int span_cols) {
  return (span_cols + kSubK - 1) / kSubK * kSubK;
}

// Shared memory of the tensor-core kernel for a span of span_cols decoded
// columns: the span in bf16 (row stride span_alloc(span_cols) + 8),
// kStages bf16 stages of one 64-column step of x, and the row sums of x.
__host__ __device__ inline size_t mma_smem_bytes(int span_cols) {
  return align128((size_t)qmoe::kBN * (span_alloc(span_cols) + 8) * 2) +
         kStages * kXStage + kMmaBM * sizeof(float);
}

// dst[0:8) = src[0:src_bytes) and zeros after, through L1: x rows that
// are 8 but not 16 bytes apart (K ≡ 4 mod 8, tile_k 4).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// kNarrow: tile_k < 64, where a span may end inside a 64-column step and
// rows of x may be 8 bytes out of step; else every span is whole steps.
template <typename TOut, bool kGrouped, bool kNarrow>
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_decode_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                               const uint16_t* __restrict__ codes,
                               const uint32_t* __restrict__ lits,
                               const uint32_t* __restrict__ lut,
                               const float* __restrict__ scale,
                               const float* __restrict__ zero,
                               TOut* __restrict__ out,
                               float* __restrict__ part,
                               float* __restrict__ sxpart, int M, int N,
                               int K, int tile_n, int tile_k, int slots,
                               int cap, int bpt, int nkt_g,
                               int tiles_per_split, int span,
                               int bands_per_block, Expert ex) {
  constexpr int kWarps = kMmaThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int qstride = span_alloc(span * tile_k) + 8;   // bf16 a row
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const size_t qbytes = align128((size_t)qmoe::kBN * qstride * 2);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + qbytes);
  float* sumx = reinterpret_cast<float*>(smem + qbytes + kStages * kXStage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;       // 4 × 4 warps of 32 × 32
  const int g = lane >> 2, tq = lane & 3;        // mma fragment coordinates
  const int nkt = K / tile_k, nnt = N / tile_n;
  const int tpb = qmoe::kBN / tile_n;
  const int j0 = blockIdx.x * tpb;
  const int tcount = min(tpb, nnt - j0);
  const int n0 = blockIdx.x * qmoe::kBN;
  const long long split = kGrouped ? blockIdx.z % ex.splits : blockIdx.z;
  const int kt0 = (int)split * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, nkt);
  const int bands = (M + kMmaBM - 1) / kMmaBM;
  const int band0 = blockIdx.y * bands_per_block;
  const int band1 = min(band0 + bands_per_block, bands);
  const int block_bytes = 4 * slots;
  const int tk_shift = __ffs(tile_k) - 1;   // tile_k is a power of two
  // the row sums feed the epilogue: every block's with one split, else
  // the first stripe's, once per split
  const bool need_sumx = part == nullptr || blockIdx.x == 0;
  if (kGrouped)
    to_expert(blockIdx.z / ex.splits, ex, M, N, K, x, codes, lits, scale,
              zero, out, part, sxpart);
  // this lane's ldmatrix rows: A (x) rows of the warp's m16 tiles, B (q)
  // rows of its n8 tile pairs, and the column offset of each
  const int a_row = wm * 32 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;

  float acc[2][4][4];                            // [m16 tile][n8 tile][4]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  for (int c0 = kt0; c0 < kt1; c0 += span) {
    const int c1 = min(c0 + span, kt1);
    // decode K tiles [c0, c1) of the stripe's N tiles: tile (jj, c0 + t)
    // at rows jj·tile_n, columns t·tile_k of the span
    const int per_row = (c1 - c0) * bpt;
    for (int idx = warp; idx < tcount * per_row; idx += kWarps) {
      const int jj = idx / per_row, rem = idx - jj * per_row;
      const int t = rem / bpt, bb = rem - t * bpt;
      const long long blk =
          tile_block(j0 + jj, c0 + t, nnt, nkt_g, bpt) + bb;
      decode_block(codes + blk * slots, lits + blk * cap, lut, slots, cap,
                   qs + jj * tile_n * qstride + t * tile_k, qstride,
                   tk_shift, bb * block_bytes, lane);
    }
    // below tile_k 64 a span may end inside a step: its last step is
    // padded with q = 0 here and x = 0 (copied from no source) below
    const int vc = (c1 - c0) * tile_k;          // the span's real columns
    const int steps = (vc + kSubK - 1) / kSubK;
    const int pad = steps * kSubK - vc;
    if (kNarrow)
      for (int i = tid; i < qmoe::kBN * pad; i += kMmaThreads)
        qs[(i / pad) * qstride + vc + i % pad] = __float2bfloat16_rn(0.f);
    __syncthreads();
    for (int band = band0; band < band1; ++band) {
      const int m0 = band * kMmaBM;
      if (c0 == kt0 && tid < kMmaBM) sumx[tid] = 0.f;
      // x: 128 rows × 64 columns of step st into stage st % kStages, 16
      // bytes per copy (the wrapper passes x 16-byte aligned, and a span
      // starts on a multiple of 8 columns), or 2 × 8 where rows are 8
      // bytes out of step (K ≡ 4 mod 8); rows past M and columns past the
      // span read nothing and are zero.  One copy group per step, empty
      // past the last, so that waiting for all but the newest kStages − 2
      // groups always means step st is in.
      auto load_x = [&](int st) {
        if (st < steps) {
          __nv_bfloat16* dst = xs + (st % kStages) * (kXStage / 2);
          const long long xcol = (long long)c0 * tile_k + st * kSubK;
          for (int i = tid; i < kMmaBM * (kSubK / 8); i += kMmaThreads) {
            const int r = i / (kSubK / 8), c = (i - r * (kSubK / 8)) * 8;
            const int m = m0 + r;
            // bytes of this row's 8 columns inside the span
            const int nb =
                m >= M ? 0
                       : kNarrow ? 2 * min(max(vc - st * kSubK - c, 0), 8)
                                 : 16;
            const __nv_bfloat16* src = x + (long long)min(m, M - 1) * K +
                                       (kNarrow && !nb ? 0 : xcol + c);
            if (kNarrow && (K & 7)) {
              cp_async8(dst + r * kLdX + c, src, min(nb, 8));
              cp_async8(dst + r * kLdX + c + 4, nb > 8 ? src + 4 : src,
                        max(nb - 8, 0));
            } else {
              cp_async16(dst + r * kLdX + c, src, nb);
            }
          }
        }
        cp_async_commit();
      };
      for (int st = 0; st < kStages - 1; ++st) load_x(st);
      for (int st = 0; st < steps; ++st) {
        cp_async_wait<kStages - 2>();
        // step st is in; every warp is done with step st − 1's stage
        __syncthreads();
        load_x(st + kStages - 1);
        const __nv_bfloat16* xt = xs + (st % kStages) * (kXStage / 2);
        if (need_sumx) {
          // four threads a row, 16 columns each: two 16-byte loads, a
          // short chain of adds and two shuffles, no loop over rows
          static_assert(kMmaThreads == 4 * kMmaBM, "four threads per row");
          const int r = tid >> 2;
          const uint4* src = reinterpret_cast<const uint4*>(
              xt + r * kLdX + (tid & 3) * 16);
          const uint4 v[2] = {src[0], src[1]};
          float sx = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t w[4] = {v[h].x, v[h].y, v[h].z, v[h].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&w[u]));
              sx += f.x + f.y;
            }
          }
          sx += __shfl_xor_sync(0xffffffffu, sx, 1);
          sx += __shfl_xor_sync(0xffffffffu, sx, 2);
          if ((tid & 3) == 0) sumx[r] += sx;
        }
        const __nv_bfloat16* qt = qs + st * kSubK;
#pragma unroll
        for (int kk = 0; kk < kSubK; kk += 16) {
          uint32_t a[2][4], b[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ldmatrix_x4(a[i], xt + (a_row + i * 16) * kLdX + kk + a_col);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            ldmatrix_x4(b[p], qt + (b_row + p * 16) * qstride + kk + b_col);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                       b[j >> 1][(j & 1) * 2 + 1]);
        }
      }
      __syncthreads();     // the stages and the span are free again
      if (c1 < kt1) continue;      // the band's sums go on over the next span
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + g + h * 8;
          const int m = m0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int n = n0 + wn * 32 + j * 8 + tq * 2 + v;
              const float a = acc[i][j][2 * h + v];
              acc[i][j][2 * h + v] = 0.f;
              if (m >= M || n >= N) continue;
              if (part == nullptr)
                qmoe::store(out + (long long)m * N + n,
                            qmoe::affine(scale[n], zero[n], a, sumx[r]));
              else
                part[(split * M + m) * N + n] = a;
            }
          }
        }
      }
      if (part != nullptr && blockIdx.x == 0 && tid < kMmaBM && m0 + tid < M)
        sxpart[split * M + m0 + tid] = sumx[tid];
      __syncthreads();     // sumx is the next band's
    }
  }
}

// The split-K epilogue after a launch that wrote partial sums.
template <typename TOut>
int finish_launch(const void* part, const void* sxpart, const void* scale,
                  const void* zero, TOut* out, int out_bf16, int M, int N,
                  int splits, int E, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return qmoe::launch_splitk_epilogue(
      static_cast<const float*>(part), static_cast<const float*>(sxpart),
      static_cast<const float*>(scale), static_cast<const float*>(zero), out,
      out_bf16, M, N, splits, stream, E);
}

template <typename TOut, bool kGrouped>
int launch(int bm, const void* x, const void* codes, const void* lits,
           const void* lut, const void* scale, const void* zero, void* out,
           void* part, void* sxpart, int out_bf16, int M, int N, int K,
           int tile_n, int tile_k, int slots, int cap, int bpt, int groups,
           int splits, int tiles_per_split, int span, int bands_per_block,
           int decode_warps, int E, cudaStream_t stream) {
  const int nkt = K / tile_k;
  if (groups < 1 || nkt % groups || splits < 1 || tiles_per_split < 1 ||
      (long long)tiles_per_split * (splits - 1) >= nkt ||
      (long long)tiles_per_split * splits < nkt)
    return (int)cudaErrorInvalidValue;
  const int nkt_g = nkt / groups;   // K tiles of one column group
  const long long nb = (long long)(N / tile_n) * nkt * bpt;
  const Expert ex = {nb * slots, nb * cap, splits};
  const int stripes = (N + qmoe::kBN - 1) / qmoe::kBN;
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* cp = static_cast<const uint16_t*>(codes);
  auto* lp = static_cast<const uint32_t*>(lits);
  auto* up = static_cast<const uint32_t*>(lut);
  auto* sp = static_cast<const float*>(scale);
  auto* zp = static_cast<const float*>(zero);
  auto* op = static_cast<TOut*>(out);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  auto* sxp = static_cast<float*>(sxpart);
  if (decode_warps > 0) {
    // one block per row group, all of K: no split, no workspace
    const int rpb = 4 * slots / tile_k;
    if (M > kDecM * kDecRG || splits != 1 || tile_k < 4 ||
        decode_warps > kDecMaxWarps ||
        slots > (tile_k >= 32 ? 256 * kDecSteps : 512) ||
        rpb * tile_k != 4 * slots || (bpt & (bpt - 1)) || (rpb & (rpb - 1)))
      return (int)cudaErrorInvalidValue;
    const bool rows16 = M > kDecM;                    // four row groups
    const int kM = rows16 ? kDecM * kDecRG : kDecM;   // the kernel's kM
    const int P = rows16 && decode_warps > kDecRowWarps ? kDecRowWarps
                                                      : decode_warps;
    const int H = tile_k >= 128 ? tile_k / 128 : 1;   // the kernel's H
    // x tiles in shared memory at M ≤ 4 only
    const size_t smem = (size_t)decode_warps * (rpb * H + 4) * kM * 4 +
                        (tile_k >= 32 && !rows16 ? (size_t)P * kXsPieces * 8
                                                 : 0);
    const long long blocks = (long long)E * (N / tile_n) * bpt;
    auto kern =
        tile_k >= 32
            ? (rows16 ? &fused_decode_matmul_decode_kernel<TOut, kGrouped,
                                                           true, kDecRG>
                      : &fused_decode_matmul_decode_kernel<TOut, kGrouped,
                                                           true, 1>)
            : (rows16 ? &fused_decode_matmul_decode_kernel<TOut, kGrouped,
                                                           false, kDecRG>
                      : &fused_decode_matmul_decode_kernel<TOut, kGrouped,
                                                           false, 1>);
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)blocks, P * 32, smem, stream>>>(
        xp, cp, lp, up, sp, zp, op, M, N, K, tile_n, tile_k, slots, cap, bpt,
        nkt_g, decode_warps, ex);
    return (int)cudaGetLastError();
  }
  if (bm == kMmaBM) {
    const int bands = (M + kMmaBM - 1) / kMmaBM;
    // a block with several bands must see its whole split in one span;
    // splits and the spans inside them start on whole 64-column steps, so
    // only a split's last span may be short of one
    if (tile_k < 4 || span < 1 || bands_per_block < 1 ||
        (bands_per_block > 1 && tiles_per_split > span) ||
        (splits > 1 && tiles_per_split * tile_k % kSubK) ||
        (tiles_per_split > span && span * tile_k % kSubK))
      return (int)cudaErrorInvalidValue;
    const size_t smem = mma_smem_bytes(span * tile_k);
    auto kern = tile_k < kSubK
                    ? &fused_decode_matmul_mma_kernel<TOut, kGrouped, true>
                    : &fused_decode_matmul_mma_kernel<TOut, kGrouped, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    // the most shared memory the SM can give
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(stripes, (bands + bands_per_block - 1) / bands_per_block,
              E * splits);
    kern<<<grid, kMmaThreads, smem, stream>>>(
        xp, cp, lp, up, sp, zp, op, pp, sxp, M, N, K, tile_n, tile_k, slots,
        cap, bpt, nkt_g, tiles_per_split, span, bands_per_block, ex);
    return finish_launch(part, sxpart, scale, zero, op, out_bf16, M, N,
                         splits, E, stream);
  }
  const int tkw = tile_k < 4 ? 4 : tile_k;     // the kernel's staged width
  const size_t qbytes = (size_t)qmoe::kBN * (tkw + 4);
  auto kern = bm == 4 ? &fused_decode_matmul_kernel<2, TOut, kGrouped>
                      : &fused_decode_matmul_kernel<8, TOut, kGrouped>;
  if (bm != 4 && bm != 16) return (int)cudaErrorInvalidValue;
  const size_t smem = qbytes + (bm * tkw + bm) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(stripes, (M + bm - 1) / bm, E * splits);
  kern<<<grid, qmoe::kThreads, smem, stream>>>(
      xp, cp, lp, up, sp, zp, op, pp, sxp, M, N, K, tile_n, tile_k, slots,
      cap, bpt, nkt_g, tiles_per_split, ex);
  return finish_launch(part, sxpart, scale, zero, op, out_bf16, M, N, splits,
                       E, stream);
}

template <typename TOut>
int launch_any(int E, int bm, const void* x, const void* codes,
               const void* lits, const void* lut, const void* scale,
               const void* zero, void* out, void* part, void* sxpart,
               int out_bf16, int M, int N, int K, int tile_n, int tile_k,
               int slots, int cap, int bpt, int groups, int splits,
               int tiles_per_split, int span, int bands_per_block,
               int decode_warps, cudaStream_t stream) {
  if (E == 1)
    return launch<TOut, false>(bm, x, codes, lits, lut, scale, zero, out,
                               part, sxpart, out_bf16, M, N, K, tile_n,
                               tile_k, slots, cap, bpt, groups, splits,
                               tiles_per_split, span, bands_per_block,
                               decode_warps, E, stream);
  return launch<TOut, true>(bm, x, codes, lits, lut, scale, zero, out, part,
                            sxpart, out_bf16, M, N, K, tile_n, tile_k, slots,
                            cap, bpt, groups, splits, tiles_per_split, span,
                            bands_per_block, decode_warps, E, stream);
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error code (0 = ok).
// E weights of one shape in one launch: x (E, M, K), planes (E, nb, slots)
// and (E, nb, cap, 4), scale/zero (E, N, 1), out (E, M, N) — K1 is E = 1,
// K3 a whole expert stack.  groups: K1's column groups G (1 for K3), the
// nb blocks of a weight being G groups' planes one after another, each for
// K/G columns (K/tile_k must divide by G); bpt: blocks per weight tile.
// decode_warps > 0: the decode-batch kernel (M ≤ 16, tile_k ≥ 4, slots ≤
// 1024, one split, power-of-two bpt); the K tiles dealt to that many
// warps, which a block of as many (M ≤ 4) or at most 8 (M 5–16) runs.
// Else bm: rows per block — 4 or 16 (SIMT product) or 128 (tensor cores;
// needs tile_k ≥ 4, and takes span: K tiles decoded at once, and
// bands_per_block: 128-row bands per block, which needs a split of at
// most one span).  K is cut into splits runs of tiles_per_split tiles
// (the last may be shorter; below tile_k 64 whole 64-column steps but
// the last).  part/sxpart: f32 workspaces of E·splits·M·N and E·splits·M
// (unused when splits == 1).  The literal plane is read as one uint32 per
// gram (S = 4).
extern "C" int qmoe_fused_decode_matmul(
    const void* x, const void* codes, const void* lits, const void* lut,
    const void* scale, const void* zero, void* out, void* part, void* sxpart,
    int out_bf16, int E, int M, int N, int K, int tile_n, int tile_k,
    int slots, int cap, int bpt, int groups, int splits, int tiles_per_split,
    int bm, int span, int bands_per_block, int decode_warps, int device,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // This library links its own CUDA runtime: select the tensors' device.
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (out_bf16)
    return launch_any<__nv_bfloat16>(E, bm, x, codes, lits, lut, scale, zero,
                                     out, part, sxpart, 1, M, N, K, tile_n,
                                     tile_k, slots, cap, bpt, groups, splits,
                                     tiles_per_split, span, bands_per_block,
                                     decode_warps, s);
  return launch_any<float>(E, bm, x, codes, lits, lut, scale, zero, out,
                           part, sxpart, 0, M, N, K, tile_n, tile_k, slots,
                           cap, bpt, groups, splits, tiles_per_split, span,
                           bands_per_block, decode_warps, s);
}
