// W8A16 dequant × matmul against a dense uint8 weight.
//
// Replaces repro/kernels/dequant_matmul.py::dequant_matmul (the TPU Pallas
// kernel _kernel):
//
//   y[m, n] = s[n] · (Σ_k bf16(x[m, k]) · q[n, k] − z[n] · Σ_k bf16(x[m, k]))
//
// On the compressed main path it is the tied LM head of Llama-3.2 (a
// QuantLinear: 128 256 × 2048 uint8, 263 MB) and DeepSeek-V2-Lite's
// int8 head (102 400 × 2048) at M = batch, every prefill and decode step.
// There it is a GEMV over the weight, bound by memory bytes: the weight is
// read once.  In mode='quant' every projection is a QuantLinear, and on
// the resilience ladder's unfused rung every projection runs K4 then K5:
// there each prefill is a GEMM at M = the prompt's tokens (700 for 4 × 175),
// about 1 200 operations a byte, above the card's ridge of ~295: bound by
// the tensor cores' operations (0.024 ms for Llama's w_gate at M = 700).
// Three kernels, picked by the wrapper's plan (dequant_plan):
//
//   * the decode kernel at M ≤ 4 with K % 16 == 0 (below), which the
//     wrapper also launches once a group of 4 rows at M 5–16, so that a
//     row has its bits alone at every M up to 16;
//   * the tensor-core kernel from M = 17 on with K % 16 == 0 (below);
//   * the SIMT kernel where K % 16 ≠ 0: blocks of 128 output columns walk
//     K in 512-byte chunks through shared memory, split over gridDim.z
//     when N/128 × M/BM blocks would leave the card idle
//     (matmul_common.cuh's block layout and split-K epilogue).
//
// Ragged M, N and K are masked in the kernels, never padded in device
// memory.
//
// The decode kernel.  Its bound is the weight's bytes: 263 MB for Llama's
// head, 0.079 ms at 3.35 TB/s.  The SIMT kernel reached 1.22 TB/s there,
// slower than torch.matmul reading the bf16 weight (twice the bytes), for
// four costs in series; what this kernel does about each:
//   1. Load → barrier → dot → barrier per 512-byte chunk, the weight copied
//      through registers into shared memory, 3 blocks (24 warps) an SM by
//      its 74 KB of shared memory: loads and products never overlapped
//      within a block.  Here a warp owns 8 weight rows and walks all of K
//      from registers: each lane reads 16 bytes of a row (4 lanes a row, so
//      a warp-wide load reads 64 whole bytes — two sectors — of 8 rows),
//      by ld.global.nc, 8 loads a lane a stage; the next stage (and across
//      a row group's end, the next group's first) is issued before the
//      current one's product.  No barrier and no shared memory in the
//      stream; 8 KB in flight a warp while it waits.
//   2. Each weight byte converted by an I2F (16 a clock an SM), twice (by
//      both row groups of the block): ~0.126 ms of conversions alone.
//      Here each byte becomes an exact f32 by one PRMT and one FADD
//      (gram_byte) and is packed to bf16x2 once.
//   3. The product on the SIMT cores.  Here it runs on mma.sync m16n8k16:
//      each lane's 4 bytes (one word of its 16-byte load) are its own B
//      fragment — column n = the lane's row, K slots {2t, 2t + 1, 2t + 8,
//      2t + 9} = the word's 4 columns (the K order permuted) — and A row m
//      holds x[m] at the columns each lane's word covers (rows 4–15 zero).
//   4. x staged as f32 by scalar loads in every chunk of every block, and
//      its row sums recomputed per chunk.  Here a block copies x (4 × K
//      bf16) into shared memory once by cp.async and sums its rows once.
// The whole of K is reduced in one warp in a fixed order: no split, no
// workspace, no second launch; two calls give the same bits.  The affine
// epilogue (qmoe::affine) is applied in registers, each output stored
// once.  The grid is persistent (dequant_plan): 2 blocks of 8 warps an SM
// at most (the launch bounds hold a thread to 128 registers), as few as
// take the tasks in the same number of rounds.  Each of these choices
// (rows a warp task, warps a block, loads a stage, the grid, the L2
// prefetch, the bf16 packing) is timed against its alternative by
// tools/profile_decode.py --model k5 (PERF.md).
#include <atomic>

#include "matmul_common.cuh"
#include "mma_sm80.cuh"

namespace {

constexpr int kKC = 512;  // K chunk held in shared memory

template <int RPT, typename TOut>
__global__ void __launch_bounds__(qmoe::kThreads)
dequant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint8_t* __restrict__ wq,
                      const float* __restrict__ scale,
                      const float* __restrict__ zero, TOut* __restrict__ out,
                      float* __restrict__ part, float* __restrict__ sxpart,
                      int M, int N, int K, int chunks_per_split) {
  constexpr int BM = 2 * RPT;
  constexpr int qstride = kKC + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                                     // 128 × qstride
  float* xs = reinterpret_cast<float*>(smem + qmoe::kBN * qstride);  // BM × kKC
  float* sumx = xs + BM * kKC;                                   // BM

  const int tid = threadIdx.x;
  const int n = tid % qmoe::kBN, g = tid / qmoe::kBN;
  const int n0 = blockIdx.x * qmoe::kBN;
  const int m0 = blockIdx.y * BM;
  const int nkc = (K + kKC - 1) / kKC;
  const int c0 = blockIdx.z * chunks_per_split;
  const int c1 = min(c0 + chunks_per_split, nkc);
  const bool vec = (K & 15) == 0;

  if (tid < BM) sumx[tid] = 0.f;
  __syncthreads();
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int c = c0; c < c1; ++c) {
    const int k0 = c * kKC;
    const int kc = min(kKC, K - k0);
    const int kc4 = (kc + 3) & ~3;
    if (vec) {  // 16-byte loads; kc is a multiple of 16 here
      const int per_row = kc >> 4;
#pragma unroll 4
      for (int i = tid; i < qmoe::kBN * per_row; i += qmoe::kThreads) {
        int r = i / per_row, c16 = i - r * per_row;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + r < N)
          v = __ldg(reinterpret_cast<const uint4*>(
              wq + (long long)(n0 + r) * K + k0 + 16 * c16));
        uint32_t* dst = reinterpret_cast<uint32_t*>(qs + r * qstride + 16 * c16);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
    } else {
      for (int i = tid; i < qmoe::kBN * kc4; i += qmoe::kThreads) {
        int r = i / kc4, cc = i - r * kc4;
        uint8_t v = 0;
        if (n0 + r < N && cc < kc) v = wq[(long long)(n0 + r) * K + k0 + cc];
        qs[r * qstride + cc] = v;
      }
    }
    qmoe::load_x_tile(x, M, K, m0, k0, kc, kc4, BM, kKC, xs);
    __syncthreads();
    qmoe::add_row_sums(xs, BM, kc4, kKC, sumx);
    qmoe::dot_chunk<RPT>(qs + n * qstride, xs, kKC, kc4, g, acc);
    __syncthreads();
  }
  qmoe::finish_block<RPT, TOut>(acc, sumx, scale, zero, out, part, sxpart,
                                M, N, m0, n0 + n, g, blockIdx.z);
}

// ---------------------------------------------------------------------------
// The decode kernel (M ≤ 4, K % 16 == 0, wq on a 16-byte boundary).

constexpr int kDecM = 4;       // rows of x (A rows 0–3 of the mma)
constexpr int kTiles = 1;      // 8-row tiles (the mma's N) a warp task
constexpr int kLoads = 8;      // 16-byte weight loads a lane holds a stage
constexpr int kSlice = 64;     // columns one load covers across a row's lanes
constexpr int kSlices = kLoads / kTiles;   // 64-column slices a stage
constexpr int kDecWarps = 8;   // warps a block
constexpr int kDecRows = 8 * kTiles;       // weight rows a warp task

// 16 bytes of the weight stream: read once, so not kept in L1; the L2
// fetches the 256-byte segment around it (the row's next loads).
__device__ __forceinline__ uint4 ldg_stream(const uint8_t* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Shared memory of one block: x as bf16, 4 rows of kpad columns (K rounded
// up to whole stages) 2·kpad + 16 bytes apart, so that the 16 lanes
// reading a row piece each (rows 0–3 × 4 lanes) hit 32 different banks;
// then Σx's per-warp partials.
__host__ __device__ inline int decode_kpad(int K) {
  constexpr int cols = kSlice * kSlices;
  return (K + cols - 1) / cols * cols;
}
__host__ __device__ inline int decode_smem_bytes(int K) {
  return kDecM * (2 * decode_kpad(K) + 16) + kDecWarps * kDecM * 4;
}

// Warp task t = weight rows kDecRows·t .. + kDecRows − 1 over all of K;
// warp gw of the grid takes tasks gw, gw + (warps in the grid), ...  Lane
// L = 4·gid + tig reads, of row tile i, row kDecRows·t + 8i + gid at
// columns 64·sl + 16·tig .. + 15 for every slice sl; word u of that load
// is the B fragment of the slice's mma u for the tile.
template <typename TOut>
__global__ void __launch_bounds__(kDecWarps * 32, 2)
dequant_matmul_decode_kernel(const __nv_bfloat16* __restrict__ x,
                             const uint8_t* __restrict__ wq,
                             const float* __restrict__ scale,
                             const float* __restrict__ zero,
                             TOut* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kpad = decode_kpad(K);
  const int P = kpad / (kSlice * kSlices);    // stages a task
  const int xrow = 2 * kpad + 16;             // bytes between rows of x
  float* red = reinterpret_cast<float*>(smem + kDecM * xrow);   // [W][4]
  const int tasks = (N + kDecRows - 1) / kDecRows;
  const int gw = blockIdx.x * kDecWarps + warp, nw = gridDim.x * kDecWarps;
  const int G = (gw < tasks ? (tasks - 1 - gw) / nw + 1 : 0) * P;

  // stage g of this warp: task gw + (g / P)·nw, columns of stage g % P
  using Stage = uint4[kTiles][kSlices];
  auto load = [&](Stage& b, int g) {
    const int q = g / P;
    const int c0 = (g - q * P) * kSlices * kSlice + 16 * tig;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int r = (gw + q * nw) * kDecRows + 8 * i + gid;
      const uint8_t* src = wq + (long long)r * K + c0;
#pragma unroll
      for (int s = 0; s < kSlices; ++s)
        b[i][s] = r < N && c0 + kSlice * s < K ? ldg_stream(src + kSlice * s)
                                               : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // this lane's scale and zero of task t: rows kDecRows·t + 8i + 2·tig +
  // j, the output columns of its C fragments
  float sc[kTiles][2], zr[kTiles][2];
  auto load_affine = [&](int t) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = t * kDecRows + 8 * i + 2 * tig + j;
        sc[i][j] = n < N ? __ldg(scale + n) : 0.f;
        zr[i][j] = n < N ? __ldg(zero + n) : 0.f;
      }
  };

  // The first stage's loads go out before anything waits.
  Stage b0, b1;
  if (G > 0) {
    load(b0, 0);
    load_affine(gw);
  }
  // x → shared memory once a block, rows past M and columns past K zero.
  const int pieces = kpad / 8;                 // 16-byte pieces a row
  for (int i = tid; i < kDecM * pieces; i += blockDim.x) {
    const int m = i / pieces, c = i - m * pieces;
    const bool in = m < M && 8 * c < K;
    qmoe::cp_async16(smem + m * xrow + 16 * c,
                     in ? x + (long long)m * K + 8 * c : x, in ? 16 : 0);
  }
  qmoe::cp_async_commit();
  qmoe::cp_async_wait<0>();
  __syncthreads();
  // Σ_k x[m][k] once a block: each thread sums its pieces of every row,
  // then the warp, then the warps in order.
  float part[kDecM];
#pragma unroll
  for (int m = 0; m < kDecM; ++m) {
    part[m] = 0.f;
    for (int c = tid; c < pieces; c += blockDim.x) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(smem + m * xrow + 16 * c);
      const uint32_t h[4] = {v.x, v.y, v.z, v.w};
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s += __uint_as_float(h[e] << 16) + __uint_as_float(h[e] & 0xFFFF0000u);
      part[m] += s;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part[m] += __shfl_xor_sync(0xffffffffu, part[m], off);
  }
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < kDecM; ++m) red[warp * kDecM + m] = part[m];
  __syncthreads();
  float sx = 0.f;     // Σx of x row gid (lanes gid < 4 store outputs)
  for (int w = 0; w < kDecWarps; ++w) sx += red[w * kDecM + (gid & 3)];

  // 0x4B000000, not known to the compiler (M ≥ 1): see gram_byte
  const uint32_t magic = 0x4B000000u | ((uint32_t)M >> 31);
  const unsigned char* xl = smem + (gid & 3) * xrow + 32 * tig;
  float acc[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  auto compute = [&](const Stage& b, int g) {
    const int q = g / P, p = g - q * P;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      // x[gid][64·sl + 16·tig .. + 15]: the A rows of this slice's 4 mmas
      uint4 xa[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      if (gid < kDecM) {
        const uint4* src = reinterpret_cast<const uint4*>(
            xl + 2 * kSlice * (p * kSlices + s));
        xa[0] = src[0];
        xa[1] = src[1];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4& xv = xa[u >> 1];
        const uint32_t a[4] = {(u & 1) ? xv.z : xv.x, 0u,
                               (u & 1) ? xv.w : xv.y, 0u};
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          const uint32_t w[4] = {b[i][s].x, b[i][s].y, b[i][s].z, b[i][s].w};
          qmoe::mma_bf16(acc[i], a,
                         qmoe::bf16x2_of(qmoe::gram_byte(w[u], magic, 0),
                                         qmoe::gram_byte(w[u], magic, 1)),
                         qmoe::bf16x2_of(qmoe::gram_byte(w[u], magic, 2),
                                         qmoe::gram_byte(w[u], magic, 3)));
        }
      }
    }
    if (p != P - 1) return;
    // The task's end: C[gid][2·tig + j] of tile i is y[gid] at weight row
    // kDecRows·t + 8i + 2·tig + j.
    const int t = gw + q * nw;
    if (gid < M) {
#pragma unroll
      for (int i = 0; i < kTiles; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = t * kDecRows + 8 * i + 2 * tig + j;
          if (n < N)
            qmoe::store(out + (long long)gid * N + n,
                        qmoe::affine(sc[i][j], zr[i][j], acc[i][j], sx));
        }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    if (g + 1 < G) load_affine(t + nw);
  };

  // Two stages in registers: the next is in flight during each product.
  for (int g = 0; g < G; g += 2) {
    if (g + 1 < G) load(b1, g + 1);
    compute(b0, g);
    if (g + 2 < G) load(b0, g + 2);
    if (g + 1 < G) compute(b1, g + 1);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (prefill M, K % 16 == 0, x and wq on 16-byte
// boundaries).  The SIMT kernel served every M > 4 before it, at 1.23 ms
// for Llama's w_gate at M = 700 (52× the bound, 37× torch.matmul), for
// three costs; what this kernel does about each:
//   1. The product on the CUDA cores (f32 FMAs, 19 TFLOP/s).  Here it runs
//      on mma.sync m16n8k16 (bf16 in, f32 sums; q ≤ 255 and bf16 x are
//      exact in bf16, so integer x sums exactly, as in the plain version).
//      A block owns a 128 × 128 output tile and one K split; 8 warps, 2
//      along M × 4 along N, each hold 64 × 32 of f32 sums (4 × 4 tiles).
//   2. 16 rows of x a block: each 16-row band copied the whole weight
//      through shared memory again (~740 MB of L2 reads for 16.8 MB of
//      weight at M = 700), with x restaged as f32 and its row sums redone
//      in every chunk.  Here a band is 128 rows: the weight is read once a
//      band; x is staged once a step as bf16, and Σx is taken once a block
//      from the same A fragments, by one more mma a tile against a B of
//      ones (bf16 1.0), in the two warps of the first N column.
//   3. Nothing overlapped: load → barrier → dot → barrier.  Here K runs in
//      steps of 64: the bf16 x tile (128 × 64) and the uint8 weight tile
//      (128 × 64) come by cp.async into a ring of kMmaStages stages, two
//      steps' copies in flight during the current step's products; two
//      blocks an SM (launch bounds: 128 registers a thread; 97 KB of
//      shared memory a block), so that one block's conversion and barriers
//      overlap the other's products.
// Each weight byte becomes an exact bf16 once a stage, by one PRMT and one
// FADD (gram_byte) and half a PRMT to pack, into a bf16 tile in shared
// memory that ldmatrix reads, as it reads x.  (B fed to registers straight
// from the uint8 stage saves the tile and a barrier, but each byte is then
// converted by both warps along M, and at 128 registers it spilled: slower
// at every main-path shape but one, PERF.md.)  Rows past M
// or N and columns past K are zero-filled by the copy (src-size 0), never
// read.  One split writes through the affine epilogue (qmoe::affine) in
// registers; several write raw sums to the fixed-order split-K workspace
// (dequant_plan splits K only where the tiles leave SMs idle).  Two calls
// give the same bits.
constexpr int kMmaThreads = 256;
constexpr int kMmaBM = 128;               // rows of x a block
constexpr int kMmaBN = 128;               // weight rows (output columns)
constexpr int kStepK = 64;                // K columns a stage
constexpr int kMmaStages = 3;             // the cp.async ring
constexpr int kMmaBlocksPerSM = 2;        // launch bounds: registers a thread
constexpr int kLdX = kStepK + 8;          // bf16 a staged x row (144 bytes)
constexpr int kXStageBytes = kMmaBM * kLdX * 2;
constexpr int kWStageBytes = kMmaBN * kStepK;      // rows 64 bytes apart
constexpr int kStageBytes = kXStageBytes + kWStageBytes;
constexpr int kBTileBytes = kMmaBN * kLdX * 2;   // the bf16 B tile
constexpr int kMmaSmem = kMmaStages * kStageBytes + kBTileBytes + kMmaBM * 4;

// Bytes j and j + 1 of w as one exact bf16x2 (byte j in the low half): the
// top halves of their exact f32s.
__device__ __forceinline__ uint32_t byte_pair(uint32_t w, uint32_t magic,
                                              int j) {
  return __byte_perm(__float_as_uint(qmoe::gram_byte(w, magic, j)),
                     __float_as_uint(qmoe::gram_byte(w, magic, j + 1)),
                     0x7632);
}

template <typename TOut>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSM)
dequant_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                          const uint8_t* __restrict__ wq,
                          const float* __restrict__ scale,
                          const float* __restrict__ zero,
                          TOut* __restrict__ out, float* __restrict__ part,
                          float* __restrict__ sxpart, int M, int N, int K,
                          int steps_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sumx = reinterpret_cast<float*>(smem + kMmaStages * kStageBytes +
                                         kBTileBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kMmaBN, m0 = blockIdx.y * kMmaBM;
  const int split = blockIdx.z;
  const int s0 = split * steps_per_split;
  const int steps = min(steps_per_split, (K + kStepK - 1) / kStepK - s0);
  // the row sums feed the epilogue: every block's with one split, else
  // the first stripe's, once per split
  const bool need_sumx = part == nullptr || blockIdx.x == 0;

  // this thread's copies, the same rows and columns in every step: x rows
  // rx + 32q (q < 4) at column cx, weight rows rw + 64q (q < 2) at byte cw
  const int rx = tid >> 3, cx = (tid & 7) * 8;
  const int rw = tid >> 2, cw = (tid & 3) * 16;
  const __nv_bfloat16* xsrc = x + (long long)(m0 + rx) * K + cx;
  const uint8_t* wsrc = wq + (long long)(n0 + rw) * K + cw;
  // step st of the split into stage st % kMmaStages; one copy group per
  // step, empty past the last, so that waiting for all but the newest
  // kMmaStages − 2 groups always means step st is in
  auto load = [&](int st) {
    if (st < steps) {
      unsigned char* xs = smem + (st % kMmaStages) * kStageBytes;
      unsigned char* ws = xs + kXStageBytes;
      const int k0 = (s0 + st) * kStepK;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = m0 + rx + 32 * q < M && k0 + cx < K;
        qmoe::cp_async16(xs + (rx + 32 * q) * (2 * kLdX) + 2 * cx,
                         in ? xsrc + 32LL * q * K + k0 : x, in ? 16 : 0);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool in = n0 + rw + 64 * q < N && k0 + cw < K;
        qmoe::cp_async16(ws + (rw + 64 * q) * kStepK + cw,
                         in ? wsrc + 64LL * q * K + k0 : wq, in ? 16 : 0);
      }
    }
    qmoe::cp_async_commit();
  };

  float acc[4][4][4];                    // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  // Σx of the warp's rows, by the tensor cores against a B of ones (bf16
  // 1.0 = 0x3F80): C[g][·] and C[g + 8][·] of tile i are rows 16i + g and
  // 16i + g + 8.  Taken by the warps of the first N column, where needed.
  const bool sum_rows = need_sumx && wn == 0;
  constexpr uint32_t kOnes = 0x3F803F80u;
  float sxa[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) sxa[i][v] = 0.f;
  // 0x4B000000, not known to the compiler (M ≥ 1): see gram_byte
  const uint32_t magic = 0x4B000000u | ((uint32_t)M >> 31);

  for (int st = 0; st < kMmaStages - 1; ++st) load(st);
  for (int st = 0; st < steps; ++st) {
    qmoe::cp_async_wait<kMmaStages - 2>();
    // step st is in; every warp is done with step st − 1's stage
    __syncthreads();
    load(st + kMmaStages - 1);
    const unsigned char* xs = smem + (st % kMmaStages) * kStageBytes;
    const unsigned char* ws = xs + kXStageBytes;
    // the stage widened to bf16 once, then ldmatrix in natural K order
    __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(
        smem + kMmaStages * kStageBytes);
    for (int i = tid; i < kMmaBN * 4; i += kMmaThreads) {
      const int r = i >> 2, c = (i & 3) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(ws + r * kStepK + c);
      uint4* dst = reinterpret_cast<uint4*>(bt + r * kLdX + c);
      dst[0] = make_uint4(byte_pair(v.x, magic, 0), byte_pair(v.x, magic, 2),
                          byte_pair(v.y, magic, 0), byte_pair(v.y, magic, 2));
      dst[1] = make_uint4(byte_pair(v.z, magic, 0), byte_pair(v.z, magic, 2),
                          byte_pair(v.w, magic, 0), byte_pair(v.w, magic, 2));
    }
    __syncthreads();
    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(xs);
    const int a_row = wm * 64 + (lane & 15), a_col = (lane >> 4) * 8;
    const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) << 3);
    const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kStepK; kk += 16) {
      uint32_t a[4][4], bb[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qmoe::ldmatrix_x4(a[i], xt + (a_row + i * 16) * kLdX + kk + a_col);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        qmoe::ldmatrix_x4(bb[p], bt + (b_row + p * 16) * kLdX + kk + b_col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          qmoe::mma_bf16(acc[i][j], a[i], bb[j >> 1][(j & 1) * 2],
                         bb[j >> 1][(j & 1) * 2 + 1]);
        if (sum_rows) qmoe::mma_bf16(sxa[i], a[i], kOnes, kOnes);
      }
    }
  }
  qmoe::cp_async_wait<0>();
  if (sum_rows && t == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sumx[wm * 64 + i * 16 + g] = sxa[i][0];
      sumx[wm * 64 + i * 16 + g + 8] = sxa[i][2];
    }
  __syncthreads();

  // C[g + 8h][2t + v] of tile (i, j) is y at row 64·wm + 16i + g + 8h,
  // column 32·wn + 8j + 2t + v; two neighbouring columns stored together
  // where N is even
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 64 + i * 16 + g + 8 * h, m = m0 + r;
      if (m >= M) continue;
      const float sr = need_sumx ? sumx[r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (part != nullptr) {
          float* p = part + ((long long)split * M + m) * N + n;
          if (pairs && n + 1 < N) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            if (n < N) p[0] = v0;
            if (n + 1 < N) p[1] = v1;
          }
          continue;
        }
        TOut* o = out + (long long)m * N + n;
        auto y = [&](int c, float v) {
          return qmoe::affine(__ldg(scale + n + c), __ldg(zero + n + c), v,
                              sr);
        };
        if (pairs && n + 1 < N) {
          qmoe::store2(o, y(0, v0), y(1, v1));
        } else {
          if (n < N) qmoe::store(o, y(0, v0));
          if (n + 1 < N) qmoe::store(o + 1, y(1, v1));
        }
      }
    }
  if (part != nullptr && blockIdx.x == 0 && tid < kMmaBM && m0 + tid < M)
    sxpart[(long long)split * M + m0 + tid] = sumx[tid];
}

constexpr int kMaxDevices = 64;

// Raise kern's dynamic shared memory cap to `bytes` once per device: the
// first launch on each device sets it, later launches only read a flag.
// One `ready` table per kernel instantiation (the caller's template).
inline int smem_cap_once(std::atomic<bool> (&ready)[kMaxDevices],
                         const void* kern, int bytes, int device) {
  if (device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (ready[device].load(std::memory_order_acquire)) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready[device].store(true, std::memory_order_release);
  return (int)err;
}

template <int RPT, typename TOut>
int launch(const void* x, const void* wq, const void* scale,
           const void* zero, void* out, void* part, void* sxpart, int M,
           int N, int K, int splits, int device, cudaStream_t stream) {
  constexpr int BM = 2 * RPT;
  constexpr size_t smem = (size_t)qmoe::kBN * (kKC + 4) +
                          (size_t)BM * kKC * sizeof(float) +
                          BM * sizeof(float);
  auto kern = dequant_matmul_kernel<RPT, TOut>;
  static std::atomic<bool> ready[kMaxDevices];
  int rc = smem_cap_once(ready, (const void*)kern, (int)smem, device);
  if (rc) return rc;
  int nkc = (K + kKC - 1) / kKC;
  int chunks_per_split = (nkc + splits - 1) / splits;
  dim3 grid((N + qmoe::kBN - 1) / qmoe::kBN, (M + BM - 1) / BM, splits);
  kern<<<grid, qmoe::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<TOut*>(out),
      splits > 1 ? static_cast<float*>(part) : nullptr,
      static_cast<float*>(sxpart), M, N, K, chunks_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return qmoe::launch_splitk_epilogue(
      static_cast<const float*>(part), static_cast<const float*>(sxpart),
      static_cast<const float*>(scale), static_cast<const float*>(zero), out,
      sizeof(TOut) == 2, M, N, splits, stream);
}

template <typename TOut>
int launch_decode(const void* x, const void* wq, const void* scale,
                  const void* zero, void* out, int M, int N, int K,
                  int blocks, int device, cudaStream_t stream) {
  if (M < 1 || M > kDecM || K < 16 || K % 16 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  auto kern = dequant_matmul_decode_kernel<TOut>;
  const int smem = decode_smem_bytes(K);
  if (smem > 48 * 1024) {   // past the default: the most a block may take
    static std::atomic<bool> ready[kMaxDevices];
    int rc = smem_cap_once(ready, (const void*)kern, 232448, device);
    if (rc) return rc;
  }
  kern<<<blocks, kDecWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<TOut*>(out), M, N, K);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_mma(const void* x, const void* wq, const void* scale,
               const void* zero, void* out, void* part, void* sxpart, int M,
               int N, int K, int splits, int device, cudaStream_t stream) {
  const int steps = (K + kStepK - 1) / kStepK;
  if (M < 1 || N < 1 || K < 16 || K % 16 || splits < 1 || splits > steps)
    return (int)cudaErrorInvalidValue;
  auto kern = dequant_matmul_mma_kernel<TOut>;
  static std::atomic<bool> ready[kMaxDevices];
  int rc = smem_cap_once(ready, (const void*)kern, kMmaSmem, device);
  if (rc) return rc;
  dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM, splits);
  kern<<<grid, kMmaThreads, kMmaSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<TOut*>(out),
      splits > 1 ? static_cast<float*>(part) : nullptr,
      static_cast<float*>(sxpart), M, N, K, (steps + splits - 1) / splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return qmoe::launch_splitk_epilogue(
      static_cast<const float*>(part), static_cast<const float*>(sxpart),
      static_cast<const float*>(scale), static_cast<const float*>(zero), out,
      sizeof(TOut) == 2, M, N, splits, stream);
}

}  // namespace

// C entry points, bound with ctypes.  Each returns the CUDA error code
// (0 = ok).
//
// The SIMT kernel: rpt rows of x a thread (2 or 8), K split `splits` ways
// with f32 workspaces part (splits·M·N) and sxpart (splits·M), unused when
// splits == 1.
extern "C" int qmoe_dequant_matmul(const void* x, const void* wq,
                                   const void* scale, const void* zero,
                                   void* out, void* part, void* sxpart,
                                   int out_bf16, int M, int N, int K,
                                   int splits, int rpt, int device,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // This library links its own CUDA runtime: select the tensors' device.
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
#define QMOE_ARGS x, wq, scale, zero, out, part, sxpart, M, N, K, splits, \
                  device, s
  if (rpt == 2)
    return out_bf16 ? launch<2, __nv_bfloat16>(QMOE_ARGS)
                    : launch<2, float>(QMOE_ARGS);
  if (rpt == 8)
    return out_bf16 ? launch<8, __nv_bfloat16>(QMOE_ARGS)
                    : launch<8, float>(QMOE_ARGS);
#undef QMOE_ARGS
  return (int)cudaErrorInvalidValue;
}

// The decode kernel (M ≤ 4, K % 16 == 0, wq and x on 16-byte
// boundaries): kDecRows weight rows a warp task, kDecWarps warps a block,
// `blocks` blocks; a grid with fewer warps than tasks is persistent (warps
// take every (warps in the grid)-th task).
extern "C" int qmoe_dequant_matmul_decode(const void* x, const void* wq,
                                          const void* scale,
                                          const void* zero, void* out,
                                          int out_bf16, int M, int N, int K,
                                          int blocks, int device,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return out_bf16 ? launch_decode<__nv_bfloat16>(x, wq, scale, zero, out, M,
                                                 N, K, blocks, device, s)
                  : launch_decode<float>(x, wq, scale, zero, out, M, N, K,
                                         blocks, device, s);
}

// The tensor-core kernel (K % 16 == 0, x and wq on 16-byte boundaries):
// 128 × 128 output tiles, K in `splits` runs of whole 64-column steps with
// f32 workspaces part (splits·M·N) and sxpart (splits·M), unused when
// splits == 1.
extern "C" int qmoe_dequant_matmul_mma(const void* x, const void* wq,
                                       const void* scale, const void* zero,
                                       void* out, void* part, void* sxpart,
                                       int out_bf16, int M, int N, int K,
                                       int splits, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return out_bf16 ? launch_mma<__nv_bfloat16>(x, wq, scale, zero, out, part,
                                              sxpart, M, N, K, splits,
                                              device, s)
                  : launch_mma<float>(x, wq, scale, zero, out, part, sxpart,
                                      M, N, K, splits, device, s);
}
