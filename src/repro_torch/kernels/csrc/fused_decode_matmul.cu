// Fused decode -> dequant -> matmul over tile-major compressed planes.
//
// Replaces two TPU Pallas kernels of repro/kernels/fused_decode_matmul.py:
//   * K1 fused_decode_matmul (_kernel, _decode_tile, _accumulate), G = 1
//     planes;
//   * K3 grouped_fused_decode_matmul (_grouped_kernel): the same product for
//     every expert of a stacked MoE weight in one launch, grid
//     (N/128, M/BM, E · splits).
//     The device code is K1's; a block finds its expert from blockIdx.z and
//     offsets x, planes, scale/zero and output by per-expert strides (the
//     LUT is shared).  At MoE decode E · N/128 blocks (704 or 1024 for
//     DeepSeek-V2-Lite) already fill the 132 SMs, so K is not split there.
//
//   y[m, n] = s[n] · (Σ_k bf16(x[m, k]) · q[n, k] − z[n] · Σ_k bf16(x[m, k]))
//
// with q decoded in shared memory from the blocks of each (tile_n, tile_k)
// weight tile: a LUT row for codes != ESCAPE, and for escapes the literal
// row rank = (escapes before it in the block), clipped to [0, cap − 1] as
// _decode_tile clips it.  The decoded weight never reaches device memory.
//
// What bounds it on the H100: at decode (M = batch, 1–8) it reads the
// compressed planes once — 2 bytes of code per 4 weights plus the literal
// rows — so it is bound by memory bytes, not operations.  Design:
//   * Blocks own 128 output columns.  At decode-sized M a block holds
//     BM = 4 or 16 rows and the product runs on the SIMT cores, so M is
//     not padded to 128 rows; at prefill-sized M it holds 128 rows and the
//     product runs on the tensor cores (WMMA, bf16 in, f32 sums).
//   * The TPU grid carries its accumulator across K steps; blocks here run
//     in no order, so a block loops over its K tiles itself.  To put more
//     than N/128 blocks on the card, K tiles are split over gridDim.z and
//     a second kernel sums the splits in a fixed order before the
//     epilogue (deterministic; exact for integer-valued inputs).
//   * The LUT (up to 65 536 rows × 4 B = 256 KiB) does not fit in shared
//     memory, so rows are read through the read-only cache (__ldg); it
//     stays in the 50 MB L2.
//   * The escape rank is a prefix count within a compressed block: one
//     warp per block, each lane a contiguous run of slots, a shuffle scan
//     across lanes — no block-wide barrier inside the decode.
//   * On the H100 the decode loop, more than the bytes or the product,
//     fills a block's time (PERF.md), so it is kept short per slot: codes
//     are read 16 bytes at a time, a slot's place in the tile is a shift
//     and a mask (tile_k is a power of two), and eight gram loads per lane
//     are in flight before their stores.
#include <mma.h>

#include "matmul_common.cuh"

namespace {

using qmoe::decode_block;

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
                           int bpt, int tiles_per_split, Expert ex) {
  constexpr int BM = 2 * RPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qstride = tile_k + 4;
  unsigned char* qs = smem;                                     // 128 × qstride
  float* xs = reinterpret_cast<float*>(smem + qmoe::kBN * qstride);  // BM × tile_k
  float* sumx = xs + BM * tile_k;                                // BM

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
      long long blk = ((long long)(j0 + jj) * nkt + kt) * bpt + bb;
      decode_block(codes + blk * slots, lits + blk * cap, lut, slots, cap,
                   qs + jj * tile_n * qstride, qstride, tk_shift,
                   bb * block_bytes, lane);
    }
    qmoe::load_x_tile(x, M, K, m0, kt * tile_k, tile_k, tile_k, BM, tile_k,
                      xs);
    __syncthreads();
    qmoe::add_row_sums(xs, BM, tile_k, tile_k, sumx);
    qmoe::dot_chunk<RPT>(qs + n * qstride, xs, tile_k, tile_k, g, acc);
    __syncthreads();
  }
  qmoe::finish_block<RPT, TOut>(acc, sumx, scale, zero, out, part, sxpart,
                                M, N, m0, blockIdx.x * qmoe::kBN + n, g,
                                split);
}

// Prefill-sized M: the same decode, with the product on the tensor cores
// (WMMA, bf16 × bf16 → f32; q ≤ 255 and bf16 x are exact in bf16, and the
// sums of integer-valued inputs stay exact in f32, so the bitwise contract
// with the plain version holds).  A block owns 128 rows × 128 columns;
// eight warps hold 2 × 4 tiles of 64 × 32 accumulators.  Each decoded
// (tile_n, tile_k) tile is widened to bf16 64 columns at a time.  Every
// 128-row band decodes the weight tile again, so taller bands mean fewer
// decodes per output.
constexpr int kMmaBM = 128;
constexpr int kSubK = 64;
constexpr int kLdB = kSubK + 8;     // bf16 per staged row (16-byte multiple)
constexpr int kLdC = qmoe::kBN + 4; // f32 per accumulator row at the end

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// Shared memory of the tensor-core kernel: the decoded tile, the bf16
// staging of q and x, and — past all of them, or past the f32 accumulators
// that reuse them at the end, whichever is larger — the row sums of x.
__host__ __device__ inline size_t mma_sumx_offset(int tile_k) {
  size_t staged = align128((size_t)qmoe::kBN * (tile_k + 4)) +
                  align128((size_t)qmoe::kBN * kLdB * 2) +
                  align128((size_t)kMmaBM * kLdB * 2);
  size_t accs = align128((size_t)kMmaBM * kLdC * sizeof(float));
  return staged > accs ? staged : accs;
}

template <typename TOut, bool kGrouped>
__global__ void __launch_bounds__(qmoe::kThreads)
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
                               int cap, int bpt, int tiles_per_split,
                               Expert ex) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int qstride = tile_k + 4;
  unsigned char* qs = smem;                      // 128 × qstride decoded bytes
  size_t off = align128((size_t)qmoe::kBN * qstride);
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem + off);  // 128 × kLdB
  off += align128((size_t)qmoe::kBN * kLdB * 2);
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + off);  // kMmaBM × kLdB
  float* sumx = reinterpret_cast<float*>(smem + mma_sumx_offset(tile_k));
  // kMmaBM × kLdC f32 accumulators at the end, over the dead qs/qb/xb
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;       // 2 × 4 warps of 64 × 32
  const int nkt = K / tile_k, nnt = N / tile_n;
  const int tpb = qmoe::kBN / tile_n;
  const int j0 = blockIdx.x * tpb;
  const int tcount = min(tpb, nnt - j0);
  const int m0 = blockIdx.y * kMmaBM;
  const long long split = kGrouped ? blockIdx.z % ex.splits : blockIdx.z;
  const int kt0 = (int)split * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, nkt);
  const int block_bytes = 4 * slots;
  const int tk_shift = __ffs(tile_k) - 1;   // tile_k is a power of two
  if (kGrouped)
    to_expert(blockIdx.z / ex.splits, ex, M, N, K, x, codes, lits, scale,
              zero, out, part, sxpart);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  if (tid < kMmaBM) sumx[tid] = 0.f;
  __syncthreads();

  for (int kt = kt0; kt < kt1; ++kt) {
    for (int idx = warp; idx < tcount * bpt; idx += qmoe::kThreads / 32) {
      int jj = idx / bpt, bb = idx - jj * bpt;
      long long blk = ((long long)(j0 + jj) * nkt + kt) * bpt + bb;
      decode_block(codes + blk * slots, lits + blk * cap, lut, slots, cap,
                   qs + jj * tile_n * qstride, qstride, tk_shift,
                   bb * block_bytes, lane);
    }
    __syncthreads();
    for (int sub = 0; sub < tile_k; sub += kSubK) {
      // widen 128 × 64 decoded bytes to bf16, 4 per thread-step
      for (int i = tid; i < qmoe::kBN * (kSubK / 4); i += qmoe::kThreads) {
        int r = i / (kSubK / 4), c = (i - r * (kSubK / 4)) * 4;
        uint32_t w = *reinterpret_cast<const uint32_t*>(qs + r * qstride + sub + c);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(qb + r * kLdB + c);
        dst[0] = __floats2bfloat162_rn((float)(w & 0xFFu),
                                       (float)((w >> 8) & 0xFFu));
        dst[1] = __floats2bfloat162_rn((float)((w >> 16) & 0xFFu),
                                       (float)(w >> 24));
      }
      // stage 128 rows × 64 columns of x, 8 bf16 (16 bytes) per load; the
      // wrapper passes x 16-byte aligned and K is a multiple of 64 here
      const long long xcol = (long long)kt * tile_k + sub;
      for (int i = tid; i < kMmaBM * (kSubK / 8); i += qmoe::kThreads) {
        int r = i / (kSubK / 8), c = (i - r * (kSubK / 8)) * 8;
        int m = m0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < M)
          v = *reinterpret_cast<const uint4*>(x + (long long)m * K + xcol + c);
        *reinterpret_cast<uint4*>(xb + r * kLdB + c) = v;
      }
      __syncthreads();
      for (int r = warp; r < kMmaBM; r += qmoe::kThreads / 32) {
        float sx = __bfloat162float(xb[r * kLdB + lane]) +
                   __bfloat162float(xb[r * kLdB + lane + 32]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sx += __shfl_xor_sync(0xffffffffu, sx, o);
        if (lane == 0) sumx[r] += sx;
      }
#pragma unroll
      for (int kk = 0; kk < kSubK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(a[i], xb + (wm * 64 + i * 16) * kLdB + kk, kLdB);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], qb + (wn * 32 + j * 16) * kLdB + kk, kLdB);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 64 + i * 16) * kLdC + wn * 32 + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  const int n0 = blockIdx.x * qmoe::kBN;
  for (int i = tid; i < kMmaBM * qmoe::kBN; i += qmoe::kThreads) {
    int r = i / qmoe::kBN, c = i - r * qmoe::kBN;
    int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float a = cs[r * kLdC + c];
    if (part == nullptr)
      qmoe::store(out + (long long)m * N + n,
                  qmoe::affine(scale[n], zero[n], a, sumx[r]));
    else
      part[(split * M + m) * N + n] = a;
  }
  if (part != nullptr && blockIdx.x == 0 && tid < kMmaBM && m0 + tid < M)
    sxpart[split * M + m0 + tid] = sumx[tid];
}

template <typename Kern, typename TOut>
int launch_kernel(Kern kern, int bm, size_t smem, const void* x,
                  const void* codes, const void* lits, const void* lut,
                  const void* scale, const void* zero, TOut* out, void* part,
                  void* sxpart, int out_bf16, int M, int N, int K, int tile_n,
                  int tile_k, int slots, int cap, int bpt, int splits, int E,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int nkt = K / tile_k;
  int tiles_per_split = (nkt + splits - 1) / splits;
  const long long nb = (long long)(N / tile_n) * nkt * bpt;
  const Expert ex = {nb * slots, nb * cap, splits};
  dim3 grid((N + qmoe::kBN - 1) / qmoe::kBN, (M + bm - 1) / bm, E * splits);
  kern<<<grid, qmoe::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint16_t*>(codes), static_cast<const uint32_t*>(lits),
      static_cast<const uint32_t*>(lut), static_cast<const float*>(scale),
      static_cast<const float*>(zero), out,
      splits > 1 ? static_cast<float*>(part) : nullptr,
      static_cast<float*>(sxpart), M, N, K, tile_n, tile_k, slots, cap, bpt,
      tiles_per_split, ex);
  err = cudaGetLastError();
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
           int tile_n, int tile_k, int slots, int cap, int bpt, int splits,
           int E, cudaStream_t stream) {
  const size_t qbytes = (size_t)qmoe::kBN * (tile_k + 4);
#define QMOE_ARGS x, codes, lits, lut, scale, zero, static_cast<TOut*>(out), \
                  part, sxpart, out_bf16, M, N, K, tile_n, tile_k, slots,    \
                  cap, bpt, splits, E, stream
  if (bm == 4)
    return launch_kernel(fused_decode_matmul_kernel<2, TOut, kGrouped>, 4,
                         qbytes + (4 * tile_k + 4) * sizeof(float), QMOE_ARGS);
  if (bm == 16)
    return launch_kernel(fused_decode_matmul_kernel<8, TOut, kGrouped>, 16,
                         qbytes + (16 * tile_k + 16) * sizeof(float),
                         QMOE_ARGS);
  if (bm == kMmaBM && tile_k % kSubK == 0)
    return launch_kernel(fused_decode_matmul_mma_kernel<TOut, kGrouped>,
                         kMmaBM,
                         mma_sumx_offset(tile_k) + kMmaBM * sizeof(float),
                         QMOE_ARGS);
#undef QMOE_ARGS
  return (int)cudaErrorInvalidValue;
}

template <typename TOut>
int launch_any(int E, int bm, const void* x, const void* codes,
               const void* lits, const void* lut, const void* scale,
               const void* zero, void* out, void* part, void* sxpart,
               int out_bf16, int M, int N, int K, int tile_n, int tile_k,
               int slots, int cap, int bpt, int splits, cudaStream_t stream) {
  if (E == 1)
    return launch<TOut, false>(bm, x, codes, lits, lut, scale, zero, out,
                               part, sxpart, out_bf16, M, N, K, tile_n,
                               tile_k, slots, cap, bpt, splits, E, stream);
  return launch<TOut, true>(bm, x, codes, lits, lut, scale, zero, out, part,
                            sxpart, out_bf16, M, N, K, tile_n, tile_k, slots,
                            cap, bpt, splits, E, stream);
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error code (0 = ok).
// E weights of one shape in one launch: x (E, M, K), planes (E, nb, slots)
// and (E, nb, cap, 4), scale/zero (E, N, 1), out (E, M, N) — K1 is E = 1,
// K3 a whole expert stack.  bm: rows per block — 4 or 16 (SIMT product) or
// 128 (tensor cores; needs tile_k % 64 == 0).  part/sxpart: f32 workspaces
// of E·splits·M·N and E·splits·M (unused when splits == 1).  The literal
// plane is read as one uint32 per gram (S = 4).
extern "C" int qmoe_fused_decode_matmul(
    const void* x, const void* codes, const void* lits, const void* lut,
    const void* scale, const void* zero, void* out, void* part, void* sxpart,
    int out_bf16, int E, int M, int N, int K, int tile_n, int tile_k,
    int slots, int cap, int bpt, int splits, int bm, int device,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // This library links its own CUDA runtime: select the tensors' device.
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (out_bf16)
    return launch_any<__nv_bfloat16>(E, bm, x, codes, lits, lut, scale, zero,
                                     out, part, sxpart, 1, M, N, K, tile_n,
                                     tile_k, slots, cap, bpt, splits, s);
  return launch_any<float>(E, bm, x, codes, lits, lut, scale, zero, out,
                           part, sxpart, 0, M, N, K, tile_n, tile_k, slots,
                           cap, bpt, splits, s);
}
