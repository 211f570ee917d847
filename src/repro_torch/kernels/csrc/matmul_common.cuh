// Shared pieces of the W8A16 matmul kernels (fused_decode_matmul.cu,
// dequant_matmul.cu): the decode of one compressed block into a tile
// (K1/K3's SIMT and tensor-core kernels; the dictionary decode,
// dict_decode.cu, has its own), the weight bytes as exact f32 and bf16
// without I2F (the decode-batch kernels' tensor-core products), the bf16
// x tile, its row sums, the SIMT dot over a uint8 weight tile in shared
// memory, and the affine epilogue
//
//     y = s · (Σ_k x·q − z·Σ_k x)
//
// which both kernels must compute the same way (the TPU kernels keep their
// epilogues in sync for the same reason: dequant_matmul.py:26-27).
//
// Block layout of both files' SIMT kernels: 256 threads own 128 output
// columns (thread t -> column t % 128) in two row groups (g = t / 128); a
// thread keeps RPT rows g, g + 2, ... of one column in registers, so a
// block covers BM = 2·RPT rows × 128 columns.  K is walked in chunks; a
// chunk of the weight sits in shared memory as bytes with a row stride of
// chunk + 4, so 32 threads reading 32 rows at one k hit 32 different
// banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmoe {

constexpr int kThreads = 256;
constexpr int kBN = 128;

constexpr uint32_t kEscape = 0xFFFFu;

__device__ __forceinline__ int escapes_in(uint4 v) {
  int n = 0;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    n += ((w[i] & 0xFFFFu) == kEscape) + ((w[i] >> 16) == kEscape);
  return n;
}

// The two low bytes of w as two bf16 (the lower byte in the low half),
// exactly: 2^23 + b as an f32 minus 2^23 is b, and an integer below 256 has
// no bits below the top 16 of its f32.
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t w) {
  const float lo = __uint_as_float(0x4B000000u | (w & 0xFFu)) - 8388608.f;
  const float hi = __uint_as_float(0x4B000000u | ((w >> 8) & 0xFFu)) - 8388608.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// q = byte j of g as an exact f32: 2^23 + b as the bits 0x4B0000bb, less
// 2^23 (one PRMT and one FADD per weight, no I2F).  magic holds 0x4B000000
// in a register, so that PRMT takes its selector as the immediate.
__device__ __forceinline__ float gram_byte(uint32_t g, uint32_t magic,
                                           int j) {
  return __uint_as_float(__byte_perm(g, magic, 0x7440 + j)) - 8388608.f;
}

// Two exact small integers as f32 → one bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A decoded gram (4 weights) into a tile of bytes, or widened to 4 bf16.
__device__ __forceinline__ void store_gram(unsigned char* p, uint32_t gram) {
  *reinterpret_cast<uint32_t*>(p) = gram;
}
__device__ __forceinline__ void store_gram(__nv_bfloat16* p, uint32_t gram) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bytes_to_bf16x2(gram), bytes_to_bf16x2(gram >> 16));
}

// One decoded weight (a byte b < 256), as a byte or as an exact bf16.
__device__ __forceinline__ void store_weight(unsigned char* p, uint32_t b) {
  *p = static_cast<unsigned char>(b);
}
__device__ __forceinline__ void store_weight(__nv_bfloat16* p, uint32_t b) {
  *p = __float2bfloat16_rn(static_cast<float>(b));
}

// One warp decodes one compressed block (`slots` codes) into a row-major
// tile of rows 1 << tk_shift weights wide and qstride elements apart
// (bytes, or bf16 for the tensor-core product), starting at weight byte0
// of the block's stream; weight i of the stream lands at row i >> tk_shift,
// column i & (tile width − 1), so below 4 weights a row (tk_shift < 2) a
// gram spans 2 or 4 rows and is stored weight by weight.  A LUT row for
// codes != ESCAPE, and for an escape
// the literal row rank = (escapes before it in the block), clipped to
// [0, cap − 1] as the TPU kernels clip it.  The
// escape rank is a prefix count: lanes own contiguous runs of slots, count
// their escapes, and a shuffle scan across the warp gives each run its
// first rank — no block-wide barrier.  When a run is a whole number of
// 8-code groups (and so is the block), codes are read 16 bytes at a time;
// the block's codes must then start on a 16-byte boundary.  All 32 lanes
// of the warp must call it together.
template <typename Q>
__device__ __forceinline__ void decode_block(
    const uint16_t* __restrict__ codes, const uint32_t* __restrict__ lits,
    const uint32_t* __restrict__ lut, int slots, int cap,
    Q* __restrict__ qtile, int qstride, int tk_shift, int byte0,
    int lane) {
  const int spl = (slots + 31) >> 5;
  const int s0 = min(lane * spl, slots), s1 = min(s0 + spl, slots);
  const bool vec = (spl & 7) == 0 && (slots & 7) == 0;
  int cnt = 0;
  if (vec) {
    for (int s = s0; s < s1; s += 8)
      cnt += escapes_in(*reinterpret_cast<const uint4*>(codes + s));
  } else {
    for (int s = s0; s < s1; ++s) cnt += (codes[s] == kEscape);
  }
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  int rank = incl - cnt;  // escapes in this block before slot s0
  const int tk_mask = (1 << tk_shift) - 1;
  // Eight independent gram loads in flight per lane before any store.
  for (int s = s0; s < s1; s += 8) {
    uint32_t c[8];
    if (vec) {
      uint4 v = *reinterpret_cast<const uint4*>(codes + s);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[2 * i] = w[i] & 0xFFFFu;
        c[2 * i + 1] = w[i] >> 16;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = s + u < s1 ? codes[s + u] : 0u;
    }
    uint32_t gram[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s + u < s1) {
        const uint32_t* src = lut + c[u];
        if (c[u] == kEscape) {
          src = lits + min(max(rank, 0), cap - 1);
          ++rank;
        }
        gram[u] = __ldg(src);
      }
    }
    if (tk_shift >= 2) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s + u < s1) {
          int p = byte0 + 4 * (s + u);
          store_gram(qtile + (p >> tk_shift) * qstride + (p & tk_mask),
                     gram[u]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s + u < s1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int p = byte0 + 4 * (s + u) + j;
            store_weight(qtile + (p >> tk_shift) * qstride + (p & tk_mask),
                         (gram[u] >> (8 * j)) & 0xFFu);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Two neighbouring outputs at once (p on a two-element boundary).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// y = s·(acc − sumx·z), every step rounded on its own.  nvcc would contract
// the plain expression into an FMA, which rounds once where the plain
// PyTorch version rounds twice; the _rn intrinsics are never contracted.
__device__ __forceinline__ float affine(float s, float z, float acc,
                                        float sumx) {
  return __fmul_rn(s, __fsub_rn(acc, __fmul_rn(sumx, z)));
}

// xs[r][c] = x[m0 + r][k0 + c] as f32 for r < bm, c < kc4; zero outside
// M rows and the kc real columns (kc4 = kc rounded up to 4).
__device__ __forceinline__ void load_x_tile(
    const __nv_bfloat16* __restrict__ x, int M, int K, int m0, int k0,
    int kc, int kc4, int bm, int xstride, float* __restrict__ xs) {
  for (int i = threadIdx.x; i < bm * kc4; i += kThreads) {
    int r = i / kc4, c = i - r * kc4;
    int m = m0 + r;
    float v = 0.f;
    if (m < M && c < kc) v = __bfloat162float(x[(long long)m * K + k0 + c]);
    xs[r * xstride + c] = v;
  }
}

// sumx[r] += Σ_c xs[r][c], one warp per row.
__device__ __forceinline__ void add_row_sums(const float* __restrict__ xs,
                                             int bm, int kc4, int xstride,
                                             float* __restrict__ sumx) {
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < bm; r += kThreads / 32) {
    float s = 0.f;
    for (int c = lane; c < kc4; c += 32) s += xs[r * xstride + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sumx[r] += s;
  }
}

// acc[i] += Σ_k xs[g + 2i][k] · qrow[k] over one chunk of kc4 columns.
template <int RPT>
__device__ __forceinline__ void dot_chunk(const unsigned char* __restrict__ qrow,
                                          const float* __restrict__ xs,
                                          int xstride, int kc4, int g,
                                          float (&acc)[RPT]) {
  for (int k = 0; k < kc4; k += 4) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(qrow + k);
    float q0 = (float)(w & 0xFFu), q1 = (float)((w >> 8) & 0xFFu);
    float q2 = (float)((w >> 16) & 0xFFu), q3 = (float)(w >> 24);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float4 xv = *reinterpret_cast<const float4*>(xs + (g + 2 * i) * xstride + k);
      acc[i] = fmaf(xv.x, q0, acc[i]);
      acc[i] = fmaf(xv.y, q1, acc[i]);
      acc[i] = fmaf(xv.z, q2, acc[i]);
      acc[i] = fmaf(xv.w, q3, acc[i]);
    }
  }
}

// Finish a block: the affine epilogue straight into out when the block
// saw all of K (part == nullptr), else this split's raw sums into the
// workspace for splitk_epilogue.
template <int RPT, typename TOut>
__device__ __forceinline__ void finish_block(
    const float (&acc)[RPT], const float* __restrict__ sumx,
    const float* __restrict__ scale, const float* __restrict__ zero,
    TOut* __restrict__ out, float* __restrict__ part,
    float* __restrict__ sxpart, int M, int N, int m0, int col, int g,
    long long split) {
  const int bm = 2 * RPT;
  if (part == nullptr) {
    if (col < N) {
      float s = scale[col], z = zero[col];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        int m = m0 + g + 2 * i;
        if (m < M) store(out + (long long)m * N + col,
                         affine(s, z, acc[i], sumx[g + 2 * i]));
      }
    }
    return;
  }
  if (col < N) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      int m = m0 + g + 2 * i;
      if (m < M) part[(split * M + m) * N + col] = acc[i];
    }
  }
  const int t = threadIdx.x;
  if (blockIdx.x == 0 && t < bm && m0 + t < M)
    sxpart[split * M + m0 + t] = sumx[t];
}

// Sum the split-K partials in split order, then the affine epilogue.  E
// independent (M, N) products (the experts of a grouped launch) lie one
// after another in out, scale/zero (N each) and the workspaces.
template <typename TOut>
__global__ void splitk_epilogue(const float* __restrict__ part,
                                const float* __restrict__ sxpart,
                                const float* __restrict__ scale,
                                const float* __restrict__ zero,
                                TOut* __restrict__ out, int M, int N,
                                int splits, int E) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn * E) return;
  const long long e = E == 1 ? 0 : i / mn, r = i - e * mn;
  int m = (int)(r / N), n = (int)(r - (long long)m * N);
  const float* pe = part + e * splits * mn;
  const float* se = sxpart + e * splits * M;
  float acc = 0.f, sx = 0.f;
  for (int s = 0; s < splits; ++s) {
    acc += pe[((long long)s * M + m) * N + n];
    sx += se[(long long)s * M + m];
  }
  store(out + i, affine(scale[e * N + n], zero[e * N + n], acc, sx));
}

inline int launch_splitk_epilogue(const float* part, const float* sxpart,
                                  const float* scale, const float* zero,
                                  void* out, int out_bf16, int M, int N,
                                  int splits, cudaStream_t stream,
                                  int E = 1) {
  long long total = (long long)M * N * E;
  int blocks = (int)((total + 255) / 256);
  if (out_bf16)
    splitk_epilogue<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        part, sxpart, scale, zero, static_cast<__nv_bfloat16*>(out), M, N,
        splits, E);
  else
    splitk_epilogue<float><<<blocks, 256, 0, stream>>>(
        part, sxpart, scale, zero, static_cast<float*>(out), M, N, splits,
        E);
  return (int)cudaGetLastError();
}

}  // namespace qmoe
