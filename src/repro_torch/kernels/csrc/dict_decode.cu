// Blocked dictionary decode to a dense uint8 tensor in device memory.
//
// Replaces repro/kernels/dict_decode.py::dict_decode (the TPU Pallas kernel
// _kernel, pallas_call at :58):
//
//   out[b, 4s : 4s + 4] = lut[codes[b, s]]          codes[b, s] != ESCAPE
//                       = literals[b, clip(rank, 0, cap − 1)]   otherwise
//
// with rank = (escapes before slot s in block b).  On the port's MoE main
// path it decodes MLA's wkv_b for the absorbed attention at every forward
// (the reference decodes that weight with plain jnp; this is its kernel).
//
// What bounds it on the H100: memory bytes — per slot 2 bytes of code in
// and 4 bytes out, plus the literal rows the block uses and the LUT rows
// its codes index (read through L2).  wkv_b is 512 blocks of 1024 slots,
// ~5.2 MB in all: at 3.35 TB/s that is 1.6 µs, so the kernel's time is its
// chain of dependent memory trips and the bytes it keeps in flight, not
// its instructions.
// Design:
//   * One thread block per compressed block, up to 8 warps; a
//     lane owns kLaneSlots = 4 consecutive slots of a chunk of 1024, so
//     wkv_b runs 512 blocks of 256 threads (4096 warps).  A lane reads its
//     4 codes once, as one 8-byte ld.global.nc, and keeps them in
//     registers.
//   * It counts its escapes and loads the LUT rows of its other slots
//     (__ldg, from L2) at once; a warp shuffle scan and one __syncthreads
//     over the 8 warp totals in shared memory give its first escape rank,
//     and its literal rows are gathered (__ldg) from the block's plane.
//   * A lane writes its 16 output bytes as one 16-byte store: a warp
//     writes 512 bytes contiguous, with no staging of the output.
//   * Blocks of more slots walk chunks and carry the rank; blocks whose
//     slots are not a multiple of 4, or whose codes do not start on a
//     16-byte boundary, take the scalar path (kVec false: 2-byte code loads
//     and 4-byte stores, the same work split).
// Two dependent device-memory trips (codes, then literal rows) and the
// stores — where the old design (a warp per block through the fused
// kernels' decode_block, four serial steps, a staged copy-out) took six or
// more.  The launch shape is the wrapper's (dict_decode.launch_shape): any
// multiple of 32 threads up to kMaxWarps warps decodes a block correctly,
// since a chunk is the block's lanes × kLaneSlots slots.  kLaneSlots and
// kMaxWarps are the choices tools/profile_decode.py --model k4 times
// against their alternatives; two thread blocks per compressed block,
// literal rows staged in shared memory or prefetched into L2, and
// persistent grids measured no faster on the H100 (PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kEscape = 0xFFFFu;
constexpr int kLaneSlots = 4;      // slots a lane owns in a chunk
constexpr int kMaxWarps = 8;       // warps a thread block (a chunk: 1024)

static_assert(kLaneSlots == 2 || kLaneSlots % 4 == 0, "vector widths");

// n consecutive words at p, loaded (ld.global.nc) or stored with the
// widest vectors: p is 16-byte aligned for n ≥ 4, 8-byte for n = 2.
template <int n>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p,
                                           uint32_t* w) {
  if constexpr (n >= 4) {
#pragma unroll
    for (int q = 0; q < n / 4; ++q) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else if constexpr (n == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = __ldg(p);
  }
}

template <int n>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ p,
                                            const uint32_t* w) {
  if constexpr (n >= 4) {
#pragma unroll
    for (int q = 0; q < n / 4; ++q)
      reinterpret_cast<uint4*>(p)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// A lane's codes, one per slot (slot u of the lane's run at c[u]); `mine`
// slots are real, the rest read as 0 (not an escape).
template <bool kVec>
__device__ __forceinline__ void load_codes(const uint16_t* __restrict__ p,
                                           int mine, uint32_t* c) {
  if constexpr (kVec) {
    uint32_t w[kLaneSlots / 2];
    if (mine == 0) {
#pragma unroll
      for (int i = 0; i < kLaneSlots / 2; ++i) w[i] = 0u;
    } else {
      load_words<kLaneSlots / 2>(reinterpret_cast<const uint32_t*>(p), w);
    }
#pragma unroll
    for (int i = 0; i < kLaneSlots / 2; ++i) {
      c[2 * i] = w[i] & 0xFFFFu;
      c[2 * i + 1] = w[i] >> 16;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kLaneSlots; ++u) c[u] = u < mine ? __ldg(p + u) : 0u;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_grams(uint32_t* __restrict__ p,
                                            int mine, const uint32_t* g) {
  if constexpr (kVec) {
    if (mine) store_words<kLaneSlots>(p, g);
  } else {
#pragma unroll
    for (int u = 0; u < kLaneSlots; ++u)
      if (u < mine) p[u] = g[u];
  }
}

// One thread block per compressed block.  blockDim.x is a multiple of 32,
// at most kMaxWarps warps; every thread walks the same chunks, so the
// barriers are uniform.
template <bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
dict_decode_kernel(const uint16_t* __restrict__ codes,
                   const uint32_t* __restrict__ lits,
                   const uint32_t* __restrict__ lut,
                   uint32_t* __restrict__ out, int slots, int cap) {
  __shared__ int warp_esc[kMaxWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int chunk = nthreads * kLaneSlots;
  const long long blk = blockIdx.x;
  const uint16_t* bc = codes + blk * slots;
  const uint32_t* bl = lits + blk * cap;
  uint32_t* bo = out + blk * slots;
  int base = 0;
  for (int c0 = 0; c0 < slots; c0 += chunk) {
    const int s0 = c0 + tid * kLaneSlots;
    const int mine = max(0, min(kLaneSlots, slots - s0));
    uint32_t c[kLaneSlots], gram[kLaneSlots];
    load_codes<kVec>(bc + s0, mine, c);
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kLaneSlots; ++u) {
      const bool esc = u < mine && c[u] == kEscape;
      cnt += esc;
      if (u < mine && !esc) gram[u] = __ldg(lut + c[u]);
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_esc[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int e = warp_esc[w];
      before += w < warp ? e : 0;
      total += e;
    }
    int rank = base + before + incl - cnt;
#pragma unroll
    for (int u = 0; u < kLaneSlots; ++u) {
      if (u < mine && c[u] == kEscape) {
        gram[u] = __ldg(bl + min(rank, cap - 1));
        ++rank;
      }
    }
    store_grams<kVec>(bo + s0, mine, gram);
    base += total;
    __syncthreads();  // warp_esc is rewritten next chunk
  }
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error code (0 = ok).
// codes (nb, slots) uint16; lits (nb, cap, 4) uint8 read as one uint32 per
// gram, 4-byte aligned; lut (rows, 4) uint8, 4-byte aligned; out (nb,
// slots · 4) uint8, 16-byte aligned.  nb thread blocks of `threads`
// threads (a multiple of 32, at most kMaxWarps warps).
extern "C" int qmoe_dict_decode(const void* codes, const void* lits,
                                const void* lut, void* out, int nb,
                                int slots, int cap, int threads, int device,
                                void* stream) {
  if (nb < 1 || threads < 32 || threads > kMaxWarps * 32 || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // This library links its own CUDA runtime: select the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = slots % kLaneSlots == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const auto* c = static_cast<const uint16_t*>(codes);
  const auto* l = static_cast<const uint32_t*>(lits);
  const auto* t = static_cast<const uint32_t*>(lut);
  auto* o = static_cast<uint32_t*>(out);
  if (vec)
    dict_decode_kernel<true><<<nb, threads, 0, s>>>(c, l, t, o, slots, cap);
  else
    dict_decode_kernel<false><<<nb, threads, 0, s>>>(c, l, t, o, slots, cap);
  return (int)cudaGetLastError();
}
