// Blocked dictionary decode to a dense uint8 tensor in device memory.
//
// Replaces repro/kernels/dict_decode.py::dict_decode (the TPU Pallas kernel
// _kernel):
//
//   out[b, 4s : 4s + 4] = lut[codes[b, s]]            codes[b, s] != ESCAPE
//                       = literals[b, clip(rank, 0, cap − 1)]   otherwise
//
// with rank = (escapes before slot s in block b).  On the port's MoE main
// path it decodes MLA's wkv_b for the absorbed attention at every forward
// (the reference decodes that weight with plain jnp; this is its kernel).
//
// What bounds it on the H100: memory bytes — per slot 2 bytes of code in
// and 4 bytes out, plus the literal rows; the LUT (≤ 256 KiB) stays in L2.
// Design:
//   * One warp decodes one compressed block with the fused kernels' own
//     decode_block (matmul_common.cuh): lanes own contiguous runs of slots,
//     a shuffle scan gives each run its first escape rank, codes are read
//     16 bytes at a time, eight gram loads per lane are in flight.
//   * A lane's run is contiguous, so its stores would be 4·slots/32 bytes
//     apart across the warp.  The warp therefore decodes into shared memory
//     (rows of 128 bytes, 132 apart, so the lanes' stores fall in distinct
//     banks) and then copies each 128-byte row out with one coalesced store
//     per lane.
//   * The grid covers ceil(nb / warps) blocks and a warp past the last
//     compressed block returns at once, so a ragged block count needs no
//     padding (the reference pads to a whole chunk and slices).
#include "matmul_common.cuh"

namespace {

constexpr int kWarps = 4;          // compressed blocks per thread block
constexpr int kRow = 128;          // bytes per staged row (tk_shift = 7)
constexpr int kRowStride = kRow + 4;

__global__ void __launch_bounds__(kWarps * 32)
dict_decode_kernel(const uint16_t* __restrict__ codes,
                   const uint32_t* __restrict__ lits,
                   const uint32_t* __restrict__ lut,
                   uint32_t* __restrict__ out, long long nb, int slots,
                   int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * kWarps + warp;
  if (blk >= nb) return;                 // warp-uniform: no barrier below
  const int rows = (slots + 31) >> 5;    // 32 slots (128 bytes) per row
  unsigned char* stage = smem + (size_t)warp * rows * kRowStride;
  qmoe::decode_block(codes + blk * slots, lits + blk * cap, lut, slots, cap,
                     stage, kRowStride, 7, 0, lane);
  __syncwarp();
  uint32_t* dst = out + blk * slots;
  for (int r = 0; r < rows; ++r) {
    const int s = r * 32 + lane;
    if (s < slots)
      dst[s] = *reinterpret_cast<const uint32_t*>(stage + r * kRowStride +
                                                  4 * lane);
  }
}

}  // namespace

// C entry point, bound with ctypes.  Returns the CUDA error code (0 = ok).
// codes (nb, slots) uint16, 16-byte aligned; lits (nb, cap, 4) uint8 read
// as one uint32 per gram; lut (rows, 4) uint8; out (nb, slots · 4) uint8.
extern "C" int qmoe_dict_decode(const void* codes, const void* lits,
                                const void* lut, void* out, long long nb,
                                int slots, int cap, int device,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // This library links its own CUDA runtime: select the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kWarps * ((slots + 31) / 32) * kRowStride;
  err = cudaFuncSetAttribute(dict_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (nb + kWarps - 1) / kWarps;
  dict_decode_kernel<<<(unsigned)grid, kWarps * 32, smem, s>>>(
      static_cast<const uint16_t*>(codes), static_cast<const uint32_t*>(lits),
      static_cast<const uint32_t*>(lut), static_cast<uint32_t*>(out), nb,
      slots, cap);
  return (int)cudaGetLastError();
}
