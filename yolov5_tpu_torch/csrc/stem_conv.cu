// K2: the BN-folded yolov5 stem, y = SiLU(conv6x6/s2/pad2(x, w) + b), as an
// implicit GEMM on the H100's tensor cores.
//
// Replaces yolov5_tpu/ops/stem_pallas.py::stem_conv and ::stem_conv_mxuT
// (one function, two TPU layouts of its output transpose). It keeps the TPU
// kernel's space-to-depth formulation (stem_pallas.py:10-13): with the 2x2
// stride phases folded into channels, the 6x6/s2 conv is a 3x3/s1 conv over
// 12 channels, c = sy*6 + sx*3 + ci, padded here to 16 so that each of the
// 9 (dy, dx) taps is one k16 step of mma.m16n8k16. The TPU kernel's row
// packing and identity-matmul transpose exist to fill the 128x128 MXU and
// are not carried over. Any even H and W, c2 in {16, 32, 48, 64, 80}.
//
// In:  x (B, H, W, 3) NHWC, f32 or bf16; w_hi, w_lo (9, 16, c2) bf16, the
//      packed weights of ops/stem.py::pack_stem_weights (w_lo = w - w_hi, or
//      null when w is bf16 already); b (c2,) f32.
// Out: y (B, H/2, W/2, c2) NHWC in x's dtype: the storage of a channels_last
//      (B, c2, H/2, W/2) tensor, so the next layer reads it with no relayout.
// Products in bf16 with f32 accumulation; bias and SiLU in f32, then one
// rounding. bf16 x: x*w_hi (+ x*w_lo). f32 x is split as x_hi + x_lo in bf16
// (three products: x_hi*w_hi + x_lo*w_hi + x_hi*w_lo), which keeps f32
// within atol 1e-5, rtol 1e-4 of the f32 convolution.
//
// What bounds it on the H100: bytes. At B=32, 640 px, bf16, c2=32 it reads
// 78.6 MB and writes 209.7 MB: 0.086 ms at 3.35 TB/s. The products, 30 GFLOP
// with the 16-channel padding, take 0.03 ms at the bf16 peak.
//
// What the design does about it:
//   - a persistent grid (4 blocks of 128 threads an SM for c2 <= 32) walks
//     2x64-pixel output tiles; each tile's (2+2) x (64+2) space-to-depth
//     window is copied by cp.async into a ring of kStages buffers, so the
//     next tile's load overlaps this tile's products. One raw pixel pair of
//     one row is 12 contiguous bytes in both layouts, so the copy is three
//     4-byte pieces and the space-to-depth happens in it, never as a pass
//     over device memory; a thread takes a whole window position, paying
//     the index arithmetic once for its six pieces;
//   - each warp computes 32 pixels x c2 channels with ldmatrix + mma.sync;
//     for c2 <= 32 and bf16 weights the B fragments stay in registers for
//     the whole run. The two 16-byte halves of each position's 32 bytes are
//     swizzled so ldmatrix reads without bank conflicts at any tap offset;
//   - bias and SiLU on the accumulator fragments, one rounding, then the
//     warp's 32 pixels x c2 go through shared memory so that every store is
//     16 bytes a lane over whole 128-byte lines of the NHWC output.
// What still holds it back (PERF.md, Findings): copy, products and epilogue
// barely overlap. The epilogue's two MUFU operations an output (exp and
// reciprocal, 16 a clock per SM) and the output stream cost about as much
// as the copies and the products together; tanh.approx would halve the MUFU
// work, at 2^-11 relative error against the exp path's ~2^-21.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 64;  // output columns per tile
constexpr int kTY = 2;   // output rows per tile
constexpr int kStages = 2;  // the ring of window buffers
constexpr int kWarps = kTY * kTX / 32;  // a warp takes 32 pixels of one row
constexpr int kThreads = 32 * kWarps;
constexpr int kSX = kTX + 2;  // space-to-depth window
constexpr int kSY = kTY + 2;
constexpr int kPos = kSX * kSY;
constexpr int kBufBytes = kPos * 32;  // 16 bf16 channels a position
constexpr int kRawF32Bytes = kPos * 12 * 4;
constexpr int kTaps = 9;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 32-bit word k (channels 2k, 2k+1) of window position
// (ly, lx). The 16-byte halves swap when bit 2 of lx is set, so 8
// consecutive positions of one half fall in 8 distinct bank groups.
__device__ __forceinline__ int word_off(int ly, int lx, int k) {
  return (ly * kSX + lx) * 32 + ((((k >> 2) ^ (lx >> 2)) & 1) << 4) + ((k & 3) << 2);
}

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
               "r"(valid ? N : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most kStages - 1 groups are in flight: the current tile's has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.f + __expf(-z)); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Copy tile (b, oy0, ox0)'s space-to-depth window into `buf`: straight into
// the bf16 layout for bf16 x, as raw f32 [pos][12] for f32 x. A thread takes
// a whole window position (two raw rows of one pixel pair), so the index
// arithmetic is paid once for its six pieces. Positions outside the image
// are zero-filled.
template <typename T>
__device__ __forceinline__ void issue_tile(const T* __restrict__ x, uint8_t* buf, int b, int oy0,
                                           int ox0, int H, int W) {
  const uint32_t base = smem_addr(buf);
  const long long row = 3LL * W;  // elements of one raw row
  for (int pos = threadIdx.x; pos < kPos; pos += kThreads) {
    const int ly = pos / kSX, lx = pos - ly * kSX;
    const int X = ox0 + lx, iy = 2 * (oy0 + ly) - 2;
    const bool x_in = X >= 1 && 2 * X <= W;
    const long long off = (static_cast<long long>(b) * H + iy) * row + 6LL * (X - 1);
#pragma unroll
    for (int sy = 0; sy < 2; ++sy) {
      const bool valid = x_in && iy + sy >= 0 && iy + sy < H;
      const T* src = valid ? x + off + sy * row : x;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if constexpr (sizeof(T) == 2) {
          const int k = sy * 3 + j;
          cp_async<4>(base + pos * 32 + ((((k >> 2) ^ (lx >> 2)) & 1) << 4) + ((k & 3) << 2),
                      valid ? src + 2 * j : x, valid);
        } else {
          cp_async<8>(base + (pos * 12 + sy * 6 + 2 * j) * 4, valid ? src + 2 * j : x, valid);
        }
      }
    }
  }
}

// f32 window -> its bf16 high and low parts, in the bf16 layout.
__device__ __forceinline__ void split_f32(const float* raw, uint8_t* hi, uint8_t* lo) {
  for (int it = threadIdx.x; it < kPos * 6; it += kThreads) {
    const int pos = it / 6, k = it % 6;
    const float2 v = *reinterpret_cast<const float2*>(raw + pos * 12 + 2 * k);
    const __nv_bfloat16 h0 = __float2bfloat16_rn(v.x), h1 = __float2bfloat16_rn(v.y);
    const __nv_bfloat16 l0 = __float2bfloat16_rn(v.x - __bfloat162float(h0));
    const __nv_bfloat16 l1 = __float2bfloat16_rn(v.y - __bfloat162float(h1));
    const int off = word_off(pos / kSX, pos % kSX, k);
    *reinterpret_cast<uint32_t*>(hi + off) = pack_bf16x2(h0, h1);
    *reinterpret_cast<uint32_t*>(lo + off) = pack_bf16x2(l0, l1);
  }
}

// NT n-tiles of 8 channels per warp pass; c2 = 8 * NT * NCH.
template <int C2>
struct Split {
  static constexpr int NT_ALL = C2 / 8;
  static constexpr int NT = NT_ALL <= 4 ? NT_ALL : (NT_ALL % 4 == 0 ? 4 : NT_ALL / 2);
  static constexpr int NCH = NT_ALL / NT;
};

template <int C2, typename T>
__global__ void __launch_bounds__(kThreads, C2 <= 32 ? 4 : 1)
stem_conv_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w_hi,
                 const __nv_bfloat16* __restrict__ w_lo, const float* __restrict__ bias,
                 T* __restrict__ y, int B, int H, int W) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NT = Split<C2>::NT, NCH = Split<C2>::NCH;
  constexpr int kStage = kF32 ? kRawF32Bytes : kBufBytes;
  constexpr int kOutRow = C2 * sizeof(T) + 16;  // staging row, padded against bank conflicts
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = smem;                                    // kStages x kStage
  uint8_t* split = stage + kStages * kStage;                // f32: hi, lo bf16 windows
  uint2* wfrag = reinterpret_cast<uint2*>(split + (kF32 ? 2 * kBufBytes : 0));
  float* bias_s = reinterpret_cast<float*>(wfrag + 2 * NCH * kTaps * NT * 32);
  uint8_t* out_s = reinterpret_cast<uint8_t*>(bias_s + C2);  // kWarps x 32 x kOutRow

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int OH = H / 2, OW = W / 2;
  const int tiles_x = (OW + kTX - 1) / kTX, tiles_y = (OH + kTY - 1) / kTY;
  const int n_tiles = B * tiles_x * tiles_y;
  const int n_sets = w_lo != nullptr ? 2 : 1;

  // zero the windows (channels 12..15 stay zero), stage B fragments and bias
  {
    const int zero_bytes = kStages * kStage + (kF32 ? 2 * kBufBytes : 0);
    for (int i = tid; i < zero_bytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < n_sets * NCH * kTaps * NT * 32; i += kThreads) {
      const int l = i % 32, nt = (i / 32) % NT, tap = (i / (32 * NT)) % kTaps;
      const int ch = (i / (32 * NT * kTaps)) % NCH, set = i / (32 * NT * kTaps * NCH);
      const __nv_bfloat16* wp = (set ? w_lo : w_hi) + tap * 16 * C2;
      const int n = (ch * NT + nt) * 8 + (l >> 2), k = (l & 3) * 2;
      wfrag[i] = make_uint2(pack_bf16x2(wp[k * C2 + n], wp[(k + 1) * C2 + n]),
                            pack_bf16x2(wp[(k + 8) * C2 + n], wp[(k + 9) * C2 + n]));
    }
    for (int i = tid; i < C2; i += kThreads) bias_s[i] = bias[i];
  }
  __syncthreads();

  auto tile_coords = [&](int t, int& b, int& oy0, int& ox0) {
    ox0 = (t % tiles_x) * kTX;
    t /= tiles_x;
    oy0 = (t % tiles_y) * kTY;
    b = t / tiles_y;
  };

  // this warp's 32 pixels: output row wr of the tile, columns wc..wc+31
  const int wr = warp / (kTX / 32), wc = (warp % (kTX / 32)) * 32;
  // ldmatrix: lane gives the address of row (lane & 7) of matrix (lane >> 3)
  const int lm_pix = ((lane >> 3) & 1) * 8 + (lane & 7), lm_half = lane >> 4;
  uint8_t* my_out = out_s + warp * 32 * kOutRow;

  uint2 bf[kTaps][NT];
  auto load_b = [&](int set, int ch) {
    const uint2* src = wfrag + ((set * NCH + ch) * kTaps) * NT * 32 + lane;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) bf[tap][nt] = src[(tap * NT + nt) * 32];
  };
  const bool resident = NCH == 1 && n_sets == 1;
  if (resident) load_b(0, 0);

  float acc[2][NT][4];
  auto products = [&](const uint8_t* buf) {
    const uint32_t base = smem_addr(buf);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int lx = wc + mt * 16 + lm_pix + dx;
        ldmatrix_x4(base + (wr + dy) * kSX * 32 + lx * 32 + (((lm_half ^ (lx >> 2)) & 1) << 4),
                    a[mt]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], bf[tap][nt]);
    }
  };

  int t = blockIdx.x;
  for (int k = 0; k < kStages - 1; ++k) {  // fill the ring but one buffer
    const int tk = t + k * gridDim.x;
    if (tk < n_tiles) {
      int b, oy0, ox0;
      tile_coords(tk, b, oy0, ox0);
      issue_tile(x, stage + k * kStage, b, oy0, ox0, H, W);
    }
    cp_async_commit();
  }
  for (int k = 0; t < n_tiles; t += gridDim.x, ++k) {
    const int tn = t + (kStages - 1) * gridDim.x;
    if (tn < n_tiles) {  // prefetch kStages - 1 tiles ahead, into the buffer freed last
      int b, oy0, ox0;
      tile_coords(tn, b, oy0, ox0);
      issue_tile(x, stage + ((k + kStages - 1) % kStages) * kStage, b, oy0, ox0, H, W);
    }
    cp_async_commit();
    cp_async_wait_ring();
    __syncthreads();
    uint8_t* cur = stage + (k % kStages) * kStage;
    if constexpr (kF32) {
      split_f32(reinterpret_cast<const float*>(cur), split, split + kBufBytes);
      __syncthreads();
    }
    const uint8_t* a_hi = kF32 ? split : cur;

    int b, oy0, ox0;
    tile_coords(t, b, oy0, ox0);
#pragma unroll 1
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll 1
      for (int set = 0; set < n_sets; ++set) {
        if (!resident) load_b(set, ch);
        products(a_hi);
        if (kF32 && set == 0) products(split + kBufBytes);  // x_lo * w_hi
      }
      // bias + SiLU on the fragments, one rounding, into the warp's staging rows
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = (ch * NT + nt) * 8 + (lane & 3) * 2;
        const float b0 = bias_s[n], b1 = bias_s[n + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int p = mt * 16 + (lane >> 2);
          T* r0 = reinterpret_cast<T*>(my_out + p * kOutRow) + n;
          T* r1 = reinterpret_cast<T*>(my_out + (p + 8) * kOutRow) + n;
          store2(r0, silu(acc[mt][nt][0] + b0), silu(acc[mt][nt][1] + b1));
          store2(r1, silu(acc[mt][nt][2] + b0), silu(acc[mt][nt][3] + b1));
        }
      }
    }
    __syncwarp();
    // 32 pixels x c2 of one output row are contiguous in NHWC
    constexpr int kChunks = C2 * sizeof(T) / 16;  // 16-byte pieces a pixel
    const int oy = oy0 + wr;
    uint8_t* yrow = reinterpret_cast<uint8_t*>(y) +
                    ((static_cast<size_t>(b) * OH + oy) * OW + ox0 + wc) * (C2 * sizeof(T));
#pragma unroll
    for (int q = lane; q < 32 * kChunks; q += 32) {
      const int p = q / kChunks, c = q % kChunks;
      if (oy < OH && ox0 + wc + p < OW)
        *reinterpret_cast<uint4*>(yrow + q * 16) =
            *reinterpret_cast<const uint4*>(my_out + p * kOutRow + c * 16);
    }
    __syncwarp();
    __syncthreads();  // the buffer just read is refilled next
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int C2, typename T>
size_t smem_bytes() {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NT = Split<C2>::NT, NCH = Split<C2>::NCH;
  return kStages * (kF32 ? kRawF32Bytes : kBufBytes) + (kF32 ? 2 * kBufBytes : 0) +
         sizeof(uint2) * 2 * NCH * kTaps * NT * 32 + sizeof(float) * C2 +
         kWarps * 32 * (C2 * sizeof(T) + 16);
}

template <int C2, typename T>
int launch(const void* x, const void* w_hi, const void* w_lo, const void* b, void* y, int B,
           int H, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes<C2, T>();
  auto kernel = stem_conv_kernel<C2, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = H / 2, OW = W / 2;
  const long long tiles =
      static_cast<long long>(B) * ((OW + kTX - 1) / kTX) * ((OH + kTY - 1) / kTY);
  const int grid = static_cast<int>(tiles < static_cast<long long>(sms) * per_sm
                                        ? tiles : static_cast<long long>(sms) * per_sm);
  kernel<<<grid > 0 ? grid : 1, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w_hi),
      static_cast<const __nv_bfloat16*>(w_lo), static_cast<const float*>(b), static_cast<T*>(y),
      B, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_c2(int c2, const void* x, const void* w_hi, const void* w_lo, const void* b,
                void* y, int B, int H, int W, cudaStream_t s) {
  switch (c2) {
    case 16: return launch<16, T>(x, w_hi, w_lo, b, y, B, H, W, s);
    case 32: return launch<32, T>(x, w_hi, w_lo, b, y, B, H, W, s);
    case 48: return launch<48, T>(x, w_hi, w_lo, b, y, B, H, W, s);
    case 64: return launch<64, T>(x, w_hi, w_lo, b, y, B, H, W, s);
    case 80: return launch<80, T>(x, w_hi, w_lo, b, y, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; w_lo may be null. Returns a cudaError_t.
extern "C" int yolo_stem_conv(const void* x, const void* w_hi, const void* w_lo, const void* b,
                              void* y, int B, int H, int W, int c2, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_c2<float>(c2, x, w_hi, w_lo, b, y, B, H, W, s);
  if (dtype == 1) return dispatch_c2<__nv_bfloat16>(c2, x, w_hi, w_lo, b, y, B, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
