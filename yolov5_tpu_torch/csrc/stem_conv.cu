// K2: the BN-folded yolov5 stem, y = SiLU(conv6x6/s2/pad2(x, w) + b).
//
// Replaces yolov5_tpu/ops/stem_pallas.py::stem_conv and ::stem_conv_mxuT
// (one function, two TPU layouts of its output transpose). The TPU kernel's
// space-to-depth row packing and identity-matmul transpose exist only to
// fill the 128x128 MXU and are not carried over. The TPU kernel takes 640 px
// and 32 output channels only; this one takes any even H and W and
// c2 in {16, 32, 48, 64, 80} (yolov5 n, s, m, l, x).
//
// In:  x (B, H, W, 3) NHWC, f32 or bf16; w (6, 6, 3, c2) HWIO f32; b (c2,) f32.
// Out: y (B, H/2, W/2, c2) NHWC in x's dtype: the storage of a channels_last
//      (B, c2, H/2, W/2) tensor, so the next layer reads it with no relayout.
// Accumulation, bias and SiLU in f32, then one rounding to the output dtype
// (as _group_matmul does on the TPU).
//
// What bounds it on the H100: the floor is bytes, the 3-channel input read
// and the c2-channel output written (at B=32, 640 px, bf16, c2=32: 79 MB in
// and 210 MB out). The product itself is small (108 x c2 multiply-adds per
// output pixel) but this first version runs it on the f32 CUDA cores, where
// it costs more than the bytes; moving it to the tensor cores is later work.
//
// What the design does about it:
//   - each block stages the weights (at most 6*6*3*80*4 B = 34.5 KB) and the
//     (2*kTileY + 4) x (2*kTileX + 4) x 3 input window it needs in shared
//     memory, so every input byte is read from device memory about once;
//   - each thread computes one output pixel across all c2 channels, with c2
//     accumulators in registers and the weights read as float4 broadcasts;
//   - each thread writes its pixel's c2 channels as 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 64;  // output columns per block
constexpr int kTileY = 2;   // output rows per block
constexpr int kInX = 2 * kTileX + 4;
constexpr int kInY = 2 * kTileY + 4;
constexpr int kTaps = 6 * 6 * 3;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Eight consecutive output channels as one 16-byte store (bf16) or two (f32).
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<unsigned*>(&p);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                              pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

template <int C2, typename T>
__global__ void __launch_bounds__(kTileX * kTileY)
stem_conv_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ y, int H, int W) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [tap][C2], tap = (ky*6 + kx)*3 + ci
  float* b_s = w_s + kTaps * C2;                  // [C2]
  float* in_s = b_s + C2;                         // [kInY][kInX][3]

  const int OH = H / 2, OW = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTileY, ox0 = blockIdx.x * kTileX;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  constexpr int kThreads = kTileX * kTileY;

  for (int i = tid; i < kTaps * C2; i += kThreads) w_s[i] = w[i];
  for (int i = tid; i < C2; i += kThreads) b_s[i] = bias[i];
  // input window rows 2*oy0-2 .. 2*oy0+2*kTileY+1, zero outside the image
  const int iy0 = 2 * oy0 - 2, ix0 = 2 * ox0 - 2;
  const T* xb = x + static_cast<size_t>(b) * H * W * 3;
  for (int i = tid; i < kInY * kInX * 3; i += kThreads) {
    const int r = i / (kInX * 3);
    const int rem = i - r * (kInX * 3);  // col * 3 + ci, contiguous in x
    const int iy = iy0 + r, ix = ix0 + rem / 3;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = to_float(xb[(static_cast<size_t>(iy) * W + ix) * 3 + rem % 3]);
    in_s[i] = v;
  }
  __syncthreads();

  const int ox = ox0 + threadIdx.x, oy = oy0 + threadIdx.y;
  if (ox >= OW || oy >= OH) return;

  float acc[C2];
#pragma unroll
  for (int c = 0; c < C2; ++c) acc[c] = 0.f;

  const float* in_t = in_s + (2 * threadIdx.y * kInX + 2 * threadIdx.x) * 3;
#pragma unroll 1
  for (int ky = 0; ky < 6; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 6; ++kx) {
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        const float v = in_t[(ky * kInX + kx) * 3 + ci];
        const float4* wr = reinterpret_cast<const float4*>(w_s + ((ky * 6 + kx) * 3 + ci) * C2);
#pragma unroll
        for (int q = 0; q < C2 / 4; ++q) {
          const float4 ww = wr[q];
          acc[4 * q + 0] = fmaf(v, ww.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, ww.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, ww.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, ww.w, acc[4 * q + 3]);
        }
      }
    }
  }

  T* yp = y + ((static_cast<size_t>(b) * OH + oy) * OW + ox) * C2;
#pragma unroll
  for (int c0 = 0; c0 < C2; c0 += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float z = acc[c0 + i] + b_s[c0 + i];
      v[i] = z * (1.f / (1.f + expf(-z)));  // SiLU, as z * sigmoid(z)
    }
    store8(yp + c0, v);
  }
}

template <int C2, typename T>
int launch(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kTaps * C2 + C2 + kInY * kInX * 3);
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel<C2, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = H / 2, OW = W / 2;
  const dim3 grid((OW + kTileX - 1) / kTileX, (OH + kTileY - 1) / kTileY, B);
  const dim3 block(kTileX, kTileY);
  stem_conv_kernel<C2, T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_c2(int c2, const void* x, const void* w, const void* b, void* y, int B, int H,
                int W, cudaStream_t s) {
  switch (c2) {
    case 16: return launch<16, T>(x, w, b, y, B, H, W, s);
    case 32: return launch<32, T>(x, w, b, y, B, H, W, s);
    case 48: return launch<48, T>(x, w, b, y, B, H, W, s);
    case 64: return launch<64, T>(x, w, b, y, B, H, W, s);
    case 80: return launch<80, T>(x, w, b, y, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int yolo_stem_conv(const void* x, const void* w, const void* b, void* y, int B,
                              int H, int W, int c2, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_c2<float>(c2, x, w, b, y, B, H, W, s);
  if (dtype == 1) return dispatch_c2<__nv_bfloat16>(c2, x, w, b, y, B, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
