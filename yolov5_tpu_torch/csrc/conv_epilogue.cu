// K3: the epilogue of a BN-folded convolution, in place on its fresh output:
//   y <- round(act(float(y) + float(b[c])) [+ float(r)]),
// act SiLU or identity, r an optional residual of y's shape and layout,
// float32 arithmetic and one rounding to y's dtype at the end.
//
// Replaces no TPU kernel: XLA fuses the bias, the activation and the
// Bottleneck's add into the convolution on the TPU. Here cuDNN runs the
// convolution without its bias; PyTorch would add the bias as a strided
// broadcast over the channels_last output (a pass that reads and writes
// every element at ~40% of the card's bandwidth), then SiLU and the residual
// add would make a pass each. This kernel is the one pass left.
//
// What bounds it on the H100: bytes. It reads and writes each element once,
// 2·N·elem, plus N·elem for a residual (3.35 TB/s); its arithmetic (an exp
// and a division an element) is far from the card's rates.
//
// What the design does about it:
//   - each thread moves 16 bytes a load and a store (8 bf16 or 4 f32) over
//     the flat storage, in a grid-stride loop over one wave of resident
//     blocks, so all accesses are whole 128-byte lines;
//   - element i's channel is (i / inner) % C (inner 1 for NHWC, H·W for
//     contiguous NCHW), kept as a running (channel, remainder) pair that
//     each step advances by additions and compares, never a division. With
//     NHWC and C a multiple of 8 (4 in f32) a vector's channels are one
//     aligned slice of the bias, read as one 16-byte load; otherwise the
//     channel is stepped element by element, so any C works, 255 and 351
//     included (one vector may straddle two pixels). The bias is read
//     through the read-only cache, where it stays (at most 1 280 channels);
//   - a pointer that is not 16-byte aligned, and the last N % 8 (or N % 4)
//     elements, take a scalar path with an explicit division.
// It runs at 82-84% of the bytes bound at the P6 cell's shapes, where
// PyTorch's own in-place pass reaches 90%. Unrolling 2-8 loads a thread,
// streaming cache hints, more or fewer blocks, the bias staged in shared
// memory and a fast-math SiLU each moved it by 2 points or less.
// SiLU is v / (1 + expf(-v)) with the accurate expf and an IEEE division,
// as PyTorch's own SiLU computes it in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <bool kSilu>
__device__ __forceinline__ float act(float v) {
  return kSilu ? v / (1.0f + expf(-v)) : v;
}

// 16 bytes as V floats and back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static float2 half2f(uint32_t w) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
    return __bfloat1622float2(h);
  }
  __device__ __forceinline__ static uint32_t f2half(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static void unpack(uint4 u, float* f) {
    float2 a = half2f(u.x), b = half2f(u.y), c = half2f(u.z), d = half2f(u.w);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y; f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(f2half(f[0], f[1]), f2half(f[2], f[3]), f2half(f[4], f[5]),
                      f2half(f[6], f[7]));
  }
};

template <typename T, bool kSilu, bool kRes>
__global__ void __launch_bounds__(kThreads) conv_epilogue_kernel(
    T* __restrict__ y, const T* __restrict__ b, const T* __restrict__ r, long long n, int C,
    long long inner, long long nvec, bool slices) {
  constexpr int V = Vec<T>::V;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  // element e = (q * C + c) * inner + rem: this thread's first vector, and
  // the move of one grid stride, both reduced
  const long long e0 = tid * V, step = threads * V;
  long long rem = e0 % inner;
  int c = static_cast<int>((e0 / inner) % C);
  const long long step_rem = step % inner;
  const int step_c = static_cast<int>((step / inner) % C);
  for (long long i = tid; i < nvec; i += threads) {
    float v[V];
    Vec<T>::unpack(reinterpret_cast<const uint4*>(y)[i], v);
    if (slices) {
      float bv[V];
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(b + c)), bv);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = act<kSilu>(v[j] + bv[j]);
    } else {
      long long rj = rem;
      int cj = c;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[j] = act<kSilu>(v[j] + to_f(__ldg(b + cj)));
        if (++rj == inner) {
          rj = 0;
          if (++cj == C) cj = 0;
        }
      }
    }
    if (kRes) {
      float rv[V];
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(r) + i), rv);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] += rv[j];
    }
    reinterpret_cast<uint4*>(y)[i] = Vec<T>::pack(v);
    rem += step_rem;
    c += step_c;
    if (rem >= inner) {
      rem -= inner;
      ++c;
    }
    if (c >= C) c -= C;
  }
  // the scalar tail: all of it when a pointer is not 16-byte aligned
  for (long long e = nvec * V + tid; e < n; e += threads) {
    float v = act<kSilu>(to_f(y[e]) + to_f(b[(e / inner) % C]));
    if (kRes) v += to_f(r[e]);
    y[e] = from_f<T>(v);
  }
}

int sm_count(int dev) {
  static int cached[64] = {0};
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = sms;
  }
  return cached[dev];
}

template <typename T, bool kSilu, bool kRes>
int launch(void* y, const void* b, const void* r, long long n, int C, long long inner, int dev,
           cudaStream_t stream) {
  auto kernel = conv_epilogue_kernel<T, kSilu, kRes>;
  static int per_sm = 0;  // resident blocks an SM, the same on every H100
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) per_sm = 1;
  }
  const int sms = sm_count(dev);
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  constexpr int V = Vec<T>::V;
  const bool aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       (!kRes || reinterpret_cast<uintptr_t>(r) % 16 == 0);
  const long long nvec = aligned ? n / V : 0;
  const bool slices = inner == 1 && C % V == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const long long work = nvec > 0 ? nvec : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(want < cap ? want : cap);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<T*>(y), static_cast<const T*>(b),
                                        static_cast<const T*>(r), n, C, inner, nvec, slices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(void* y, const void* b, const void* r, long long n, int C, long long inner, int act,
             int dev, cudaStream_t s) {
  if (act == 1)
    return r ? launch<T, true, true>(y, b, r, n, C, inner, dev, s)
             : launch<T, true, false>(y, b, r, n, C, inner, dev, s);
  return r ? launch<T, false, true>(y, b, r, n, C, inner, dev, s)
           : launch<T, false, false>(y, b, r, n, C, inner, dev, s);
}

}  // namespace

// y (n elements, channel of element i = (i / inner) % C) updated in place;
// b (C,) and r (n, or null) of y's dtype. act: 0 identity, 1 SiLU; dtype:
// 0 float32, 1 bfloat16; dev: the device y lies on. Returns a cudaError_t.
extern "C" int yolo_conv_epilogue(void* y, const void* b, const void* r, long long n, int C,
                                  long long inner, int act, int dtype, int dev, void* stream) {
  if (n < 0 || C <= 0 || inner <= 0 || (act != 0 && act != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) rc = dispatch<float>(y, b, r, n, C, inner, act, dev, s);
  if (dtype == 1) rc = dispatch<__nv_bfloat16>(y, b, r, n, C, inner, act, dev, s);
  if (cur != dev) cudaSetDevice(cur);
  return rc;
}
