// K1: exact sequential-greedy NMS keep mask, one block per image.
//
// Replaces yolov5_tpu/ops/nms_pallas.py::greedy_nms_pallas (kernel body
// `_kernel`, IoU `_iou`). Same result for every candidate up to the
// max_det-th keep; past it, and past the first score <= 0, the mask is False
// (the early exit of yolov5_tpu/ops/nms.py::_greedy_nms_tiled). The packed
// Detections do not change, since they hold at most max_det keeps.
//
// What bounds it on the H100: sequential depth and latency, not bytes or
// FLOPs. Greedy NMS decides candidate i only after every earlier candidate,
// so an image is a chain of K dependent steps; the batch gives one
// independent chain per image.
//
// What the design does about it:
//   - one block per image, 256 threads;
//   - the kept boxes (at most max_det) sit compacted in shared memory, so a
//     step costs ceil(n_kept / 256) IoUs per thread and one block-wide OR
//     (__syncthreads_or), never a pass over all K candidates;
//   - slot j of the kept buffer is written and read only by thread j % 256,
//     so appending a keep needs no barrier of its own;
//   - candidates stream from global memory in chunks of 256 (one coalesced
//     load per chunk), which takes the load latency off the chain;
//   - the chain stops at max_det keeps or at the first score <= 0.
// The Pallas design keeps all K boxes on chip; at the 30 720-candidate cap
// they take 480 KiB, more than a block's 227 KB, so that does not carry over.
//
// The IoU is the arithmetic of nms_pallas._iou, with every operation rounded
// on its own (__fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn cannot be contracted
// into an FMA), so the mask equals the PyTorch version bit for bit, ties at
// the threshold included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// a: kept box, b: candidate; xyxy in x, y, z, w.
__device__ __forceinline__ float iou_rn(float4 a, float4 b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f),
                                 fmaxf(__fsub_rn(a.w, a.y), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                                 fmaxf(__fsub_rn(b.w, b.y), 0.f));
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  return __fdiv_rn(inter, denom);
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  uint8_t* __restrict__ keep, int K, float thres, int max_det) {
  extern __shared__ float4 smem[];
  float4* kept = smem;                  // max_det boxes, slot j owned by thread j % kThreads
  float4* cbox = smem + max_det;        // current chunk of candidates
  float* cscore = reinterpret_cast<float*>(cbox + kThreads);

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  boxes += base;
  scores += base;
  keep += base;

  // n_kept, stop and hit are uniform across the block: every thread reads
  // the same shared values and the same __syncthreads_or result.
  int n_kept = 0;
  int decided = K;  // candidates [decided, K) are never reached
  bool stop = false;
  for (int start = 0; start < K && !stop; start += kThreads) {
    const int n = min(kThreads, K - start);
    if (tid < n) {
      cbox[tid] = boxes[start + tid];
      cscore[tid] = scores[start + tid];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (!(cscore[i] > 0.f)) {  // sorted: padding from here on
        stop = true;
        decided = start + i;
        break;
      }
      const float4 c = cbox[i];
      int hit = 0;
      for (int j = tid; j < n_kept; j += kThreads) hit |= iou_rn(kept[j], c) > thres;
      hit = __syncthreads_or(hit);
      if (tid == 0) keep[start + i] = hit ? 0 : 1;
      if (!hit) {
        if (tid == n_kept % kThreads) kept[n_kept] = c;
        if (++n_kept == max_det) {
          stop = true;
          decided = start + i + 1;
          break;
        }
      }
    }
    __syncthreads();  // the chunk buffer is refilled next
  }
  for (int i = decided + tid; i < K; i += kThreads) keep[i] = 0;
}

}  // namespace

// boxes (bs, K, 4) f32 xyxy sorted by descending score, 16-byte aligned;
// scores (bs, K) f32; keep (bs, K) bytes. Returns a cudaError_t.
extern "C" int yolo_greedy_nms(const void* boxes, const void* scores, void* keep,
                               int bs, int K, float thres, int max_det, void* stream) {
  if (bs <= 0 || K <= 0 || max_det <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(max_det) * sizeof(float4) +
                      kThreads * (sizeof(float4) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_nms_kernel<<<bs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), K, thres, max_det);
  return static_cast<int>(cudaGetLastError());
}
