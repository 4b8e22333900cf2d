// K1: exact sequential-greedy NMS keep mask, one cluster of 8 blocks per
// image, two cluster barriers per chunk of 512 candidates.
//
// Replaces yolov5_tpu/ops/nms_pallas.py::greedy_nms_pallas (kernel body
// `_kernel`, IoU `_iou`). Same result for every candidate up to the
// max_det-th keep; past it, and past the first score <= 0, the mask is False
// (the early exit of yolov5_tpu/ops/nms.py::_greedy_nms_tiled). The packed
// Detections do not change, since they hold at most max_det keeps.
//
// What bounds it on the H100: greedy NMS decides candidate i only after
// every earlier candidate, so an image is a chain of dependent steps. The
// IoUs themselves are few: at b32 x 2048, IoU 0.45, max_det 1000 greedy
// needs at most 49.6 M, 0.013 ms of f32 work on the whole card; the bytes
// (1.4 MB) take 0.4 us. The floor is the chain, not the roofline.
//
// What the design does about it: the chain is walked in chunks of kChunk
// candidates, and everything but the chain itself runs in parallel.
//   1. Every block of the image's cluster loads the chunk. Its eighth of
//      the chunk is tested against the boxes kept so far (a compact list in
//      each block's shared memory), giving each candidate's "dead" bit; its
//      eighth of the rows of the chunk's upper-triangle suppression bitmask
//      (bit j of row i: IoU(i, j) > thres, i < j) is computed too. Both go
//      into the leader block's shared memory through distributed shared
//      memory, so one image's IoU work is spread over 8 blocks (32 images make
//      256 blocks; at most 106 KB of shared memory each, so two fit an SM).
//   2. One cluster barrier; then one warp of the leader resolves the chain
//      in registers: lane l holds word l of the "removed" mask, and a kept
//      candidate ORs its mask row in (one shared word a lane); removed
//      candidates are skipped a word at a time with __ffs.
//   3. One cluster barrier; every block appends the chunk's keeps to its own
//      kept list, and the leader writes the chunk's mask bytes.
// So a chunk costs two cluster barriers, not one block barrier per
// candidate. A pair whose x or y ranges do not overlap has IoU exactly 0,
// which is not > thres for thres >= 0: such pairs are rejected before the
// division (only when thres >= 0); with the class offsets of ops/nms.py
// that is most pairs.
//
// The IoU is the arithmetic of nms_pallas._iou, with every operation rounded
// on its own (__fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn cannot be contracted
// into an FMA), a = the earlier candidate and b = the later, and a strict >
// against the threshold, so the mask equals the PyTorch version bit for bit,
// ties at the threshold included.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                  // blocks per image
constexpr int kThreads = 256;
constexpr int kChunk = 512;                  // candidates per chunk
constexpr int kWords = kChunk / 32;          // mask words per row
constexpr int kShare = kChunk / kCluster;    // candidates per block in the dead-bit test
constexpr int kParts = kThreads / kShare;    // threads per candidate there

// a: the earlier candidate, b: the later; xyxy in x, y, z, w.
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

// IoU(a, b) > thres. With reject (thres >= 0), a pair whose x or y ranges do
// not overlap is false at once: its intersection, hence its IoU, is 0.
__device__ __forceinline__ bool suppresses(float4 a, float4 b, float thres, bool reject) {
  if (reject && (__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)) <= 0.f ||
                 __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)) <= 0.f))
    return false;
  return iou_rn(a, b) > thres;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  uint8_t* __restrict__ keep, int K, float thres, int max_det) {
  __shared__ float4 cbox[kChunk];            // the chunk's candidates
  __shared__ uint32_t tri[kChunk * kWords];  // leader: the chunk's suppression rows
  __shared__ uint32_t dead[kWords];          // leader: removed by earlier keeps
  __shared__ uint32_t keepw[kWords];         // leader: the chunk's keep bits
  __shared__ uint8_t hit[kThreads];
  __shared__ uint32_t keep_loc[kWords];      // a copy of the leader's keepw
  __shared__ int slot0[kWords];              // kept-list slot of each word's first keep
  __shared__ int s_lim, s_stop, s_nkept;
  extern __shared__ float4 kept[];           // max_det boxes kept so far, in order

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x / kCluster) * K;
  boxes += base;
  scores += base;
  keep += base;
  uint32_t* tri0 = cluster.map_shared_rank(tri, 0);
  uint32_t* dead0 = cluster.map_shared_rank(dead, 0);
  const uint32_t* keepw0 = cluster.map_shared_rank(keepw, 0);
  const int* stop0 = cluster.map_shared_rank(&s_stop, 0);
  const int* nkept0 = cluster.map_shared_rank(&s_nkept, 0);
  const bool reject = thres >= 0.f;

  int n_kept = 0;  // uniform across the cluster
  int end = 0;     // candidates [0, end) have their mask bytes written
  for (int start = 0; start < K; start += kChunk) {
    const int n = min(kChunk, K - start);
    if (tid == 0) s_lim = n;
    __syncthreads();
    for (int t = tid; t < kChunk; t += kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < n) {
        v = boxes[start + t];
        if (!(scores[start + t] > 0.f)) atomicMin(&s_lim, t);  // sorted: padding from here
      }
      cbox[t] = v;
    }
    __syncthreads();
    const int lim = s_lim;  // candidates [lim, n) are padding

    // 1a. dead bits of this block's share against the kept list
    {
      const int i = rank * kShare + tid % kShare;
      bool h = false;
      if (i < lim) {
        const float4 c = cbox[i];
        for (int j = tid / kShare; j < n_kept; j += kParts)
          if (suppresses(kept[j], c, thres, reject)) {
            h = true;
            break;
          }
      }
      hit[tid] = h;
    }
    // 1b. rows i = rank, rank + kCluster, ... of the triangle; lanes share a word
    //     (broadcast column reads) and differ in the row
    for (int it = tid; it < kShare * kWords; it += kThreads) {
      const int w = it / kShare, i = (it % kShare) * kCluster + rank;
      uint32_t bits = 0;
      if (i < lim && w >= (i >> 5)) {
        const float4 a = cbox[i];
        const int j_end = min(32, lim - 32 * w);
        for (int jj = (w == (i >> 5) ? (i & 31) + 1 : 0); jj < j_end; ++jj)
          if (suppresses(a, cbox[32 * w + jj], thres, reject)) bits |= 1u << jj;
      }
      tri0[i * kWords + w] = bits;
    }
    __syncthreads();
    if (warp < kShare / 32) {
      const int c = warp * 32 + lane;
      bool h = false;
#pragma unroll
      for (int p = 0; p < kParts; ++p) h |= hit[p * kShare + c];
      const uint32_t word = __ballot_sync(0xffffffffu, h);
      if (lane == 0) dead0[rank * (kShare / 32) + warp] = word;
    }
    cluster.sync();

    // 2. the leader's warp 0 walks the chain of the chunk
    if (rank == 0 && warp == 0) {
      uint32_t removed = lane < kWords ? dead[lane] : 0u;
      uint32_t mine = 0;  // lane l: keep word l
      int nk = n_kept;
      bool stop = lim < n;  // a score <= 0 inside the chunk ends the walk there
      for (int w = 0; w < kWords && 32 * w < lim; ++w) {
        const uint32_t valid = lim - 32 * w >= 32 ? 0xffffffffu : (1u << (lim - 32 * w)) - 1u;
        uint32_t cand = ~__shfl_sync(0xffffffffu, removed, w) & valid;
        uint32_t kw = 0;
        bool full = false;
        while (cand) {
          const int bit = __ffs(cand) - 1;
          const uint32_t* row = tri + (32 * w + bit) * kWords;
          kw |= 1u << bit;
          if (lane < kWords) removed |= row[lane];
          cand &= ~row[w] & ~((2u << bit) - 1u);
          if (++nk == max_det) {
            full = true;
            break;
          }
        }
        if (lane == w) mine = kw;
        if (full) {
          stop = true;
          break;
        }
      }
      if (lane < kWords) keepw[lane] = mine;
      if (lane == 0) {
        s_stop = stop || start + n >= K;
        s_nkept = nk;
      }
    }
    cluster.sync();

    // 3. every block appends the chunk's keeps; the leader writes the mask
    if (warp == 0) {  // the leader's keep words and their running counts
      const uint32_t word = lane < kWords ? keepw0[lane] : 0u;
      uint32_t sum = __popc(word);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t v = __shfl_up_sync(0xffffffffu, sum, d);
        if (lane >= d) sum += v;
      }
      if (lane < kWords) {
        keep_loc[lane] = word;
        slot0[lane] = n_kept + sum - __popc(word);
      }
    }
    const bool stop = *stop0 != 0;
    n_kept = *nkept0;
    __syncthreads();
    for (int t = tid; t < kChunk; t += kThreads) {
      const uint32_t word = keep_loc[t >> 5];
      const bool k = (word >> (t & 31)) & 1u;
      if (k) kept[slot0[t >> 5] + __popc(word & ((1u << (t & 31)) - 1u))] = cbox[t];
      if (rank == 0 && t < n) keep[start + t] = k;
    }
    end = start + n;
    __syncthreads();  // cbox and kept are read again in the next chunk
    if (stop) break;
  }
  // past the walk's end the mask is False; the cluster shares the tail
  for (int i = end + rank * kThreads + tid; i < K; i += kCluster * kThreads) keep[i] = 0;
  cluster.sync();  // the leader's shared memory stays until every block is done with it
}

}  // namespace

// boxes (bs, K, 4) f32 xyxy sorted by descending score, 16-byte aligned;
// scores (bs, K) f32; keep (bs, K) bytes. Returns a cudaError_t.
extern "C" int yolo_greedy_nms(const void* boxes, const void* scores, void* keep,
                               int bs, int K, float thres, int max_det, void* stream) {
  if (bs <= 0 || K <= 0 || max_det <= 0 || bs > (1 << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(max_det) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_nms_kernel<<<bs * kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), K, thres, max_det);
  return static_cast<int>(cudaGetLastError());
}
