// Rasterization pass 1 for Hopper: the z-buffer winner search.
//
// Replaces the TPU kernel iros20_6d_pose_tracking_tpu/render/pallas_raster.py
// ::_kernel (launched by pallas_pass1). Plain PyTorch version:
// render/raster_kernels.py::pass1_winners_ref, which this kernel matches bit
// for bit.
//
// What it computes: the packed-key winner search of raster_pass1_block.cuh,
// over every face block, in ascending order: within a block the max key
// wins, across blocks a later block replaces the running best only on a
// strict >. A block is left out for the pixels of every pix_tile-pixel run
// (consecutive in row-major order) whose rows its screen bbox misses, or
// when it misses the window's columns. These are the TPU kernel's rules,
// with its tile of pix_tile pixels; keeping them keeps its winners.
//
// Batch axis: B views (the TPU kernel under jax.vmap, as the training
// sampler renders 2 x batch views per step) in one launch. The grid is
// (ceil(W / 16), ceil(H / 16), B); each view reads its own coefficients and
// block bboxes and writes its own outputs, so view b is the same bits as a
// launch on view b alone. B = 1 is the tracking step's call.
//
// What bounds it on this card. Bytes: the coefficients of the faces whose
// screen bbox holds a pixel (48 bytes a face) and 8 bytes of output a
// pixel, 0.29 MB for the 176^2 ROI of the 2048-face production mesh and 99
// MB for the 400 views of a training batch, under 0.03 ms at 3.35 TB/s. The (pixel, face) pairs a pixel
// really needs, those whose face's screen bbox holds it, are a few per
// pixel, a few MFLOP. The TPU's design evaluates every lane of a face
// block at every pixel of a tile (at 176^2 and 2048 faces about 63M pairs,
// 1 GFLOP per view, mostly on faces far from the pixel or padding).
//
// What the design does about it. A thread block is a 16 x 16 pixel patch,
// eight 8 x 4 pixel patches of kSplit warps each (one thread per pixel and
// warp, its running key in a register); ragged edges are masked. The block
// stages the coefficients through shared memory and each warp bins the
// staged faces against its own patch (raster_pass1_block.cuh), so a pixel
// evaluates only the faces that can reach its 8 x 4 patch: the faces far
// from it and the padding lanes cost one rectangle test per warp, not one
// per pixel. Every thread block reads all the coefficients it does not
// skip, so the block is as large as one view of the 176^2 ROI still fills
// the card with (121 blocks for 132 SMs); the next chunk's loads fly while
// a chunk is searched. One warp per patch leaves a single view's search
// latency-bound (7 warps an SM at 176^2, each walking every face), so when
// the grid holds few warps for the card the kSplit warps of a patch split
// each chunk's faces between them and take the max of their keys at the
// end of each face block, in block order, which keeps the strict > across
// blocks. A large batch already fills the card, and there every warp costs
// issue slots: the launch takes kSplit 4 when the grid, one warp per patch,
// holds at most kWarpsPerSm / 4 warps an SM (one 176^2 view), and 1
// otherwise (a full frame, 8 views or more). The bbox test
// of each face block is the TPU kernel's, per pixel run; a block no pixel
// of the thread block needs is skipped whole, with no loads.

#include <cuda_runtime.h>

#include "raster_pass1_block.cuh"

namespace {

constexpr int kPatchW = 8;   // pixel columns of a warp's patch
constexpr int kPatchH = 4;   // pixel rows of a warp's patch
constexpr int kBlockW = 16;  // 2 x 4 patches per thread block
constexpr int kBlockH = 16;
constexpr int kPatches = (kBlockW / kPatchW) * (kBlockH / kPatchH);
constexpr int kWarpsPerSm = 32;  // the split's target for a thin grid

// kSplit warps on each patch, splitting its faces; 32 * kPatches * kSplit
// threads.
template <int kSplit>
__global__ void __launch_bounds__(32 * kPatches * kSplit)
    raster_pass1_kernel(const float* __restrict__ coef,
                        const float* __restrict__ block_bbox,
                        float* __restrict__ iz_out,
                        int* __restrict__ winner_out, int F, int n_blocks,
                        int face_block, int H, int W, int pix_tile) {
  constexpr int kThreads = 32 * kPatches * kSplit;
  // Face-major staging: face f's twelve rows at smem[f * 12 .. f * 12 + 11].
  __shared__ __align__(16) float smem[pass1::kChunk * pass1::kRows];
  // Each split warp's key of the face block, per pixel of its patch.
  __shared__ int split_key[kSplit][kPatches * 32];

  // View blockIdx.z: its (12, F) coefficients, (n_blocks, 4) bboxes and
  // (H * W,) outputs.
  const long long view = blockIdx.z;
  coef += view * 12 * F;
  block_bbox += view * 4 * n_blocks;
  iz_out += view * H * W;
  winner_out += view * H * W;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int patch = warp % kPatches;
  const int split = warp / kPatches;
  constexpr int kPatchesX = kBlockW / kPatchW;
  const int x = blockIdx.x * kBlockW + (patch % kPatchesX) * kPatchW +
                (lane % kPatchW);
  const int y = blockIdx.y * kBlockH + (patch / kPatchesX) * kPatchH +
                (lane / kPatchW);
  const bool inside = x < W && y < H;
  const pass1::Rect rect = pass1::warp_rect(x, y, inside);
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  // The rows of the pixel's run of pix_tile pixels, for the block skip test
  // (rows past the window's last one are harmless: no face covers them).
  const long long q = static_cast<long long>(y) * W + x;
  const long long first_q = (q / pix_tile) * pix_tile;
  const float y0 = static_cast<float>(first_q / W);
  const float y1 = static_cast<float>((first_q + pix_tile - 1) / W);
  const float xlast = static_cast<float>(W) - 1.0f;
  const int lane_mask = face_block - 1;

  int acc_key = -1;
  int acc_idx = 0;
  for (int j = 0; j < n_blocks; ++j) {
    const float xmin = block_bbox[4 * j + 0];
    const float xmax = block_bbox[4 * j + 1];
    const float ymin = block_bbox[4 * j + 2];
    const float ymax = block_bbox[4 * j + 3];
    const bool hit = inside && (xmax >= 0.0f) && (xmin <= xlast) &&
                     (ymax >= y0) && (ymin <= y1);
    if (!__syncthreads_or(hit)) continue;  // uniform across the block

    const int block_start = j * face_block;
    int best = pass1::block_best_key<kThreads, kSplit>(
        coef, smem, F, block_start, min(block_start + face_block, F),
        lane_mask, px, py, rect, split);
    if constexpr (kSplit > 1) {
      // The patch's key of the whole face block: the max over its split
      // warps (the next write waits behind the next face block's barriers).
      split_key[split][patch * 32 + lane] = best;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSplit; ++k) {
        best = max(best, split_key[k][patch * 32 + lane]);
      }
    }
    if (hit && best > acc_key) {  // strict: an earlier block keeps its ties
      acc_key = best;
      acc_idx = (best & lane_mask) + block_start;
    }
  }
  if (inside && split == 0) {
    pass1::store_winner(acc_key, acc_idx, lane_mask, q, iz_out, winner_out);
  }
}

}  // namespace

extern "C" {

// coef: (B, 12, F) f32; block_bbox: (B, n_blocks, 4) f32 [xmin, xmax,
// ymin, ymax]; iz, winner: (B, H * W) f32 / i32 outputs. face_block is a
// power of two with n_blocks = ceil(F / face_block); pix_tile, the run of
// pixels the block bbox test takes at a time, is positive; 1 <= B <= 65535
// and ceil(H / 16) <= 65535. All pointers live on the current CUDA device,
// which the caller sets; the kernel is queued on `stream` and nothing
// synchronises.
int raster_pass1(const void* coef, const void* block_bbox, void* iz,
                 void* winner, int F, int n_blocks, int face_block, int H,
                 int W, int pix_tile, int B, void* stream) {
  if (H == 0 || W == 0 || B == 0) return 0;
  const int grid_y = (H + kBlockH - 1) / kBlockH;
  if (B < 0 || B > 65535 || grid_y > 65535 || pix_tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + kBlockW - 1) / kBlockW, grid_y, B);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // Warps an SM would hold with one warp per patch, against the target.
  const long long warps =
      static_cast<long long>(grid.x) * grid.y * grid.z * kPatches;
  const long long target = static_cast<long long>(kWarpsPerSm) * sms;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, int threads) {
    kernel<<<grid, threads, 0, s>>>(
        static_cast<const float*>(coef),
        static_cast<const float*>(block_bbox), static_cast<float*>(iz),
        static_cast<int*>(winner), F, n_blocks, face_block, H, W, pix_tile);
  };
  if (4 * warps <= target) {
    launch(raster_pass1_kernel<4>, 32 * kPatches * 4);
  } else {
    launch(raster_pass1_kernel<1>, 32 * kPatches);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
