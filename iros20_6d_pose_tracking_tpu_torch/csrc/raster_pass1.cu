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
// strict >. Blocks whose screen bbox misses the pixel tile's rows (or the
// window's columns) are skipped. These are the TPU kernel's tie-break rules;
// keeping them keeps its winners.
//
// Batch axis: B views (the TPU kernel under jax.vmap, as the training
// sampler renders 2 x batch views per step) in one launch. The grid is
// (pixel tiles, B); each view reads its own coefficients and block bboxes
// and writes its own outputs, so view b is the same bits as a launch on
// view b alone. B = 1 is the tracking step's call.
//
// What bounds it on this card. Arithmetic: B x P x F (pixel, face) pairs,
// each 4 forms of 2 mul + 2 add plus the compare/select chain, against a
// few bytes of output per pixel. At 176^2 pixels and 2048 faces that is
// about 63M pairs, 1 GFLOP, per view before the block skip.
//
// What the design does about it. One thread per pixel keeps its running key
// in a register; a block of pix_tile threads (a pixel tile) stages the face
// coefficients through shared memory (raster_pass1_block.cuh). The
// block-bbox skip test is uniform across the tile, so a skipped block costs
// one test and no loads.

#include <cuda_runtime.h>

#include "raster_pass1_block.cuh"

namespace {

__global__ void raster_pass1_kernel(const float* __restrict__ coef,
                                    const float* __restrict__ block_bbox,
                                    float* __restrict__ iz_out,
                                    int* __restrict__ winner_out, int F,
                                    int n_blocks, int face_block, int H,
                                    int W) {
  // Face-major staging: face f's twelve rows at smem[f * 12 .. f * 12 + 11].
  __shared__ __align__(16) float smem[pass1::kChunk * pass1::kRows];

  // View blockIdx.y: its (12, F) coefficients, (n_blocks, 4) bboxes and
  // (H * W,) outputs.
  const long long view = blockIdx.y;
  coef += view * 12 * F;
  block_bbox += view * 4 * n_blocks;
  iz_out += view * H * W;
  winner_out += view * H * W;

  const int pix_tile = blockDim.x;
  const int first_q = blockIdx.x * pix_tile;
  const int q = first_q + threadIdx.x;
  const float px = static_cast<float>(q % W);
  const float py = static_cast<float>(q / W);
  // The tile's pixel-row range, for the block skip test (rows past the
  // window's last one are harmless: no face covers them).
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
    const bool hit =
        (xmax >= 0.0f) && (xmin <= xlast) && (ymax >= y0) && (ymin <= y1);
    if (!hit) continue;  // uniform across the block: no divergence

    const int block_start = j * face_block;
    const int best = pass1::block_best_key(
        coef, smem, F, block_start, min(block_start + face_block, F),
        lane_mask, px, py);
    if (best > acc_key) {  // strict: an earlier block keeps its ties
      acc_key = best;
      acc_idx = (best & lane_mask) + block_start;
    }
  }
  if (q < H * W) {
    pass1::store_winner(acc_key, acc_idx, lane_mask, q, iz_out, winner_out);
  }
}

}  // namespace

extern "C" {

// coef: (B, 12, F) f32; block_bbox: (B, n_blocks, 4) f32 [xmin, xmax,
// ymin, ymax]; iz, winner: (B, H * W) f32 / i32 outputs. face_block is a
// power of two with n_blocks = ceil(F / face_block); pix_tile (threads per
// block) is a multiple of 32 in [32, 1024]; 1 <= B <= 65535. All pointers
// live on the current CUDA device, which the caller sets; the kernel is
// queued on `stream` and nothing synchronises.
int raster_pass1(const void* coef, const void* block_bbox, void* iz,
                 void* winner, int F, int n_blocks, int face_block, int H,
                 int W, int pix_tile, int B, void* stream) {
  const int P = H * W;
  if (P == 0 || B == 0) return 0;
  if (B < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + pix_tile - 1) / pix_tile, B);
  raster_pass1_kernel<<<grid, pix_tile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<const float*>(block_bbox),
      static_cast<float*>(iz), static_cast<int*>(winner), F, n_blocks,
      face_block, H, W);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
