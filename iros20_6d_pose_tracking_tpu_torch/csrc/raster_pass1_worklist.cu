// Rasterization pass 1 over a work list, for Hopper: K1's z-buffer winner
// search, computed only over the (pixel tile, face block) pairs whose
// bboxes intersect.
//
// Replaces the TPU kernel iros20_6d_pose_tracking_tpu/render/pallas_raster.py
// ::_wl_kernel (launched by pallas_pass1_worklist, its list made by
// build_worklist). Plain PyTorch version:
// render/raster_kernels.py::pass1_worklist_ref, which this kernel matches bit
// for bit; both give raster_pass1.cu's winners and 1/z.
//
// What it computes. The work list is tile-major: the intersecting (tile,
// block) pairs first, each tile's blocks in ascending order, then padding.
// Per pixel, the packed-key search of raster_pass1_block.cuh runs over the
// blocks its tile lists, in that order; a later block replaces the running
// best only on a strict > (ROADMAP F2, K1's tie-break). A tile the list
// does not name gets the init values: iz -1, winner 0.
//
// The TPU walks the list in one sequential grid, one entry per step, and
// keeps a tile's accumulator resident across its consecutive entries with
// the init and valid flags. Thread blocks on this card run in parallel and
// in no order, so two blocks on one tile would race. Here each pixel tile is
// one thread block that walks its own segment of the list: the wrapper
// gives a CSR view of the same list (per-tile entry counts, exclusive-scanned
// into offsets), made on the device, so the number of real entries never
// reaches the host. The grid is static: one thread block per tile.
//
// What bounds it on this card: as K1, the coefficient and output bytes;
// the (pixel, face) pairs it evaluates are K1's. The list replaces K1's
// per-run bbox test of every block (cheap, uniform) with a read of the
// tile's segment; on a sparse full frame (a small object in 480x640) most
// tiles have an empty segment and only store their init values. Within a
// listed block each warp bins the staged faces against the rectangle of
// its 32 pixels (raster_pass1_block.cuh, as K1 does against its patches),
// so a pixel evaluates only the faces that can reach its warp's pixels.

#include <cuda_runtime.h>

#include "raster_pass1_block.cuh"

namespace {

constexpr int kThreads = 128;  // one pixel tile (PIX_TILE pixels)

__global__ void __launch_bounds__(kThreads) raster_pass1_worklist_kernel(
    const float* __restrict__ coef, const int* __restrict__ block_ids,
    const int* __restrict__ tile_offsets, const int* __restrict__ tile_counts,
    float* __restrict__ iz_out, int* __restrict__ winner_out, int F,
    int face_block, int H, int W) {
  // Face-major staging: face f's twelve rows at smem[f * 12 .. f * 12 + 11].
  __shared__ __align__(16) float smem[pass1::kChunk * pass1::kRows];

  const int tile = blockIdx.x;
  const int q = tile * blockDim.x + threadIdx.x;
  const float px = static_cast<float>(q % W);
  const float py = static_cast<float>(q / W);
  // The warp's 32 consecutive pixels span one or more rows: its rectangle
  // is their bounding box.
  const pass1::Rect rect = pass1::warp_rect(q % W, q / W, q < H * W);
  const int lane_mask = face_block - 1;
  // The tile's segment of the list; uniform across the block.
  const int begin = tile_offsets[tile];
  const int end = begin + tile_counts[tile];

  int acc_key = -1;
  int acc_idx = 0;
  for (int k = begin; k < end; ++k) {
    const int block_start = block_ids[k] * face_block;
    const int best = pass1::block_best_key<kThreads, 1>(
        coef, smem, F, block_start, min(block_start + face_block, F),
        lane_mask, px, py, rect, 0);
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

// coef: (12, F) f32; block_ids: the work list's face-block ids, tile-major
// (int32); tile_offsets, tile_counts: (n_tiles,) int32, tile t's entries are
// block_ids[tile_offsets[t] .. tile_offsets[t] + tile_counts[t]); iz,
// winner: (H * W,) f32 / i32 outputs, n_tiles = ceil(H * W / pix_tile).
// face_block is a power of two; pix_tile (threads per block) is 128. All
// pointers live on the current CUDA device, which the caller sets; the
// kernel is queued on `stream` and nothing synchronises.
int raster_pass1_worklist(const void* coef, const void* block_ids,
                          const void* tile_offsets, const void* tile_counts,
                          void* iz, void* winner, int F, int face_block,
                          int H, int W, int pix_tile, void* stream) {
  const int P = H * W;
  if (P == 0) return 0;
  if (pix_tile != kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (P + pix_tile - 1) / pix_tile;
  raster_pass1_worklist_kernel<<<n_tiles, pix_tile, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<const int*>(block_ids),
      static_cast<const int*>(tile_offsets),
      static_cast<const int*>(tile_counts), static_cast<float*>(iz),
      static_cast<int*>(winner), F, face_block, H, W);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
