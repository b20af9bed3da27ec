// Rasterization pass 1 for Hopper: the z-buffer winner search.
//
// Replaces the TPU kernel iros20_6d_pose_tracking_tpu/render/pallas_raster.py
// ::_kernel (launched by pallas_pass1). Plain PyTorch version:
// render/raster_kernels.py::pass1_winners_ref, which this kernel matches bit
// for bit.
//
// What it computes. Per face, pass 1 holds twelve floats (a (12, F) matrix,
// row layout ROW_* of raster_kernels.py): three sign-folded edge forms and
// the screen-linear 1/z form, each form = px * a + py * b + c. A pixel is
// covered by a face when all three edge forms are >= 0 and its 1/z form is
// > 0. The winner is the covered face of largest 1/z, found as the max of
// one packed int key per (pixel, face):
//     key = (bits(iz) & ~(face_block - 1)) | lane,  lane = face % face_block
// (positive floats order like their bits, so the max is the depth test and
// the argmax at once). Faces are visited in blocks of face_block, in
// ascending order: within a block the max key wins, across blocks a later
// block replaces the running best only on a strict >. Blocks whose screen
// bbox misses the pixel tile's rows (or the window's columns) are skipped.
// These are the TPU kernel's tie-break rules; keeping them keeps its winners.
//
// What bounds it on this card. Arithmetic: P x F (pixel, face) pairs, each
// 4 forms of 2 mul + 2 add plus the compare/select chain, against a few
// bytes of output per pixel. At 176^2 pixels and 2048 faces that is about
// 63M pairs, 1 GFLOP.
//
// What the design does about it. One thread per pixel keeps its running key
// in a register. A block of pix_tile threads (a pixel tile) stages the
// coefficients of CHUNK faces at a time in shared memory, each face's twelve
// floats contiguous, so every thread reads the same face at the same time
// (a broadcast: no bank conflicts) and device memory sees each coefficient
// once per tile. The block-bbox skip test is uniform across the tile, so a
// skipped block costs one test and no loads. Any face count works: the
// chunk loop walks the faces of a block in pieces (the TPU kernel's 12 MB
// VMEM budget does not apply here).
//
// The forms are written with __fmul_rn/__fadd_rn: nvcc would otherwise
// contract px * a + py * b + c into FMAs, whose single rounding changes the
// forms' last bits and so the coverage of pixels on triangle edges; the
// plain version rounds after every op.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;  // faces staged in shared memory at a time
constexpr int kRows = 12;    // coefficient rows per face

__device__ __forceinline__ float form(float px, float py, float a, float b,
                                      float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__global__ void raster_pass1_kernel(const float* __restrict__ coef,
                                    const float* __restrict__ block_bbox,
                                    float* __restrict__ iz_out,
                                    int* __restrict__ winner_out, int F,
                                    int n_blocks, int face_block, int H,
                                    int W) {
  // Face-major staging: face f's twelve rows at smem[f * 12 .. f * 12 + 11].
  __shared__ __align__(16) float smem[kChunk * kRows];

  const int pix_tile = blockDim.x;
  const int P = H * W;
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
    const int block_end = min(block_start + face_block, F);
    int best = -1;  // max key of this face block
    for (int s = block_start; s < block_end; s += kChunk) {
      const int n = min(kChunk, block_end - s);
      __syncthreads();  // the previous chunk is no longer being read
      for (int e = threadIdx.x; e < n * kRows; e += pix_tile) {
        const int row = e / n;
        const int f = e - row * n;
        smem[f * kRows + row] = coef[row * F + s + f];  // coalesced over f
      }
      __syncthreads();
      for (int f = 0; f < n; ++f) {
        const float4 r0 = *reinterpret_cast<const float4*>(&smem[f * kRows]);
        const float4 r1 =
            *reinterpret_cast<const float4*>(&smem[f * kRows + 4]);
        const float4 r2 =
            *reinterpret_cast<const float4*>(&smem[f * kRows + 8]);
        // rows: a0 b0 c0 | a1 b1 c1 | a2 b2 c2 | aw bw cw
        const float e0 = form(px, py, r0.x, r0.y, r0.z);
        const float e1 = form(px, py, r0.w, r1.x, r1.y);
        const float e2 = form(px, py, r1.z, r1.w, r2.x);
        const float izp = form(px, py, r2.y, r2.z, r2.w);
        // Comparisons, not fminf: a NaN form must not count as covered
        // (fminf would drop it; jnp.minimum / torch.minimum propagate it).
        const bool covered =
            (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) && (izp > 0.0f);
        const int lane = s + f - block_start;
        const int key = (__float_as_int(izp) & ~lane_mask) | lane;
        best = covered ? max(best, key) : best;
      }
    }
    if (best > acc_key) {  // strict: an earlier block keeps its ties
      acc_key = best;
      acc_idx = (best & lane_mask) + block_start;
    }
  }
  if (q < P) {
    iz_out[q] = acc_key < 0 ? -1.0f : __int_as_float(acc_key & ~lane_mask);
    winner_out[q] = acc_idx;
  }
}

}  // namespace

extern "C" {

// coef: (12, F) f32; block_bbox: (n_blocks, 4) f32 [xmin, xmax, ymin, ymax];
// iz, winner: (H * W,) f32 / i32 outputs. face_block is a power of two with
// n_blocks = ceil(F / face_block); pix_tile (threads per block) is a
// multiple of 32 in [32, 1024]. All pointers live on the current CUDA
// device, which the caller sets; the kernel is queued on `stream` and
// nothing synchronises.
int raster_pass1(const void* coef, const void* block_bbox, void* iz,
                 void* winner, int F, int n_blocks, int face_block, int H,
                 int W, int pix_tile, void* stream) {
  const int P = H * W;
  if (P == 0) return 0;
  const int grid = (P + pix_tile - 1) / pix_tile;
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
