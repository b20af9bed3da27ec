// One face block of the pass-1 winner search, shared by the two pass-1
// kernels: raster_pass1.cu (K1, every block whose bbox meets the pixel tile)
// and raster_pass1_worklist.cu (K3, the blocks a work list names).
//
// Per face, pass 1 holds twelve floats (a (12, F) matrix, row layout ROW_*
// of render/raster_kernels.py): three sign-folded edge forms and the
// screen-linear 1/z form, each form = px * a + py * b + c. A pixel is
// covered by a face when all three edge forms are >= 0 and its 1/z form is
// > 0. The winner is the covered face of largest 1/z, found as the max of
// one packed int key per (pixel, face):
//     key = (bits(iz) & ~(face_block - 1)) | lane,  lane = face % face_block
// (positive floats order like their bits, so the max is the depth test and
// the argmax at once).
//
// The thread block is one pixel tile, one thread per pixel. It stages the
// coefficients of kChunk faces at a time in shared memory, each face's
// twelve floats contiguous, so every thread reads the same face at the same
// time (a broadcast: no bank conflicts) and device memory sees each
// coefficient once per tile. Any face count works: the chunk loop walks a
// block in pieces (the TPU kernel's VMEM budget does not apply here).
//
// The forms are written with __fmul_rn/__fadd_rn: nvcc would otherwise
// contract px * a + py * b + c into FMAs, whose single rounding changes the
// forms' last bits and so the coverage of pixels on triangle edges; the
// plain versions round after every op (ROADMAP F3).
#pragma once

#include <cuda_runtime.h>

namespace pass1 {

constexpr int kChunk = 256;  // faces staged in shared memory at a time
constexpr int kRows = 12;    // coefficient rows per face

__device__ __forceinline__ float form(float px, float py, float a, float b,
                                      float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

// Max packed key of faces [block_start, block_end) at pixel (px, py), or -1
// where none covers it. Every thread of the block must call it with the
// same face range (it synchronises the block); smem holds kChunk * kRows
// floats, 16-byte aligned.
__device__ __forceinline__ int block_best_key(const float* __restrict__ coef,
                                              float* smem, int F,
                                              int block_start, int block_end,
                                              int lane_mask, float px,
                                              float py) {
  int best = -1;
  for (int s = block_start; s < block_end; s += kChunk) {
    const int n = min(kChunk, block_end - s);
    __syncthreads();  // the previous chunk is no longer being read
    for (int i = threadIdx.x; i < n * kRows; i += blockDim.x) {
      const int row = i / n;
      const int f = i - row * n;
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
  return best;
}

// The outputs of one pixel from its running key: iz -1 and winner 0 where no
// face covers it (the TPU kernels' init values).
__device__ __forceinline__ void store_winner(int acc_key, int acc_idx,
                                             int lane_mask, int q,
                                             float* __restrict__ iz_out,
                                             int* __restrict__ winner_out) {
  iz_out[q] = acc_key < 0 ? -1.0f : __int_as_float(acc_key & ~lane_mask);
  winner_out[q] = acc_idx;
}

}  // namespace pass1
