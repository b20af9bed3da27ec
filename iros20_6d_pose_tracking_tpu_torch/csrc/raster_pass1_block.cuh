// One face block of the pass-1 winner search, shared by the two pass-1
// kernels: raster_pass1.cu (K1, pixel patches) and raster_pass1_worklist.cu
// (K3, 128-pixel runs, the blocks a work list names).
//
// Per face, pass 1 holds twelve floats (a (12, F) matrix, row layout ROW_*
// of render/raster_kernels.py): three sign-folded edge forms and the
// screen-linear 1/z form, each form = px * a + py * b + c. A pixel is
// covered by a face when all three edge forms are >= 0 and its 1/z form is
// > 0. The winner is the covered face of largest 1/z, found as the max of
// one packed int key per (pixel, face):
//     key = (bits(iz) & ~(face_block - 1)) | lane,  lane = face % face_block
// (positive floats order like their bits, so the max is the depth test and
// the argmax at once). Within a face block the max is over the covered faces
// only, so leaving out a (pixel, face) pair that cannot cover the pixel
// leaves the key, and every output bit, unchanged.
//
// Staging. The thread block stages the coefficients of kChunk faces at a
// time in shared memory, each face's twelve floats contiguous (loads
// coalesced over faces; a float4 read of face f by lane f is free of bank
// conflicts, since 48-byte strides spread 8 lanes over all 32 banks). The
// next chunk's loads are issued into registers before the current chunk is
// searched, so their latency hides behind the search; the staging index
// math is shifts (kChunk and the block size are compile-time powers of
// two).
//
// Warp-level binning. Each warp owns a set of pixels and the rectangle
// [xlo, xhi] x [ylo, yhi] around their centres. Lane i tests face i of each
// 32-face group against that rectangle widened by one pixel on every side:
// the face is dropped when one of its edge forms has a maximum over the
// widened rectangle's corners below 0, or its 1/z form a maximum <= 0 (for
// a linear form the maximum is a * (a >= 0 ? xhi : xlo) + b * (b >= 0 ? yhi
// : ylo) + c). __ballot_sync gives the surviving faces; the warp walks them
// in ascending order and evaluates the exact forms at each of its pixels.
// Poisoned lanes (a = b = 0, c = -1) never survive: a group that edge 0
// alone empties (the padding of a small mesh) is left after one read.
//
// Why a dropped face cannot cover any pixel of the warp. Widening by one
// pixel adds exactly |a| + |b| to the maximum, so a dropped edge form is
// below -(|a| + |b|) at every pixel of the rectangle, exactly. The exact
// forms below round each of their four ops, an error of a few 2^-24 times
// |a px| + |b py| + |c|, where |c| <= |a px| + |b py| + |form|. With pixel
// coordinates under 10^4 (a window of at most 10^4 pixels a side; the ROI
// is 176 and a full frame 640) that is under 10^-2 (|a| + |b|) plus 10^-6
// of the form itself, far short of the margin, so the rounded form stays
// below 0. The same holds for the 1/z form against > 0; with a = b =
// 0 a form is exactly c at every pixel. The rectangle's own maximum is
// computed in float too, and an error there moves the margin by the same
// tiny amount. A NaN coefficient fails every comparison and is never
// dropped, so it reaches the exact forms as before.
//
// The exact forms are written with __fmul_rn/__fadd_rn: nvcc would
// otherwise contract px * a + py * b + c into FMAs, whose single rounding
// changes the forms' last bits and so the coverage of pixels on triangle
// edges; the plain versions round after every op (ROADMAP F3).
#pragma once

#include <cuda_runtime.h>

namespace pass1 {

constexpr int kChunk = 256;  // faces staged in shared memory at a time
constexpr int kRows = 12;    // coefficient rows per face
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float form(float px, float py, float a, float b,
                                      float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

// A warp's pixel rectangle, widened by one pixel; `empty` when no lane of
// the warp holds a pixel of the window.
struct Rect {
  float xlo, xhi, ylo, yhi;
  bool empty;
};

// The rectangle of the lanes with `valid` (pixel centre (x, y)), widened by
// one pixel. Every lane of the warp must call it.
__device__ __forceinline__ Rect warp_rect(int x, int y, bool valid) {
  constexpr int kBig = 1 << 30;
  const int xlo = __reduce_min_sync(kFull, valid ? x : kBig);
  const int xhi = __reduce_max_sync(kFull, valid ? x : -kBig);
  const int ylo = __reduce_min_sync(kFull, valid ? y : kBig);
  const int yhi = __reduce_max_sync(kFull, valid ? y : -kBig);
  return Rect{static_cast<float>(xlo - 1), static_cast<float>(xhi + 1),
              static_cast<float>(ylo - 1), static_cast<float>(yhi + 1),
              xlo > xhi};
}

__device__ __forceinline__ float rect_max(float a, float b, float c,
                                          const Rect& r) {
  return a * (a >= 0.0f ? r.xhi : r.xlo) + b * (b >= 0.0f ? r.yhi : r.ylo) +
         c;
}

// Coefficients of the chunk of faces [s, s + kChunk) clipped to block_end,
// into registers: element i = threadIdx.x + k * kThreads is row i / kChunk
// of face i % kChunk (coalesced over faces); 0 past block_end.
template <int kThreads>
__device__ __forceinline__ void fetch_chunk(
    const float* __restrict__ coef, int F, int s, int block_end,
    float (&v)[kChunk * kRows / kThreads]) {
#pragma unroll
  for (int k = 0; k < kChunk * kRows / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int f = i % kChunk;
    v[k] = s + f < block_end ? __ldg(&coef[(i / kChunk) * F + s + f]) : 0.0f;
  }
}

// Max packed key at pixel (px, py) of the faces [block_start, block_end)
// that the calling warp searches, or -1 where none covers it: with kSplit
// warps on each pixel, the warp of split index `split` searches the 32-face
// groups g of each chunk with (g / 32) % kSplit == split, and the caller
// takes the max of the kSplit keys (keys are unique within a face block, so
// the max does not depend on the split). Every thread of the block
// (kThreads of them, a power of two dividing kChunk * kRows) must call it
// with the same face range (it synchronises the block); `rect` is the
// calling warp's (warp_rect). smem holds kChunk * kRows floats, 16-byte
// aligned.
template <int kThreads, int kSplit>
__device__ __forceinline__ int block_best_key(const float* __restrict__ coef,
                                              float* smem, int F,
                                              int block_start, int block_end,
                                              int lane_mask, float px,
                                              float py, const Rect& rect,
                                              int split) {
  static_assert((kChunk * kRows) % kThreads == 0, "staging split");
  const int lane = threadIdx.x & 31;
  float next[kChunk * kRows / kThreads];
  fetch_chunk<kThreads>(coef, F, block_start, block_end, next);
  int best = -1;
  for (int s = block_start; s < block_end; s += kChunk) {
    const int n = min(kChunk, block_end - s);
    __syncthreads();  // the previous chunk is no longer being read
#pragma unroll
    for (int k = 0; k < kChunk * kRows / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      smem[(i % kChunk) * kRows + i / kChunk] = next[k];
    }
    __syncthreads();
    if (s + kChunk < block_end) {  // in flight while this chunk is searched
      fetch_chunk<kThreads>(coef, F, s + kChunk, block_end, next);
    }
    if (rect.empty) continue;  // uniform across the warp
    for (int g = 32 * split; g < n; g += 32 * kSplit) {
      const int f = g + lane;
      const float4* c = reinterpret_cast<const float4*>(&smem[f * kRows]);
      // rows: a0 b0 c0 | a1 b1 c1 | a2 b2 c2 | aw bw cw
      const float4 r0 = c[0];
      bool alive = f < n && !(rect_max(r0.x, r0.y, r0.z, rect) < 0.0f);
      if (!__any_sync(kFull, alive)) continue;  // uniform across the warp
      const float4 r1 = c[1], r2 = c[2];
      alive = alive && !(rect_max(r0.w, r1.x, r1.y, rect) < 0.0f ||
                         rect_max(r1.z, r1.w, r2.x, rect) < 0.0f ||
                         rect_max(r2.y, r2.z, r2.w, rect) <= 0.0f);
      unsigned live = __ballot_sync(kFull, alive);
      while (live) {  // ascending face order, uniform across the warp
        const int k = g + __ffs(live) - 1;
        live &= live - 1;
        const float4* c = reinterpret_cast<const float4*>(&smem[k * kRows]);
        const float4 r0 = c[0], r1 = c[1], r2 = c[2];  // broadcast reads
        const float e0 = form(px, py, r0.x, r0.y, r0.z);
        const float e1 = form(px, py, r0.w, r1.x, r1.y);
        const float e2 = form(px, py, r1.z, r1.w, r2.x);
        const float izp = form(px, py, r2.y, r2.z, r2.w);
        // Comparisons, not fminf: a NaN form must not count as covered
        // (fminf would drop it; jnp.minimum / torch.minimum propagate it).
        const bool covered =
            (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) && (izp > 0.0f);
        const int key =
            (__float_as_int(izp) & ~lane_mask) | (s + k - block_start);
        best = covered ? max(best, key) : best;
      }
    }
  }
  return best;
}

// The outputs of one pixel from its running key: iz -1 and winner 0 where no
// face covers it (the TPU kernels' init values).
__device__ __forceinline__ void store_winner(int acc_key, int acc_idx,
                                             int lane_mask, long long q,
                                             float* __restrict__ iz_out,
                                             int* __restrict__ winner_out) {
  iz_out[q] = acc_key < 0 ? -1.0f : __int_as_float(acc_key & ~lane_mask);
  winner_out[q] = acc_idx;
}

}  // namespace pass1
