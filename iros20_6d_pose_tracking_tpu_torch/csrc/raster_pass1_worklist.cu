// Rasterization pass 1 over a work list, for Hopper: K1's z-buffer winner
// search, computed only over the (pixels, face block) pairs whose bboxes
// intersect.
//
// Replaces the TPU kernel iros20_6d_pose_tracking_tpu/render/pallas_raster.py
// ::_wl_kernel (launched by pallas_pass1_worklist, its list made by
// build_worklist). Plain PyTorch version:
// render/raster_kernels.py::pass1_worklist_ref, which this kernel matches bit
// for bit; both give raster_pass1.cu's winners and 1/z.
//
// What it computes. The TPU's list names the (tile, face block) pairs that
// intersect: a tile is a run of pix_tile consecutive pixels, and block j is
// listed for it when its bbox meets the window's columns and the run's
// rows. A pixel searches exactly the blocks its run lists, with the
// packed-key search of raster_pass1_block.cuh; a later block replaces the
// running best only on a strict > (ROADMAP F2, K1's tie-break), and a pixel
// no listed face covers keeps the init values, iz -1 and winner 0.
//
// Why the order of work can go. The TPU walks its list in one sequential
// grid, tile-major with each tile's blocks ascending, and keeps a tile's
// accumulator resident across its entries. For each pixel the rule
// "ascending blocks, replace only on a strict >" ends on the block of
// largest key, ties going to the lowest block index: the lexicographic
// maximum of (key, -j). Keys are >= -1 and, their 1/z being no NaN, below
// 2^31 - 1, so
//     packed = ((uint64)(key + 1) << 32) | (n_blocks - 1 - j)
// orders exactly as (key, -j), and a 64-bit atomicMax gives the same bits
// in any order of work. Within a face block keys are unique (the lane is
// in the key), so the max over a block's faces is the same whatever chunks
// they are split into and in whatever order the chunks come. A pixel that
// no face of its listed blocks covers ends at 0, which decodes to the init
// values. So the outputs do not depend on the order of the items below.
//
// One device operation a call, nothing on the host waiting for the list:
// one cooperative launch (the grid resident whole, SM count times the
// blocks an SM holds) runs four phases with a grid-wide barrier between
// them, on one scratch buffer the wrapper allocates.
//   0. Zero one item counter per chunk.
//   A. bin: per 16 x 16 pixel patch (blocks take patches by grid stride),
//      zero its pixels' 64-bit accumulators and run the run test of every
//      face block for the runs its pixels lie in (each row of the patch
//      touches at most two runs, so at most 32 of them). For each block
//      some pixel of the patch needs, append the patch to the item list of
//      each chunk of min(kChunk, face_block) faces of that block (a chunk
//      never spans two blocks): an item is (patch, chunk), appended by one
//      atomicAdd on the chunk's counter into the chunk's room of n_patches
//      slots. The lists are unordered, and their counts never reach the
//      host.
//   B. search: the blocks take units of up to kUnit items of one chunk.
//      Per unit a thread block stages the chunk once; per item's patch, a
//      first level tests each staged face against the patch, and where some
//      face may reach it each warp bins the faces that passed against its 8
//      x 4 pixels, each pixel applies its own run test for the chunk's
//      block, and a pixel with a key >= 0 does one atomicMax of its packed
//      key.
//   C. decode: one thread per pixel, hi = packed >> 32: where hi = 0 the
//      init values, else key = hi - 1, iz = key & ~lane_mask as a float and
//      winner = (key & lane_mask) + j * face_block.
//
// What bounds it on this card: as K1, the coefficient and output bytes (0.00076
// ms for the production full frame); the (pixel, face) pairs it evaluates are
// K1's. On a sparse full frame (a small object in 480x640) neither bounds the
// time. The run test lists a face block for every patch of the object's rows,
// most of them far from it (4,320 (patch, chunk) items for the production mesh,
// chip_smoke.py's K3 lines). What the design does: no thread block walks a busy
// patch's blocks in series (its chunks are items of different units, spread
// over every SM); a chunk is staged once per unit, not per item; a patch no
// face can reach costs one test per face and one barrier; and one launch in
// place of four costs the host the least (the renders that call K3 are bound by
// the host's enqueue). What is left is latency and balance: a thread block's
// items run in series, and the blocks holding the most busy patches set the
// time of phase B.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "raster_pass1_block.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // one 16 x 16 pixel patch
constexpr int kPatch = 16;     // pixels a side of a patch
constexpr int kPatchW = 8;     // pixel columns of a warp's patch (phase B)
constexpr int kPatchH = 4;     // pixel rows of a warp's patch
constexpr int kRunsMax = 2 * kPatch;  // runs a patch's pixels lie in, at most
constexpr int kUnit = 4;  // items of one chunk a thread block takes at once
constexpr int kWarps = kThreads / 32;

using u64 = unsigned long long;

struct Args {
  const float* coef;        // (12, F)
  const float* block_bbox;  // (n_blocks, 4), rows read as float4
  int* counts;              // one item count per chunk
  int* items;               // chunk c's room: items[c * n_patches ...]
  u64* acc;                 // one packed key per pixel
  float* iz;
  int* winner;
  int F, n_blocks, face_block, chunk, H, W, pix_tile;
};

// Phase A for the patch at grid coordinates (bx, by): an item is the
// patch's coordinates, (by << 16) | bx. Every thread of the block calls it.
__device__ void bin_patch(const Args& a, int bx, int by, int n_patches) {
  __shared__ float run_y0[kRunsMax], run_y1[kRunsMax];
  __shared__ int n_runs;

  const int lane = threadIdx.x & 31;
  const int x = bx * kPatch + threadIdx.x % kPatch;
  const int y = by * kPatch + threadIdx.x / kPatch;
  if (x < a.W && y < a.H) a.acc[y * a.W + x] = 0ull;

  __syncthreads();  // the previous patch's runs are no longer being read
  if (threadIdx.x < 32) {
    // Lane 2r + h: the h-th run (h = 0, 1) that row r of the patch's pixels
    // lies in; a run is pix_tile >= 16 pixels, so a row of 16 touches two
    // at most. Its rows [y0, y1] are the ones the run test takes.
    const int r = by * kPatch + lane / 2;
    const int xa = bx * kPatch;
    const int xb = min(xa + kPatch - 1, a.W - 1);
    const int run_a = (r * a.W + xa) / a.pix_tile;
    const int run_b = (r * a.W + xb) / a.pix_tile;
    const bool valid = r < a.H && ((lane & 1) == 0 || run_b != run_a);
    const unsigned mask = __ballot_sync(pass1::kFull, valid);
    if (valid) {
      const int k = __popc(mask & ((1u << lane) - 1u));
      const int first = ((lane & 1) ? run_b : run_a) * a.pix_tile;
      run_y0[k] = static_cast<float>(first / a.W);
      run_y1[k] = static_cast<float>((first + a.pix_tile - 1) / a.W);
    }
    if (lane == 0) n_runs = __popc(mask);
  }
  __syncthreads();

  const float xlast = static_cast<float>(a.W) - 1.0f;
  const int per_block = a.face_block / a.chunk;
  // Thread t takes blocks t, t + 256, ...: K1's per-pixel test, any over
  // the patch's runs.
  for (int j = threadIdx.x; j < a.n_blocks; j += kThreads) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(a.block_bbox) + j);
    bool need = false;
    if ((b.y >= 0.0f) && (b.x <= xlast)) {  // xmax, xmin
      for (int k = 0; k < n_runs; ++k) {
        need = need || ((b.w >= run_y0[k]) && (b.z <= run_y1[k]));
      }
    }
    if (!need) continue;
    // Chunks past the last face (a partial last block) hold nothing.
    const int n =
        min(per_block, (a.F - j * a.face_block + a.chunk - 1) / a.chunk);
    for (int k = 0; k < n; ++k) {
      const int c = j * per_block + k;
      a.items[c * n_patches + atomicAdd(&a.counts[c], 1)] =
          (by << 16) | bx;
    }
  }
}

// Phase B. The thread block is a 16 x 16 pixel patch of 2 x 4 warp
// patches of 8 x 4 pixels, as K1's. Chunk c's room is cut into
// ceil(n_patches / kUnit) unit slots; while its count is k, slot i < m =
// ceil(k / kUnit) is a unit of items i, i + m, i + 2m, ... (so the object's
// patches, which lie near each other in the room, spread over the units),
// and the others are empty. The block takes slots blockIdx.x, blockIdx.x +
// gridDim.x, ..., looking 32 ahead at a time (one count load per lane).
// Counts and items were written in this launch, so they are read past the
// non-coherent caches (__ldcg).
//
// Per patch the binning runs in two levels: thread t tests staged face t
// against the rectangle of the patch's pixels in the window, widened by
// one pixel, and each warp then tests only the faces that pass against its
// own rectangle. The skip proof of raster_pass1_block.cuh holds for the
// patch's rectangle as for a warp's: a face the first level drops covers
// no pixel of the patch.
__device__ void search(const Args& a, int n_patches) {
  static_assert(kThreads == pass1::kChunk, "one staged face per thread");
  static_assert(kUnit <= kThreads, "a unit's patches are read by one load");
  // Face-major staging: face f's twelve rows at smem[f * 12 .. f * 12 + 11].
  __shared__ __align__(16) float smem[pass1::kChunk * pass1::kRows];
  __shared__ int unit_patch[kUnit];
  // Each warp's ballot of the first level, per patch; two sets, so a warp
  // may write the next patch's while another still reads this one's.
  __shared__ unsigned first_pass[2][kWarps];

  const int per_block = a.face_block / a.chunk;
  const int lane_mask = a.face_block - 1;
  const int units = (n_patches + kUnit - 1) / kUnit;
  const int n_slots = a.n_blocks * per_block * units;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kWarpsX = kPatch / kPatchW;
  const int dx = (warp % kWarpsX) * kPatchW + lane % kPatchW;
  const int dy = (warp / kWarpsX) * kPatchH + lane / kPatchW;
  const float xlast = static_cast<float>(a.W) - 1.0f;

  float next[pass1::kChunk * pass1::kRows / kThreads];
  int parity = 0;
  for (int u0 = blockIdx.x; u0 < n_slots; u0 += 32 * gridDim.x) {
    // Lane l looks at slot u0 + l * gridDim.x; every warp alike, so the
    // loop below is uniform across the block.
    const int u = u0 + lane * gridDim.x;
    int c = 0, count = 0, m = 1, i = 0;
    if (u < n_slots) {
      c = u / units;
      count = __ldcg(&a.counts[c]);
      m = (count + kUnit - 1) / kUnit;
      i = u - c * units;
    }
    unsigned todo = __ballot_sync(pass1::kFull, u < n_slots && i < m);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int uc = __shfl_sync(pass1::kFull, c, src);
      const int uk = __shfl_sync(pass1::kFull, count, src);
      const int um = __shfl_sync(pass1::kFull, m, src);
      const int ui = __shfl_sync(pass1::kFull, i, src);
      const int j = uc / per_block;
      const int s = j * a.face_block + (uc - j * per_block) * a.chunk;
      const int n = min(s + a.chunk, a.F) - s;
      pass1::fetch_chunk<kThreads>(a.coef, a.F, s, s + n, next);
      if (threadIdx.x < kUnit && ui + threadIdx.x * um < uk) {
        unit_patch[threadIdx.x] =
            __ldcg(&a.items[uc * n_patches + ui + threadIdx.x * um]);
      }
      pass1::stage_chunk<kThreads>(smem, next);  // publishes unit_patch too
      const float4 b =
          __ldg(reinterpret_cast<const float4*>(a.block_bbox) + j);
      for (int k = ui; k < uk; k += um) {
        const int patch_xy = unit_patch[(k - ui) / um];
        const int x0 = (patch_xy & 0xffff) * kPatch;
        const int y0 = (patch_xy >> 16) * kPatch;
        const pass1::Rect box{
            static_cast<float>(x0 - 1),
            static_cast<float>(min(x0 + kPatch - 1, a.W - 1) + 1),
            static_cast<float>(y0 - 1),
            static_cast<float>(min(y0 + kPatch - 1, a.H - 1) + 1), false};
        const bool pass = static_cast<int>(threadIdx.x) < n &&
                          pass1::may_cover(smem, threadIdx.x, box);
        const unsigned ballot = __ballot_sync(pass1::kFull, pass);
        if (lane == 0) first_pass[parity][warp] = ballot;
        // A patch no face can reach (most, on a sparse frame) ends here.
        const bool any = __syncthreads_or(pass);
        const unsigned* groups = first_pass[parity];
        parity ^= 1;
        if (!any) continue;  // uniform across the block
        const int x = x0 + dx;
        const int y = y0 + dy;
        // The pixel's own run test for block j, as K1's (rows past the
        // window's last one are harmless: no face covers them).
        const int q = y * a.W + x;
        const int first_q = (q / a.pix_tile) * a.pix_tile;
        const float ry0 = static_cast<float>(first_q / a.W);
        const float ry1 = static_cast<float>((first_q + a.pix_tile - 1) / a.W);
        // b: xmin, xmax, ymin, ymax.
        const bool hit = x < a.W && y < a.H && (b.y >= 0.0f) &&
                         (b.x <= xlast) && (b.w >= ry0) && (b.z <= ry1);
        // The rectangle of the warp's pixels that need the block: the skip
        // proof holds for any rectangle around the pixels that use the key.
        const pass1::Rect rect = pass1::warp_rect(x, y, hit);
        int best = -1;
        for (int g = 0; g < kWarps && !rect.empty; ++g) {  // warp-uniform
          const unsigned group = groups[g];
          if (!group) continue;
          const int f = 32 * g + lane;
          unsigned keep = __ballot_sync(
              pass1::kFull,
              ((group >> lane) & 1u) && pass1::may_cover(smem, f, rect));
          while (keep) {  // ascending face order
            const int k = 32 * g + __ffs(keep) - 1;
            keep &= keep - 1;
            best = max(best, pass1::face_key(smem, k, s, lane_mask,
                                             static_cast<float>(x),
                                             static_cast<float>(y)));
          }
        }
        if (hit && best >= 0) {
          atomicMax(&a.acc[q], (static_cast<u64>(best + 1) << 32) |
                                   static_cast<u64>(a.n_blocks - 1 - j));
        }
      }
    }
  }
}

// The three phases in one cooperative launch (the grid is resident whole:
// SM count times the blocks an SM holds), a grid-wide barrier between
// them: 0 zeroes the counts; A bins every patch (blocks take patches by
// grid stride); B searches; C decodes, one thread per pixel by grid stride.
__global__ void __launch_bounds__(kThreads, 4)
    raster_pass1_worklist_kernel(Args a) {
  const cg::grid_group grid = cg::this_grid();
  const int n_chunks = a.n_blocks * (a.face_block / a.chunk);
  const int patches_x = (a.W + kPatch - 1) / kPatch;
  const int n_patches = patches_x * ((a.H + kPatch - 1) / kPatch);
  const int thread = blockIdx.x * kThreads + threadIdx.x;
  const int n_threads = gridDim.x * kThreads;

  for (int c = thread; c < n_chunks; c += n_threads) a.counts[c] = 0;
  grid.sync();
  for (int p = blockIdx.x; p < n_patches; p += gridDim.x) {
    bin_patch(a, p % patches_x, p / patches_x, n_patches);
  }
  grid.sync();
  search(a, n_patches);
  grid.sync();
  const int lane_mask = a.face_block - 1;
  for (int q = thread; q < a.H * a.W; q += n_threads) {
    const u64 v = __ldcg(&a.acc[q]);
    const int hi = static_cast<int>(v >> 32);
    const int key = hi - 1;  // -1 where no face covers the pixel
    const int j = a.n_blocks - 1 - static_cast<int>(v & 0xffffffffull);
    pass1::store_winner(key, hi ? (key & lane_mask) + j * a.face_block : 0,
                        lane_mask, q, a.iz, a.winner);
  }
}

// Chunks of face_block faces each block holds.
int chunks_per_block(int face_block) {
  return face_block / min(pass1::kChunk, face_block);
}

// Bytes of scratch a call needs (the wrapper's _k3_scratch_bytes), in
// 8-byte words: the counts (n_chunks ints), one 64-bit accumulator per
// pixel, and n_chunks rooms of n_patches items (ints), n_patches =
// ceil(H / 16) * ceil(W / 16), n_chunks = n_blocks * chunks_per_block. -1
// when a count would not fit an int.
long long scratch_bytes_needed(int n_blocks, int face_block, int H, int W) {
  if (n_blocks < 0 || face_block <= 0 || H < 0 || W < 0) return -1;
  const long long n_chunks =
      static_cast<long long>(n_blocks) * chunks_per_block(face_block);
  const long long patches = static_cast<long long>((H + kPatch - 1) / kPatch) *
                            ((W + kPatch - 1) / kPatch);
  const long long units = (patches + kUnit - 1) / kUnit;
  if (n_chunks * patches > INT_MAX || n_chunks * units > INT_MAX) return -1;
  return 8 * ((n_chunks + 1) / 2 + static_cast<long long>(H) * W +
              (n_chunks * patches + 1) / 2);
}

}  // namespace

extern "C" {

// coef: (12, F) f32; block_bbox: (n_blocks, 4) f32 [xmin, xmax, ymin,
// ymax], n_blocks = ceil(F / face_block), 16-byte aligned (its rows are
// read as float4); scratch: scratch_bytes >= scratch_bytes_needed(...)
// bytes, 8-byte aligned, its contents undefined; iz, winner: (H * W,) f32 /
// i32 outputs. face_block is a power of two; pix_tile, the run of pixels
// the block bbox test takes at a time, is at least 16; both sides of the
// patch grid are below 2^15 and the pixel count, padded to whole patches,
// plus pix_tile is at most 2^31 - 1. All pointers live on the current CUDA
// device, which the caller sets; one cooperative kernel is queued on
// `stream` and nothing synchronises.
int raster_pass1_worklist(const void* coef, const void* block_bbox,
                          void* scratch, long long scratch_bytes, void* iz,
                          void* winner, int F, int n_blocks, int face_block,
                          int H, int W, int pix_tile, void* stream) {
  if (H == 0 || W == 0) return 0;
  const long long need = scratch_bytes_needed(n_blocks, face_block, H, W);
  const int grid_x = (W + kPatch - 1) / kPatch;
  const int grid_y = (H + kPatch - 1) / kPatch;
  const long long q_max =
      static_cast<long long>(grid_y) * kPatch * grid_x * kPatch + pix_tile;
  if (need < 0 || scratch_bytes < need || pix_tile < kPatch ||
      (face_block & (face_block - 1)) || grid_x >= (1 << 15) ||
      grid_y >= (1 << 15) || q_max > INT_MAX ||
      n_blocks != (F + face_block - 1) / face_block ||
      reinterpret_cast<uintptr_t>(block_bbox) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = n_blocks * chunks_per_block(face_block);
  u64* acc = static_cast<u64*>(scratch) + (n_chunks + 1) / 2;
  Args args{static_cast<const float*>(coef),
            static_cast<const float*>(block_bbox),
            static_cast<int*>(scratch),
            reinterpret_cast<int*>(acc + static_cast<long long>(H) * W),
            acc,
            static_cast<float*>(iz),
            static_cast<int*>(winner),
            F,
            n_blocks,
            face_block,
            min(pass1::kChunk, face_block),
            H,
            W,
            pix_tile};

  // The grid, SM count times the blocks an SM holds, per device: host
  // values, asked for once (two threads may both ask; they agree).
  constexpr int kMaxDevices = 64;
  static int grid_of[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device < 0 || device >= kMaxDevices)) {
    err = cudaErrorInvalidDevice;
  }
  if (err == cudaSuccess && grid_of[device] == 0) {
    int sms = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, raster_pass1_worklist_kernel, kThreads, 0);
    }
    if (err == cudaSuccess) grid_of[device] = sms * per_sm;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(raster_pass1_worklist_kernel),
      grid_of[device], kThreads, params, 0,
      static_cast<cudaStream_t>(stream)));
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
