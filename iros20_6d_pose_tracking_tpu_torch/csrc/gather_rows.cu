// Pass-2 row gather for Hopper: rows[p, :] = covered[p] ? attr[winner[p], :] : 0.
//
// Replaces the TPU kernel iros20_6d_pose_tracking_tpu/render/pallas_raster.py
// ::_gather_kernel (launched by pallas_gather_rows). The TPU has no vector
// gather, so that kernel selects rows with one-hot matmuls on the MXU over a
// 3-term bf16 split of the f32 attributes. Hopper loads the row directly, so
// the split is not needed and the copy is bit-exact by construction. Plain
// PyTorch version: render/raster_kernels.py::gather_rows_ref.
//
// What bounds it on this card. Bytes: it does no arithmetic. At a 176^2
// window with 30 attribute columns it writes 3.7 MB and reads the winner
// rows (mostly from L2: a 2048-face attribute table is 246 KB).
//
// What the design does about it. One thread per output element (pixel,
// column), consecutive threads on consecutive columns of a pixel and then on
// the next pixel, so the stores are fully coalesced and the row reads of one
// pixel are contiguous. Winners outside [0, F) read as 0 rather than out of
// bounds. Fusing this gather into the shading that consumes the rows (so the
// rows never reach device memory) is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const float* __restrict__ attr,
                                   const int* __restrict__ winner,
                                   const bool* __restrict__ covered,
                                   float* __restrict__ rows, int F, int C,
                                   long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long p = i / C;
  const int c = static_cast<int>(i - p * C);
  const int w = winner[p];
  float v = 0.0f;
  if (covered[p] && w >= 0 && w < F) v = attr[static_cast<long long>(w) * C + c];
  rows[i] = v;
}

}  // namespace

extern "C" {

// attr: (F, C) f32; winner: (P,) i32; covered: (P,) bool; rows: (P, C) f32.
// All pointers live on the current CUDA device, which the caller sets; the
// kernel is queued on `stream` and nothing synchronises.
int gather_rows(const void* attr, const void* winner, const void* covered,
                void* rows, int F, int C, int P, void* stream) {
  const long long total = static_cast<long long>(P) * C;
  if (total == 0) return 0;
  const int threads = 256;
  const long long grid = (total + threads - 1) / threads;
  gather_rows_kernel<<<static_cast<unsigned>(grid), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attr), static_cast<const int*>(winner),
      static_cast<const bool*>(covered), static_cast<float*>(rows), F, C,
      total);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
