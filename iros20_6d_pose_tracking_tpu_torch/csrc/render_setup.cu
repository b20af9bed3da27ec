// Render set-up for Hopper: the front end between a pose and pass 1, in one
// kernel. Per view and face: the corners rotated and translated into the
// camera, the near test, 1/z and the window's pixel coordinates; pass 1's
// coefficient rows and pass 2's attribute forms; with the back-face cull,
// the back-face test, the poison rows and the stable partition of the kept
// faces to the front of every table; and the face blocks' screen bboxes.
//
// Replaces no TPU kernel: on the TPU the front end is XLA's fusion of
// iros20_6d_pose_tracking_tpu/render/rasterizer.py::_project,
// _face_attr_coefficients, _backface_mask and _compact_front with
// render/pallas_raster.py's build_face_coefficients and block bboxes. Run
// eagerly by PyTorch those are about 230 small launches a render. Plain
// PyTorch version: render/raster_kernels.py::render_setup_ref, that
// composition itself.
//
// Bits. Every product and sum is rounded where the plain version's torch op
// on the card rounds it (__fmul_rn, __fadd_rn, __frcp_rn, __fdiv_rn; this
// file asks for no contraction). The exceptions follow torch's own kernels:
// a rotation is cuBLAS's K = 3 product, an FMA chain in k order; a sum over
// an innermost axis of 3 is split over two threads, (e0 + e2) + e1, and one
// over an outer axis walked in order, each from a zero start; a mean is that
// sum times 1/3 in float32; a cross product component is ATen's a*b - c*d
// with the first product fused.
//
// What bounds it on this card. Latency, then the load/store unit. The work
// is a few hundred float32 operations a face: 3072 faces are 1 MFLOP, 0.015
// us at the float32 peak; the mesh read (a face's 9 positions, 9 normals, 9
// colours, its mask: 109 bytes) and the tables written (coef 48, attribute
// forms 120 or 144, bboxes 16 / face_block bytes a face) take 0.25 us at
// 3.35 TB/s for one 3072-face view, 62 us for the sampler's 400 views. One
// view is too little work for the card, so a tracking render's time is a
// short chain of dependent loads, arithmetic, barriers and stores; 400 views
// are bytes and the load/store unit's transactions.
//
// What the design does about it. A view is a cluster of up to 8 thread
// blocks while the views leave SMs idle (one block a view once they fill the
// card), each block a contiguous run of faces, a face a thread. Without the
// cull one pass writes every face's rows at its own index. With it, a first
// pass computes each face's keep bit (near test, mask, back-face test) into
// a bit word a warp in shared memory and counts the block's kept faces; after
// a cluster barrier every block reads the counts of the blocks before it
// through distributed shared memory, and the second pass recomputes each
// face and writes it at its rank: kept faces first in face order, then the
// dropped ones, each rank from the bit words' population counts. A warp
// stages its 32 faces' mesh data through shared memory (each load a warp's
// 32 consecutive floats), and its 32 attribute rows on the way out (rows of
// consecutive ranks are one contiguous span), so a row of 30 floats costs
// the load/store unit one transaction a warp instead of 30. The face
// blocks' bboxes are kept in the cluster's first block as order-preserving
// ints (a NaN coordinate, which the plain version's min and max propagate,
// wins both), reduced over the lanes of a warp that land in one face block,
// then folded in with shared atomics; min and max of ints give the same
// bits in any order.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kMaxRanks = 8;    // blocks of a view's cluster (portable)
constexpr int kMinFaces = 128;  // a cluster's block has at least these
constexpr int kMaxSmem = 100 * 1024;  // dynamic shared memory a block
constexpr float kBig = 3.0e8f;     // raster_kernels._BIG, an empty bbox
constexpr float kMinArea = 1e-4f;  // below it a face is degenerate
constexpr float kThird = 1.0f / 3.0f;  // torch's mean factor over 3

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch's sum over an innermost axis of 3: two threads of the reduction,
// the first over e0 and e2, then the second's e1.
__device__ __forceinline__ float sum3_inner(float e0, float e1, float e2) {
  return add(add(add(0.0f, e0), e2), e1);
}
// torch's sum over an outer axis of 3: one thread walks it.
__device__ __forceinline__ float sum3_outer(float e0, float e1, float e2) {
  return add(add(add(0.0f, e0), e1), e2);
}
// cuBLAS's row . column at K = 3 (x @ R^T): an FMA chain in k order.
__device__ __forceinline__ float gemm3(float x0, float x1, float x2,
                                       float r0, float r1, float r2) {
  return __fmaf_rn(x2, r2, __fmaf_rn(x1, r1, mul(x0, r0)));
}
// ATen's cross-product component a*b - c*d, compiled with the first product
// fused into the subtraction.
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fmaf_rn(a, b, -mul(c, d));
}
// torch.sign: 0 for 0 and NaN.
__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}
// torch's amin and amax: a NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// Signed ints in the order of the floats; a NaN maps to the extreme that
// wins (INT_MIN for a min, INT_MAX for a max), which no other float maps to.
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ int min_key(float x) {
  return isnan(x) ? INT_MIN : ordered(x);
}
__device__ __forceinline__ int max_key(float x) {
  return isnan(x) ? INT_MAX : ordered(x);
}
__device__ __forceinline__ float from_key(int k) {
  if (k == INT_MIN || k == INT_MAX) return __int_as_float(0x7fffffff);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The thread block cluster, in PTX (cooperative_groups' header triples the
// build time): this block's rank and the cluster's size, a barrier over the
// cluster (release, then acquire: shared memory written before it is seen
// by every block after it), and another block's copy of a shared variable.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}
template <class T>
__device__ __forceinline__ T* in_block(T* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

struct Args {
  const float* fverts;    // ([B,] F, 3, 3) object-space corners
  const float* fnormals;  // ([B,] F, 3, 3)
  const float* fcolors;   // ([B,] F, 3, 3)
  const float* fuvs;      // ([B,] F, 3, 2) or null
  const unsigned char* fmask;  // ([B,] F) bool
  const float* pose;      // (B, 4, 4)
  const float* K;         // (3, 3)
  const float* window;    // (B, 4) or null: then win
  float win[4];           // left, right, top, bottom
  float* coef;            // (B, 12, F)
  float* block_bbox;      // (B, n_blocks, 4)
  float* attr;            // (B, F, C)
  int F, C, face_block, n_blocks, n_words, H, W, cull, stacked;
  float near;
};

// A view's pose, intrinsics and window scale.
struct View {
  float R[3][3], t[3];
  float fx, cx, fy, cy;
  float left, top, sx, sy;
};

__device__ View load_view(const Args& a, int view) {
  View v;
  const float* P = a.pose + 16 * view;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v.R[j][k] = P[4 * j + k];
    v.t[j] = P[4 * j + 3];
  }
  v.fx = a.K[0];
  v.cx = a.K[2];
  v.fy = a.K[4];
  v.cy = a.K[5];
  const float* w = a.window ? a.window + 4 * view : a.win;
  v.left = w[0];
  v.top = w[2];
  // torch.full_like(right, W) / (right - left): a correctly rounded division.
  v.sx = __fdiv_rn(static_cast<float>(a.W), sub(w[1], w[0]));
  v.sy = __fdiv_rn(static_cast<float>(a.H), sub(w[3], w[2]));
  return v;
}

// x @ R^T + t for one corner.
__device__ __forceinline__ void to_camera(const View& v, const float* x,
                                          float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j] = add(gemm3(x[0], x[1], x[2], v.R[j][0], v.R[j][1], v.R[j][2]),
                 v.t[j]);
  }
}

// One face's mesh data, read from a warp's stage.
struct Face {
  float x[9];    // corners, object space
  float n[9];    // corner normals
  float col[9];  // corner colours
  float uv[6];   // corner UVs (textured meshes)
  bool mask;     // not padding
};

// Face survives the cull: every corner beyond the near plane, not padding,
// and its geometric normal (oriented by the mean shading normal) not
// pointing away from the camera (rasterizer._backface_mask).
__device__ bool face_kept(const Args& a, const View& v, const Face& q) {
  float p[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) to_camera(v, q.x + 3 * c, p[c]);
  if (!q.mask || !(p[0][2] > a.near) || !(p[1][2] > a.near) ||
      !(p[2][2] > a.near)) {
    return false;
  }
  float e1[3], e2[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    e1[j] = sub(p[1][j], p[0][j]);
    e2[j] = sub(p[2][j], p[0][j]);
  }
  float gn[3] = {cross_term(e1[1], e2[2], e1[2], e2[1]),
                 cross_term(e1[2], e2[0], e1[0], e2[2]),
                 cross_term(e1[0], e2[1], e1[1], e2[0])};
  float nm[3], na[3], cen[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    nm[j] = mul(sum3_outer(q.n[j], q.n[3 + j], q.n[6 + j]), kThird);
    cen[j] = mul(sum3_outer(p[0][j], p[1][j], p[2][j]), kThird);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    na[j] = gemm3(nm[0], nm[1], nm[2], v.R[j][0], v.R[j][1], v.R[j][2]);
  }
  const float s = sign_of(sum3_inner(mul(gn[0], na[0]), mul(gn[1], na[1]),
                                     mul(gn[2], na[2])));
  const float d = sum3_inner(mul(mul(gn[0], s), cen[0]),
                             mul(mul(gn[1], s), cen[1]),
                             mul(mul(gn[2], s), cen[2]));
  return !(d > 0.0f);
}

// The three attribute forms of one attribute group of ch channels (corner c,
// channel k at src[c * ch + k]): [a_k..., b_k..., c_k...], each
// sum_c form_c * src_c,k walked over the corners in order.
template <int ch>
__device__ __forceinline__ void attr_group(const float* src, const float aw[3],
                                           const float bw[3],
                                           const float cw[3], float* out) {
#pragma unroll
  for (int k = 0; k < ch; ++k) {
    const float s0 = src[k], s1 = src[ch + k], s2 = src[2 * ch + k];
    out[k] = sum3_outer(mul(aw[0], s0), mul(aw[1], s1), mul(aw[2], s2));
    out[ch + k] = sum3_outer(mul(bw[0], s0), mul(bw[1], s1), mul(bw[2], s2));
    out[2 * ch + k] =
        sum3_outer(mul(cw[0], s0), mul(cw[1], s1), mul(cw[2], s2));
  }
}

// One face at row `dest` of the view's tables: pass 1's twelve coefficient
// rows written (poisoned, never covered, unless searched and well formed),
// the attribute forms into `row` (the caller writes it out), and the face's
// screen bbox (empty unless searched) into bb. Searched: the keep bit with
// the cull, fvalid without.
__device__ void face_tables(const Args& a, const View& v, const Face& q,
                            float* coef, bool cull_keep, float* row,
                            float bb[4]) {
  float fx[3], fy[3], fiz[3];
  bool valid = q.mask;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float p[3];
    to_camera(v, q.x + 3 * c, p);
    const bool ok_z = p[2] > a.near;
    valid = valid && ok_z;
    fiz[c] = ok_z ? __frcp_rn(p[2]) : 0.0f;
    const float u = add(mul(mul(p[0], v.fx), fiz[c]), v.cx);
    const float w = add(mul(mul(p[1], v.fy), fiz[c]), v.cy);
    fx[c] = sub(mul(sub(u, v.left), v.sx), 0.5f);
    fy[c] = sub(mul(sub(w, v.top), v.sy), 0.5f);
  }
  const float a0 = sub(fy[1], fy[2]), b0 = sub(fx[2], fx[1]);
  const float a1 = sub(fy[2], fy[0]), b1 = sub(fx[0], fx[2]);
  const float a2 = sub(fy[0], fy[1]), b2 = sub(fx[1], fx[0]);
  const float c0 = sub(mul(fx[1], fy[2]), mul(fx[2], fy[1]));
  const float c1 = sub(mul(fx[2], fy[0]), mul(fx[0], fy[2]));
  const float c2 = sub(mul(fx[0], fy[1]), mul(fx[1], fy[0]));
  const float area = add(add(mul(a0, fx[0]), mul(b0, fy[0])), c0);
  const bool ok = valid && fabsf(area) > kMinArea;
  const float inv_area = ok ? __frcp_rn(area) : 0.0f;
  const float w0 = mul(fiz[0], inv_area), w1 = mul(fiz[1], inv_area),
              w2 = mul(fiz[2], inv_area);
  const float aw[3] = {mul(a0, w0), mul(a1, w1), mul(a2, w2)};
  const float bw[3] = {mul(b0, w0), mul(b1, w1), mul(b2, w2)};
  const float cw[3] = {mul(c0, w0), mul(c1, w1), mul(c2, w2)};

  // Pass 1's rows (raster_kernels.build_face_coefficients), sign-folded;
  // consecutive lanes write consecutive ranks of a row.
  const bool searched = a.cull ? cull_keep : valid;
  const bool live = ok && (!a.cull || cull_keep);
  const float s = area >= 0.0f ? 1.0f : -1.0f;
  const float rows[12] = {
      mul(a0, s), mul(b0, s), mul(c0, s), mul(a1, s), mul(b1, s), mul(c1, s),
      mul(a2, s), mul(b2, s), mul(c2, s),
      add(add(aw[0], aw[1]), aw[2]), add(add(bw[0], bw[1]), bw[2]),
      add(add(cw[0], cw[1]), cw[2])};
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const bool c_row = r == 2 || r == 5 || r == 8;
    coef[static_cast<long long>(r) * a.F] =
        live ? rows[r] : (c_row ? -1.0f : 0.0f);
  }

  // Pass 2's attribute forms (rasterizer._face_attr_coefficients).
  row[0] = sum3_inner(aw[0], aw[1], aw[2]);
  row[1] = sum3_inner(bw[0], bw[1], bw[2]);
  row[2] = sum3_inner(cw[0], cw[1], cw[2]);
  attr_group<3>(q.col, aw, bw, cw, row + 3);
  attr_group<3>(q.n, aw, bw, cw, row + 12);
  attr_group<3>(q.x, aw, bw, cw, row + 21);
  if (a.fuvs) attr_group<2>(q.uv, aw, bw, cw, row + 30);

  // The face's bbox (raster_kernels.build_face_bboxes).
  if (searched) {
    bb[0] = min_nan(min_nan(fx[0], fx[1]), fx[2]);
    bb[1] = max_nan(max_nan(fx[0], fx[1]), fx[2]);
    bb[2] = min_nan(min_nan(fy[0], fy[1]), fy[2]);
    bb[3] = max_nan(max_nan(fy[0], fy[1]), fy[2]);
  }
}

// A warp's stage: room for 32 faces' positions, normals, colours and UVs
// (33 floats a face) on the way in, and for their attribute rows on the way
// out (rows 37 floats apart, an odd stride, so a lane's row writes hit 32
// different banks).
constexpr int kRowStride = 37;
constexpr int kStage = 32 * kRowStride;  // >= 32 * 33

// Copies `count` consecutive floats from src into a warp's stage, each load
// a warp's 32 consecutive floats.
__device__ __forceinline__ void stage_in(float* st, const float* src,
                                         int count, int lane) {
  for (int i = lane; i < count; i += 32) st[i] = src[i];
}

// Lane `lane`'s face of the n the warp staged (k floats a face at st).
template <int k>
__device__ __forceinline__ void unstage(const float* st, int lane,
                                        float* out) {
#pragma unroll
  for (int j = 0; j < k; ++j) out[j] = st[k * lane + j];
}

// Stages the n faces from `face` (an index into the view's mesh arrays) and
// returns the lane's. With `all` the colours and UVs too.
__device__ Face load_faces(const Args& a, float* st, long long face, int n,
                           int lane, bool all) {
  stage_in(st, a.fverts + 9 * face, 9 * n, lane);
  stage_in(st + 9 * 32, a.fnormals + 9 * face, 9 * n, lane);
  if (all) {
    stage_in(st + 18 * 32, a.fcolors + 9 * face, 9 * n, lane);
    if (a.fuvs) stage_in(st + 27 * 32, a.fuvs + 6 * face, 6 * n, lane);
  }
  __syncwarp();
  Face q;
  q.mask = lane < n && a.fmask[face + lane];
  if (lane < n) {
    unstage<9>(st, lane, q.x);
    unstage<9>(st + 9 * 32, lane, q.n);
    if (all) {
      unstage<9>(st + 18 * 32, lane, q.col);
      if (a.fuvs) unstage<6>(st + 27 * 32, lane, q.uv);
    }
  }
  __syncwarp();
  return q;
}

__global__ void __launch_bounds__(kMaxThreads)
    render_setup_kernel(const Args a) {
  const int n_ranks = cluster_size();
  const int rank = cluster_rank();
  // acc: the face blocks' bbox keys, 4 a block (rank 0's gather the
  // cluster's); dst: a warp's 32 ranks; words: the keep bits, a word per
  // warp and pass over the faces (with the cull); then the warps' stages.
  extern __shared__ int smem[];
  const int n_warps = blockDim.x >> 5;
  int* acc = smem;
  int* dst_all = acc + 4 * a.n_blocks;
  unsigned* words = reinterpret_cast<unsigned*>(dst_all + 32 * n_warps);
  float* stages = reinterpret_cast<float*>(words + a.n_words);
  __shared__ int n_keep;

  const int view = blockIdx.x / n_ranks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* dst = dst_all + 32 * warp;
  float* st = stages + kStage * warp;
  // This block's faces of the view: [f_lo, f_hi), whole warps.
  const int per = ((a.F + n_ranks - 1) / n_ranks + 31) & ~31;
  const int f_lo = min(a.F, rank * per);
  const int f_hi = min(a.F, f_lo + per);
  const long long mesh_face0 =
      a.stacked ? static_cast<long long>(view) * a.F : 0;
  const View v = load_view(a, view);

  for (int i = tid; i < 4 * a.n_blocks; i += blockDim.x) {
    acc[i] = (i & 1) ? INT_MIN : INT_MAX;  // xmin, xmax, ymin, ymax
  }
  if (tid == 0) n_keep = 0;
  __syncthreads();

  if (a.cull) {
    for (int base = f_lo; base < f_hi; base += blockDim.x) {
      const int fw = base + 32 * warp;  // the warp's first face
      const int n = max(0, min(32, f_hi - fw));
      const Face q = load_faces(a, st, mesh_face0 + fw, n, lane, false);
      const bool keep = lane < n && face_kept(a, v, q);
      const unsigned w = __ballot_sync(kFull, keep);
      if (lane == 0) {
        words[((base - f_lo) >> 5) + warp] = w;
        atomicAdd(&n_keep, __popc(w));
      }
    }
  }
  // Every block's keep count (and rank 0's cleared acc) in view of all.
  cluster_sync();
  int kept_before = 0, kept_total = 0;  // over the blocks before this one
  for (int r = 0; r < n_ranks; ++r) {
    const int n = *in_block(&n_keep, r);
    kept_before += r < rank ? n : 0;
    kept_total += n;
  }
  int* acc0 = in_block(acc, 0);

  float* coef_view = a.coef + static_cast<long long>(view) * 12 * a.F;
  float* attr_view = a.attr + static_cast<long long>(view) * a.F * a.C;
  for (int base = f_lo; base < f_hi; base += blockDim.x) {
    const int fw = base + 32 * warp;
    const int n = max(0, min(32, f_hi - fw));
    const int f = fw + lane;
    const bool in = lane < n;
    int dest = f;
    bool keep = false;
    if (a.cull) {
      const unsigned* pass_words = words + ((base - f_lo) >> 5);
      int before = kept_before;
      int pass_total = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int k = __popc(pass_words[w]);
        before += w < warp ? k : 0;
        pass_total += k;
      }
      const unsigned mine = pass_words[warp];
      before += __popc(mine & ((1u << lane) - 1u));
      keep = (mine >> lane) & 1u;
      // Kept faces in face order, then the dropped ones.
      dest = keep ? before : kept_total + (f - before);
      kept_before += pass_total;
    }
    const Face q = load_faces(a, st, mesh_face0 + fw, n, lane, true);
    float bb[4] = {kBig, -kBig, kBig, -kBig};
    if (in) {
      face_tables(a, v, q, coef_view + dest, keep, st + kRowStride * lane,
                  bb);
    }
    dst[lane] = dest;
    __syncwarp();
    // The rows out of the stage, a warp's consecutive floats at a time
    // (a run of consecutive ranks is one contiguous span).
    for (int i = lane; i < n * a.C; i += 32) {
      const int r = i / a.C;
      const int c = i - r * a.C;
      attr_view[static_cast<long long>(dst[r]) * a.C + c] =
          st[kRowStride * r + c];
    }
    __syncwarp();
    const int block = dest / a.face_block;
    const int k0 = min_key(bb[0]), k1 = max_key(bb[1]);
    const int k2 = min_key(bb[2]), k3 = max_key(bb[3]);
    // Fold the lanes of each face block together, then into rank 0's keys.
    unsigned todo = __ballot_sync(kFull, in);
    while (todo) {
      const int leader = __ffs(todo) - 1;
      const int jb = __shfl_sync(kFull, block, leader);
      const bool mine = in && block == jb && ((todo >> lane) & 1u);
      const unsigned group = __ballot_sync(kFull, mine);
      const int r0 = __reduce_min_sync(kFull, mine ? k0 : INT_MAX);
      const int r1 = __reduce_max_sync(kFull, mine ? k1 : INT_MIN);
      const int r2 = __reduce_min_sync(kFull, mine ? k2 : INT_MAX);
      const int r3 = __reduce_max_sync(kFull, mine ? k3 : INT_MIN);
      if (lane == leader) {
        atomicMin(&acc0[4 * jb + 0], r0);
        atomicMax(&acc0[4 * jb + 1], r1);
        atomicMin(&acc0[4 * jb + 2], r2);
        atomicMax(&acc0[4 * jb + 3], r3);
      }
      todo &= ~group;
    }
  }
  cluster_sync();
  if (rank == 0) {
    float* bbox =
        a.block_bbox + static_cast<long long>(view) * 4 * a.n_blocks;
    for (int i = tid; i < 4 * a.n_blocks; i += blockDim.x) {
      bbox[i] = from_key(acc[i]);
    }
  }
}

int g_sms[64];         // SMs of each device, read once
int g_smem_set[64];    // the kernel's dynamic shared memory limit set

}  // namespace

extern "C" {

// fverts, fnormals, fcolors: ([B,] F, 3, 3) f32, one mesh for every view or
// (stacked != 0) one a view; fuvs ([B,] F, 3, 2) f32 or null; fmask ([B,] F)
// bool; pose (B, 4, 4) f32; K (3, 3) f32; window (B, 4) f32 [left, right,
// top, bottom], or null and the four numbers w_* for every view. Outputs:
// coef (B, 12, F), block_bbox (B, F / face_block, 4), attr (B, F, 30 or 36
// with fuvs) f32. face_block divides F; cull != 0 culls back faces and
// partitions the kept faces to the front. All pointers live on the current
// CUDA device, which the caller sets; the kernel is queued on `stream` and
// nothing synchronises.
int render_setup(const void* fverts, const void* fnormals, const void* fcolors,
                 const void* fuvs, const void* fmask, const void* pose,
                 const void* K, const void* window, float w_left,
                 float w_right, float w_top, float w_bottom, void* coef,
                 void* block_bbox, void* attr, int B, int F, int face_block,
                 int H, int W, float near, int cull, int stacked,
                 void* stream) {
  if (B == 0 || F == 0) return 0;
  if (B < 0 || F < 0 || face_block <= 0 || F % face_block || H <= 0 ||
      W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = g_sms[device];
  // A cluster of blocks a view while the views leave SMs idle, each block
  // at least kMinFaces faces; the blocks as wide as their faces.
  int ranks = 1;
  while (ranks < kMaxRanks && 2LL * ranks * B <= sms &&
         F / (2 * ranks) >= kMinFaces) {
    ranks *= 2;
  }
  const int per = ((F + ranks - 1) / ranks + 31) & ~31;
  const int threads = B >= sms ? 256 : min(kMaxThreads, per);
  const int n_warps = threads / 32;
  const int n_words = cull ? (per + threads - 1) / threads * n_warps : 0;
  const int n_blocks = F / face_block;
  const long long smem =
      4LL * (4LL * n_blocks + 32 * n_warps + n_words) +
      4LL * kStage * n_warps;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > g_smem_set[device]) {
    err = cudaFuncSetAttribute(render_setup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[device] = kMaxSmem;
  }
  Args a;
  a.fverts = static_cast<const float*>(fverts);
  a.fnormals = static_cast<const float*>(fnormals);
  a.fcolors = static_cast<const float*>(fcolors);
  a.fuvs = static_cast<const float*>(fuvs);
  a.fmask = static_cast<const unsigned char*>(fmask);
  a.pose = static_cast<const float*>(pose);
  a.K = static_cast<const float*>(K);
  a.window = static_cast<const float*>(window);
  a.win[0] = w_left;
  a.win[1] = w_right;
  a.win[2] = w_top;
  a.win[3] = w_bottom;
  a.coef = static_cast<float*>(coef);
  a.block_bbox = static_cast<float*>(block_bbox);
  a.attr = static_cast<float*>(attr);
  a.F = F;
  a.C = fuvs ? 36 : 30;
  a.face_block = face_block;
  a.n_blocks = n_blocks;
  a.n_words = n_words;
  a.H = H;
  a.W = W;
  a.cull = cull;
  a.stacked = stacked;
  a.near = near;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * ranks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, render_setup_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
