// Multi-level (FPN) RoIAlign forward and backward for Hopper (sm_90a), plain
// C entry points.
//
// Forward: computes exactly ops/roi_align.py:batched_roi_align_fpn (the JAX
// package's function of the same name): one NHWC map (B, H_l, W_l, C) per
// pyramid level, float32 or bfloat16, rois (B, R, 4) float32 xyxy in image
// coordinates and levels (B, R) int32 (ops/roi_align.py:roi_levels, computed
// once in torch and passed in, so that kernel and plain version agree on
// every RoI's level, even where one ulp of log2 decides it) → (B, R, o, o,
// C), or (B, R, o*o*C) in x-major (xbin, ybin, C) order when `flatten` is
// set. Each RoI is single-level RoIAlign of its own level: spatial scale
// 1 / stride_l, the half-pixel offset when `aligned`, mmcv's sample rule
// (roi_align_common.cuh), sampling ratio sr.
//
// Backward: the gradient of that function with respect to each level's map;
// a RoI adds only into its own level, rois and levels get no gradient. `g`
// comes in either output layout; the gradients are float32, one buffer per
// level, zeroed by the caller.
//
// Replaces the TPU kernels in the JAX package's ops/roi_align_pallas.py:
// forward of roi_align_fpn_fused (:944; _fpn_fused_fwd :842, kernel :758)
// and roi_align_fpn_fused_v2 (:1181; _fpn2_fused_fwd :1069, kernel :991);
// backward of _fpn_fused_bwd (:889, kernel :787) and _fpn2_fused_bwd
// (:1121, kernel :1015). Those run one masked dense pass per level (4
// pallas_calls): every RoI against every level, with the level one-hot
// folded into the x weights, because a gather is slow on the TPU. Here one
// launch serves all levels: the levels' base pointers, sizes and scales
// travel by value in a small struct, and each block reads its RoI's level
// and samples only that map. The pyramid is not concatenated (that would
// copy ~40 MB per image per call at P2).
//
// What bounds it on this card. Forward, at the serving shape (pyramid of a
// 608x1024 canvas, C = 256, f32, 2 x 1000 RoIs): the 100 MB output must be
// written once, and the feature pixels that the RoIs touch (at most the
// 106 MB pyramid) read once: ~0.06 ms at 3.35 TB/s; its ~0.8 GFLOP take
// 0.012 ms at 67 TFLOP/s, so it is bound by bytes. Each output vector
// gathers up to 16 taps, mostly from L2. Backward, at the training shape
// (pyramid of a 512x1024 canvas, 2 x 512 RoIs): read g (51 MB) once and
// write the four gradients (89 MB) once, ~0.04 ms; the zeroing pass that
// the atomics need is this design's own overhead. Every g element scatters
// into up to 16 pixels with f32 atomics resolved in L2; like the
// single-level backward (roi_align.cu) those atomics, not the bytes, are the
// likely limit.
//
// Design: C is 256 here, not 2048, so one thread per channel vector would
// leave a block of 64 (f32) or 32 (bf16) threads. Instead one block of 256
// threads per (RoI, image) computes its 2 * o * sr axis taps once into
// shared memory, then its threads walk the (output bin, channel vector)
// pairs in the output's own order: consecutive threads write (forward) or
// read (backward) consecutive 16-byte vectors of the RoI's o * o * C slab,
// so every output byte is written once, coalesced, already in its final
// layout. Accumulation is in f32 and taps with zero weight are skipped. The
// backward adds each nonzero weighted tap with Hopper's 16-byte float4
// atomicAdd (four channels per atomic); atomics sum in an order that
// changes from run to run, so it is not bitwise reproducible. Sharing tap
// rows between the bins of a RoI, or a deterministic gather-based backward,
// are later work.

#include "roi_align_common.cuh"

namespace {

constexpr int kMaxLevels = 4;  // P2..P5, strides 4, 8, 16, 32
constexpr int kThreads = 256;

// The pyramid: one map (forward: features; backward: float32 gradients)
// per level, with its height, width and spatial scale (1 / stride).
struct Pyramid {
  void* maps[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int num;
};

struct Level {
  void* map;
  int h, w;
  float scale;
};

// The level of RoI (b, r), clamped into the pyramid. An unrolled select:
// indexing the parameter struct with a runtime value would copy it to the
// stack (local memory).
__device__ __forceinline__ Level roi_level(const Pyramid& pyr,
                                           const int* levels, int b, int r,
                                           int R) {
  const int l = levels[static_cast<int64_t>(b) * R + r];
  Level v{pyr.maps[0], pyr.h[0], pyr.w[0], pyr.scale[0]};
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < pyr.num && i <= l) {
      v = Level{pyr.maps[i], pyr.h[i], pyr.w[i], pyr.scale[i]};
    }
  }
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
roi_align_fpn_fwd_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ levels, T* __restrict__ out,
                         int C, int R, int out_size, int sr, int aligned,
                         int flatten) {
  __shared__ Tap taps_x[kMaxSamples];
  __shared__ Tap taps_y[kMaxSamples];
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const Level lv = roi_level(pyr, levels, b, r, R);
  const int H = lv.h;
  const int W = lv.w;
  roi_taps(rois, b, r, R, lv.scale, out_size, sr, aligned, H, W, taps_x,
           taps_y);
  __syncthreads();

  const T* f = static_cast<const T*>(lv.map) +
               static_cast<int64_t>(b) * H * W * C;
  T* o = out + (static_cast<int64_t>(b) * R + r) * out_size * out_size * C;
  const float inv = 1.0f / static_cast<float>(sr * sr);
  const int nvec = C / VEC;
  const int items = out_size * out_size * nvec;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int k = i / nvec;                  // bin, in the output's order
    const int c = (i - k * nvec) * VEC;
    const int py = flatten ? k % out_size : k / out_size;
    const int px = flatten ? k / out_size : k % out_size;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    for (int sy = 0; sy < sr; ++sy) {
      const Tap ty = taps_y[py * sr + sy];
      for (int sx = 0; sx < sr; ++sx) {
        const Tap tx = taps_x[px * sr + sx];
        add_tap<T, VEC>(acc, f, ty.i0, tx.i0, W, C, c, ty.w0 * tx.w0);
        add_tap<T, VEC>(acc, f, ty.i0, tx.i1, W, C, c, ty.w0 * tx.w1);
        add_tap<T, VEC>(acc, f, ty.i1, tx.i0, W, C, c, ty.w1 * tx.w0);
        add_tap<T, VEC>(acc, f, ty.i1, tx.i1, W, C, c, ty.w1 * tx.w1);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] *= inv;
    Vec<T, VEC>::store(o + static_cast<int64_t>(k) * C + c, acc);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
roi_align_fpn_bwd_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ levels,
                         const T* __restrict__ grad, int C, int R,
                         int out_size, int sr, int aligned, int flatten) {
  __shared__ Tap taps_x[kMaxSamples];
  __shared__ Tap taps_y[kMaxSamples];
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const Level lv = roi_level(pyr, levels, b, r, R);
  const int H = lv.h;
  const int W = lv.w;
  roi_taps(rois, b, r, R, lv.scale, out_size, sr, aligned, H, W, taps_x,
           taps_y);
  __syncthreads();

  float* gf = static_cast<float*>(lv.map) +
              static_cast<int64_t>(b) * H * W * C;
  const T* g = grad + (static_cast<int64_t>(b) * R + r) * out_size *
                          out_size * C;
  const float inv = 1.0f / static_cast<float>(sr * sr);
  const int nvec = C / VEC;
  const int items = out_size * out_size * nvec;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int k = i / nvec;
    const int c = (i - k * nvec) * VEC;
    const int py = flatten ? k % out_size : k / out_size;
    const int px = flatten ? k / out_size : k % out_size;
    float v[VEC];
    Vec<T, VEC>::load(g + static_cast<int64_t>(k) * C + c, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] *= inv;
    for (int sy = 0; sy < sr; ++sy) {
      const Tap ty = taps_y[py * sr + sy];
      for (int sx = 0; sx < sr; ++sx) {
        const Tap tx = taps_x[px * sr + sx];
        scatter_tap<VEC>(gf, ty.i0, tx.i0, W, C, c, ty.w0 * tx.w0, v);
        scatter_tap<VEC>(gf, ty.i0, tx.i1, W, C, c, ty.w0 * tx.w1, v);
        scatter_tap<VEC>(gf, ty.i1, tx.i0, W, C, c, ty.w1 * tx.w0, v);
        scatter_tap<VEC>(gf, ty.i1, tx.i1, W, C, c, ty.w1 * tx.w1, v);
      }
    }
  }
}

// Fills `pyr` from the host arrays; false for arguments the kernels do not
// take.
bool make_pyramid(void* const* maps, const int* heights, const int* widths,
                  const float* scales, int num_levels, int B, int C, int R,
                  int out_size, int sampling_ratio, Pyramid* pyr) {
  if (num_levels < 1 || num_levels > kMaxLevels || B <= 0 || C <= 0 ||
      R <= 0 || B > 65535 || out_size <= 0 || sampling_ratio <= 0 ||
      out_size * sampling_ratio > kMaxSamples ||
      2 * out_size * sampling_ratio > kThreads) {
    return false;
  }
  pyr->num = num_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < num_levels ? i : num_levels - 1;
    if (heights[j] <= 0 || widths[j] <= 0 || maps[j] == nullptr) return false;
    pyr->maps[i] = maps[j];
    pyr->h[i] = heights[j];
    pyr->w[i] = widths[j];
    pyr->scale[i] = scales[j];
  }
  return true;
}

template <typename T, int VEC>
void launch_fwd(const Pyramid& pyr, const void* rois, const void* levels,
                void* out, int B, int C, int R, int out_size, int sr,
                int aligned, int flatten, cudaStream_t stream) {
  roi_align_fpn_fwd_kernel<T, VEC><<<dim3(R, B), kThreads, 0, stream>>>(
      pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<T*>(out), C, R, out_size, sr, aligned, flatten);
}

template <typename T, int VEC>
void launch_bwd(const Pyramid& pyr, const void* rois, const void* levels,
                const void* grad, int B, int C, int R, int out_size, int sr,
                int aligned, int flatten, cudaStream_t stream) {
  roi_align_fpn_bwd_kernel<T, VEC><<<dim3(R, B), kThreads, 0, stream>>>(
      pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<const T*>(grad), C, R, out_size, sr, aligned, flatten);
}

}  // namespace

extern "C" {

// feats: num_levels (1..4) device pointers to (B, H_l, W_l, C) maps of
// dtype `dtype` (0 = float32, 1 = bfloat16), with host arrays of their
// heights, widths and spatial scales; levels: (B, R) int32. vec: 1, or 4
// (f32) / 8 (bf16) when C is a multiple of it and every map and `out` is
// 16-byte aligned. Returns a cudaError_t: cudaErrorInvalidValue for
// arguments the kernel does not take, else the launch's cudaGetLastError().
int roi_align_fpn_fwd(void* const* feats, const int* heights,
                      const int* widths, const float* scales, int num_levels,
                      const void* rois, const void* levels, void* out, int B,
                      int C, int R, int out_size, int sampling_ratio,
                      int aligned, int flatten, int dtype, int vec,
                      void* stream) {
  Pyramid pyr;
  if (!make_pyramid(feats, heights, widths, scales, num_levels, B, C, R,
                    out_size, sampling_ratio, &pyr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch_fwd<float, 4>(pyr, rois, levels, out, B, C, R, out_size,
                         sampling_ratio, aligned, flatten, s);
  } else if (dtype == 0 && vec == 1) {
    launch_fwd<float, 1>(pyr, rois, levels, out, B, C, R, out_size,
                         sampling_ratio, aligned, flatten, s);
  } else if (dtype == 1 && vec == 8) {
    launch_fwd<__nv_bfloat16, 8>(pyr, rois, levels, out, B, C, R, out_size,
                                 sampling_ratio, aligned, flatten, s);
  } else if (dtype == 1 && vec == 1) {
    launch_fwd<__nv_bfloat16, 1>(pyr, rois, levels, out, B, C, R, out_size,
                                 sampling_ratio, aligned, flatten, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_feats: num_levels device pointers to (B, H_l, W_l, C) float32
// buffers, zeroed by the caller and accumulated into; grad: the forward
// output's gradient, (B, R, o, o, C) or flat (B, R, o*o*C) x-major, of dtype
// `dtype`. vec: 1, or 4 (f32) / 8 (bf16) when C is a multiple of it and
// `grad` and every buffer are 16-byte aligned. Returns a cudaError_t as
// roi_align_fpn_fwd does.
int roi_align_fpn_bwd(void* const* grad_feats, const int* heights,
                      const int* widths, const float* scales, int num_levels,
                      const void* rois, const void* levels, const void* grad,
                      int B, int C, int R, int out_size, int sampling_ratio,
                      int aligned, int flatten, int dtype, int vec,
                      void* stream) {
  Pyramid pyr;
  if (!make_pyramid(grad_feats, heights, widths, scales, num_levels, B, C, R,
                    out_size, sampling_ratio, &pyr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch_bwd<float, 4>(pyr, rois, levels, grad, B, C, R, out_size,
                         sampling_ratio, aligned, flatten, s);
  } else if (dtype == 0 && vec == 1) {
    launch_bwd<float, 1>(pyr, rois, levels, grad, B, C, R, out_size,
                         sampling_ratio, aligned, flatten, s);
  } else if (dtype == 1 && vec == 8) {
    launch_bwd<__nv_bfloat16, 8>(pyr, rois, levels, grad, B, C, R, out_size,
                                 sampling_ratio, aligned, flatten, s);
  } else if (dtype == 1 && vec == 1) {
    launch_bwd<__nv_bfloat16, 1>(pyr, rois, levels, grad, B, C, R, out_size,
                                 sampling_ratio, aligned, flatten, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
