// Single-level RoIAlign forward and backward for Hopper (sm_90a), plain C
// entry points.
//
// Forward: computes exactly ops/roi_align.py:batched_roi_align (the JAX
// package's function of the same name): feats (B, H, W, C) NHWC float32 or
// bfloat16, rois (B, R, 4) float32 xyxy in image coordinates → (B, R, o, o,
// C), or (B, R, o*o*C) in x-major (xbin, ybin, C) order when `flatten` is set.
// Each output bin is the mean of sr x sr bilinear samples placed at
// lo + (bin + (s + 0.5) / sr) * bin_size; a sample whose coordinate on
// either axis is < -1 or > len contributes zero (mmcv's rule); otherwise the
// coordinate is clamped to [0, len - 1] and its upper tap to len - 1.
//
// Backward: the gradient of that function with respect to feats,
// grad_feats[b, y, x, c] = sum over RoIs, bins and samples of w * g[b, r,
// bin, c], with the forward's taps and weights; rois get no gradient. `g`
// comes in either output layout; grad_feats is always float32.
//
// Replaces the TPU kernels in the JAX package's ops/roi_align_pallas.py:
// forward of roi_align_pallas (:63), roi_align_fused (:237),
// roi_align_fused_v3 (:434) and roi_align_fused_v4 (:627); backward of
// _fused_bwd (:303), _v3_bwd (:487) and _v4_bwd (:683). Those build dense
// (R, o, W) / (R, o, H) weight matrices and run two matrix products per RoI
// chunk on the MXU (the backward as the transposed products, accumulated in
// a VMEM slab across the sequential grid); here each block computes its taps
// directly.
//
// What bounds the forward: at the serving shape (2 x 38 x 64 x 2048 f32
// feature map, 1000 RoIs per image) the feature map (20 MB per image) stays
// in the 50 MB L2 while the 401 MB-per-image output streams to HBM once, so
// the kernel is bound by writing its output. Design for that:
//   - one block per (RoI, image); the block's 2 * o * sr axis taps
//     (indices and weights, validity folded into the weights) are computed
//     once into shared memory;
//   - threads run over channels with 16-byte vector loads and stores
//     (4 x f32 or 8 x bf16), so tap reads and output writes are coalesced
//     and every output byte is written exactly once, in its final layout;
//   - accumulation is in f32; taps with zero weight are skipped.
// The per-bin tap reads (up to 16 per channel) come from L2; making them
// fewer (sharing rows between bins, TMA-staged tiles) is later work.
//
// What bounds the backward: at the training shape (feats 2 x 32 x 64 x 2048
// f32, 512 sampled RoIs per image, o = 7, sr = 2, flat g of 2 x 512 x 100352
// f32) it must read g (411.0 MB) and write grad_feats once (2 x 16.8 MB):
// 444.6 MB, 0.133 ms at 3.35 TB/s; the zeroing pass that this design's
// atomics need (another 33.6 MB) is its own overhead. Every g element
// scatters into up to 16 feature pixels, about 1.64 G float32 atomic adds
// in all, and those atomics (resolved in L2, where the 16.8 MB grad_feats
// lives) rather than the bytes are the likely limit. The first design is the simple one: the
// forward's block layout, g read once with vector loads and scaled by
// 1 / (sr * sr), each nonzero tap weight times g added into grad_feats
// (which the wrapper zeroes first) with f32 atomics, four channels per
// 16-byte atomic where the channels allow it. Atomics sum in an order that
// changes from run to run, so the result is not bitwise reproducible. A
// gather-based deterministic design and sharing tap rows between
// neighbouring bins are later work.
//
// The coordinate arithmetic uses round-to-nearest intrinsics so that no
// multiply-add is contracted: sample positions then match the plain torch
// version bit for bit.

#include "roi_align_common.cuh"

namespace {

template <typename T, int VEC>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feats,
                                     const float* __restrict__ rois,
                                     T* __restrict__ out, int H, int W, int C,
                                     int R, float spatial_scale, int out_size,
                                     int sr, int aligned, int flatten) {
  __shared__ Tap taps_x[kMaxSamples];
  __shared__ Tap taps_y[kMaxSamples];
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  roi_taps(rois, b, r, R, spatial_scale, out_size, sr, aligned, H, W, taps_x,
           taps_y);
  __syncthreads();

  const T* f = feats + static_cast<int64_t>(b) * H * W * C;
  T* o = out + (static_cast<int64_t>(b) * R + r) * out_size * out_size * C;
  const float inv = 1.0f / static_cast<float>(sr * sr);
  for (int c = threadIdx.x * VEC; c < C; c += blockDim.x * VEC) {
    for (int py = 0; py < out_size; ++py) {
      for (int px = 0; px < out_size; ++px) {
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
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
        for (int i = 0; i < VEC; ++i) acc[i] *= inv;
        const int bin = flatten ? px * out_size + py : py * out_size + px;
        Vec<T, VEC>::store(o + static_cast<int64_t>(bin) * C + c, acc);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void roi_align_bwd_kernel(const T* __restrict__ grad,
                                     const float* __restrict__ rois,
                                     float* __restrict__ grad_feats, int H,
                                     int W, int C, int R, float spatial_scale,
                                     int out_size, int sr, int aligned,
                                     int flatten) {
  __shared__ Tap taps_x[kMaxSamples];
  __shared__ Tap taps_y[kMaxSamples];
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  roi_taps(rois, b, r, R, spatial_scale, out_size, sr, aligned, H, W, taps_x,
           taps_y);
  __syncthreads();

  float* gf = grad_feats + static_cast<int64_t>(b) * H * W * C;
  const T* g = grad + (static_cast<int64_t>(b) * R + r) * out_size *
                          out_size * C;
  const float inv = 1.0f / static_cast<float>(sr * sr);
  for (int c = threadIdx.x * VEC; c < C; c += blockDim.x * VEC) {
    for (int py = 0; py < out_size; ++py) {
      for (int px = 0; px < out_size; ++px) {
        const int bin = flatten ? px * out_size + py : py * out_size + px;
        float v[VEC];
        Vec<T, VEC>::load(g + static_cast<int64_t>(bin) * C + c, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] *= inv;
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
  }
}

int block_threads(int C, int vec, int out_size, int sr) {
  const int vectors = (C + vec - 1) / vec;
  int threads = ((vectors + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  const int setup = ((2 * out_size * sr + 31) / 32) * 32;
  return threads < setup ? setup : threads;
}

template <typename T, int VEC>
void launch_fwd(const void* feats, const void* rois, void* out, int B, int H,
                int W, int C, int R, float spatial_scale, int out_size, int sr,
                int aligned, int flatten, cudaStream_t stream) {
  const dim3 grid(R, B);
  roi_align_fwd_kernel<T, VEC><<<grid, block_threads(C, VEC, out_size, sr), 0,
                                 stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(rois),
      static_cast<T*>(out), H, W, C, R, spatial_scale, out_size, sr, aligned,
      flatten);
}

template <typename T, int VEC>
void launch_bwd(const void* grad, const void* rois, void* grad_feats, int B,
                int H, int W, int C, int R, float spatial_scale, int out_size,
                int sr, int aligned, int flatten, cudaStream_t stream) {
  const dim3 grid(R, B);
  roi_align_bwd_kernel<T, VEC><<<grid, block_threads(C, VEC, out_size, sr), 0,
                                 stream>>>(
      static_cast<const T*>(grad), static_cast<const float*>(rois),
      static_cast<float*>(grad_feats), H, W, C, R, spatial_scale, out_size, sr,
      aligned, flatten);
}

bool bad_shape(int B, int H, int W, int C, int R, int out_size,
               int sampling_ratio) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || R <= 0 || B > 65535 ||
         out_size <= 0 || sampling_ratio <= 0 ||
         out_size * sampling_ratio > kMaxSamples;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec: 1, or 4 (f32) / 8 (bf16) when C is
// a multiple of it and both pointers are 16-byte aligned. Returns a
// cudaError_t: cudaErrorInvalidValue for arguments the kernel does not take,
// else the launch's cudaGetLastError().
int roi_align_fwd(const void* feats, const void* rois, void* out, int B,
                  int H, int W, int C, int R, float spatial_scale,
                  int out_size, int sampling_ratio, int aligned, int flatten,
                  int dtype, int vec, void* stream) {
  if (bad_shape(B, H, W, C, R, out_size, sampling_ratio)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch_fwd<float, 4>(feats, rois, out, B, H, W, C, R, spatial_scale,
                         out_size, sampling_ratio, aligned, flatten, s);
  } else if (dtype == 0 && vec == 1) {
    launch_fwd<float, 1>(feats, rois, out, B, H, W, C, R, spatial_scale,
                         out_size, sampling_ratio, aligned, flatten, s);
  } else if (dtype == 1 && vec == 8) {
    launch_fwd<__nv_bfloat16, 8>(feats, rois, out, B, H, W, C, R,
                                 spatial_scale, out_size, sampling_ratio,
                                 aligned, flatten, s);
  } else if (dtype == 1 && vec == 1) {
    launch_fwd<__nv_bfloat16, 1>(feats, rois, out, B, H, W, C, R,
                                 spatial_scale, out_size, sampling_ratio,
                                 aligned, flatten, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad: (B, R, o, o, C) or flat (B, R, o*o*C) x-major, of dtype `dtype`;
// grad_feats: (B, H, W, C) float32, zeroed by the caller, accumulated into.
// vec: 1, or 4 (f32) / 8 (bf16) when C is a multiple of it and `grad` is
// 16-byte aligned. Returns a cudaError_t as roi_align_fwd does.
int roi_align_bwd(const void* grad, const void* rois, void* grad_feats, int B,
                  int H, int W, int C, int R, float spatial_scale,
                  int out_size, int sampling_ratio, int aligned, int flatten,
                  int dtype, int vec, void* stream) {
  if (bad_shape(B, H, W, C, R, out_size, sampling_ratio)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch_bwd<float, 4>(grad, rois, grad_feats, B, H, W, C, R, spatial_scale,
                         out_size, sampling_ratio, aligned, flatten, s);
  } else if (dtype == 0 && vec == 1) {
    launch_bwd<float, 1>(grad, rois, grad_feats, B, H, W, C, R, spatial_scale,
                         out_size, sampling_ratio, aligned, flatten, s);
  } else if (dtype == 1 && vec == 8) {
    launch_bwd<__nv_bfloat16, 8>(grad, rois, grad_feats, B, H, W, C, R,
                                 spatial_scale, out_size, sampling_ratio,
                                 aligned, flatten, s);
  } else if (dtype == 1 && vec == 1) {
    launch_bwd<__nv_bfloat16, 1>(grad, rois, grad_feats, B, H, W, C, R,
                                 spatial_scale, out_size, sampling_ratio,
                                 aligned, flatten, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
