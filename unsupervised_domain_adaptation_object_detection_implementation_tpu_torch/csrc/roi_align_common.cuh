// Shared device code of the RoIAlign kernels (roi_align.cu, roi_align_fpn.cu):
// 16-byte vector loads and stores, the per-axis bilinear taps with mmcv's
// sample rule, and the tap gather (forward) and atomic scatter (backward).
//
// The coordinate arithmetic uses round-to-nearest intrinsics so that no
// multiply-add is contracted: sample positions then match the plain torch
// version (ops/roi_align.py:_axis_weights) bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {  // each including file is its own library

constexpr int kMaxSamples = 64;  // out_size * sampling_ratio per axis

struct Tap {
  int i0, i1;
  float w0, w1;
};

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[1]) {
    *p = __float2bfloat16(v[0]);
  }
};

// Sample `s` of bin `bin` on one axis (ops/roi_align.py:_axis_weights).
__device__ __forceinline__ Tap axis_tap(float lo, float bin_size, int bin,
                                        int s, int sr, int len) {
  const float sub = __fdiv_rn(__fadd_rn(static_cast<float>(s), 0.5f),
                              static_cast<float>(sr));
  const float pos = __fadd_rn(
      lo, __fmul_rn(__fadd_rn(static_cast<float>(bin), sub), bin_size));
  const bool valid = pos >= -1.0f && pos <= static_cast<float>(len);
  const float pc = fminf(fmaxf(pos, 0.0f), static_cast<float>(len - 1));
  const float x0 = floorf(pc);
  const float frac = __fsub_rn(pc, x0);
  Tap t;
  t.i0 = static_cast<int>(x0);
  t.i1 = min(t.i0 + 1, len - 1);
  t.w0 = valid ? __fsub_rn(1.0f, frac) : 0.0f;
  t.w1 = valid ? frac : 0.0f;
  return t;
}

// The 2 * o * sr axis taps of RoI (b, r), written by the first threads of
// the block into shared memory (the caller synchronises).
__device__ __forceinline__ void roi_taps(const float* rois, int b, int r,
                                         int R, float spatial_scale,
                                         int out_size, int sr, int aligned,
                                         int H, int W, Tap* taps_x,
                                         Tap* taps_y) {
  const int ns = out_size * sr;
  if (threadIdx.x >= 2 * ns) return;
  const float* roi = rois + (static_cast<int64_t>(b) * R + r) * 4;
  const bool is_x = threadIdx.x < ns;
  const int k = is_x ? threadIdx.x : threadIdx.x - ns;
  const float a0 = __fmul_rn(roi[is_x ? 0 : 1], spatial_scale);
  const float a1 = __fmul_rn(roi[is_x ? 2 : 3], spatial_scale);
  const float lo = aligned ? __fsub_rn(a0, 0.5f) : a0;
  float extent = __fsub_rn(a1, a0);
  if (!aligned) extent = fmaxf(extent, 1.0f);  // legacy min size 1
  const float bin_size = __fdiv_rn(extent, static_cast<float>(out_size));
  const Tap t = axis_tap(lo, bin_size, k / sr, k % sr, sr, is_x ? W : H);
  if (is_x) taps_x[k] = t; else taps_y[k] = t;
}

template <typename T, int VEC>
__device__ __forceinline__ void add_tap(float (&acc)[VEC], const T* f,
                                        int y, int x, int W, int C, int c,
                                        float w) {
  if (w == 0.0f) return;
  float v[VEC];
  Vec<T, VEC>::load(f + (static_cast<int64_t>(y) * W + x) * C + c, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, v[i], acc[i]);
}

// Adds w * g into grad_feats at pixel (y, x), channels c .. c + VEC - 1.
// Vectorised paths use Hopper's 16-byte float4 atomicAdd (global memory,
// compute capability 9.x): c is a multiple of VEC and C of VEC there, so
// the address is 16-byte aligned.
template <int VEC>
__device__ __forceinline__ void scatter_tap(float* gf, int y, int x, int W,
                                            int C, int c, float w,
                                            const float (&g)[VEC]) {
  if (w == 0.0f) return;
  float* p = gf + (static_cast<int64_t>(y) * W + x) * C + c;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(w * g[i], w * g[i + 1], w * g[i + 2],
                            w * g[i + 3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(p + i, w * g[i]);
  }
}

}  // namespace
