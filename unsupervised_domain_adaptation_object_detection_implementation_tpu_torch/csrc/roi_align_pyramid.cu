// RoIAlign forward and backward for Hopper (sm_90a) over a pyramid of 1 to 4
// levels, plain C entry points. One kernel pair serves the single-level path
// (the DC5 trunk: one level, no level array) and the multi-level FPN path.
//
// Forward: computes exactly ops/roi_align.py:batched_roi_align (one level)
// and batched_roi_align_fpn (several): one NHWC map (B, H_l, W_l, C) per
// level, float32 or bfloat16, rois (B, R, 4) float32 xyxy in image
// coordinates, levels (B, R) int32 (ops/roi_align.py:roi_levels, computed in
// torch; a null pointer reads every RoI as level 0) → (B, R, o, o, C), or
// (B, R, o*o*C) in x-major (xbin, ybin, C) order when `flatten` is set. Each
// RoI is single-level RoIAlign of its own level: spatial scale scale_l, the
// half-pixel offset when `aligned`, sampling ratio sr, mmcv's sample rule (a
// sample below -1 or above the axis length contributes zero, the rest clamp
// inward). Backward: the gradient with respect to each level's map, into
// float32 buffers zeroed by the caller; a RoI adds only into its own level,
// rois and levels get no gradient; `g` comes in either output layout.
//
// Replaces the TPU kernels in the JAX package's ops/roi_align_pallas.py:
// single-level forward roi_align_pallas (:63), roi_align_fused (:237),
// _v3_fwd (:443), _v4_fwd (:636) and backward _fused_bwd (:303), _v3_bwd
// (:487), _v4_bwd (:683); multi-level forward _fpn_fused_fwd (:842),
// _fpn2_fused_fwd (:1069) and backward _fpn_fused_bwd (:889),
// _fpn2_fused_bwd (:1121). Those build dense (R, o, W) / (R, o, H) weight
// matrices and run two products per RoI chunk on the MXU (the FPN ones one
// masked pass per level). Here each RoI reads only its own level, and only
// the pixels its samples touch.
//
// What held the earlier kernels back (one per path, now deleted). Both ran
// one block per (RoI, image), each thread owning a 16-byte channel vector:
//   - the forward gathered up to 16 taps per output bin straight from global
//     memory. At the DC5 serving shape (feats (2, 38, 64, 2048) f32,
//     2 x 1000 RoIs, a flat output of 803 MB) that is up to 12.8 GB of
//     L2->SM traffic for an output of 0.8 GB; a RoI's footprint at C = 2048
//     (up to 28 x 28 tap pixels x 8 KB) does not fit in L1, so neighbouring
//     bins and samples that share a pixel each loaded it again: 25% of the
//     byte bound;
//   - the backward scattered every g element into up to 16 pixels, each
//     with its own 16-byte atomicAdd: ~410 M float4 atomics at the DC5
//     training shape, all resolved in L2, and on a real step's RoIs, which
//     crowd around a few gt boxes, same-address atomics serialise: 9% of the
//     byte bound.
//
// The design here. RoIAlign is separable: a bin's value is
// sum_rows wy * sum_cols wx * f[row, col], where wx (wy) are the bin's
// per-column (per-row) weights, each the sum over the bin's samples of their
// two taps, divided by sr (the plain version's _axis_weights). A block takes
// one RoI and a slice of up to 32 channel vectors, with threads (v, p): v the
// channel vector (consecutive threads, consecutive 16 bytes), p an output bin
// column. First the block builds each axis's plan in shared memory: per bin,
// its distinct (index, weight) pairs, the taps of its samples merged, zero
// weights dropped; the backward adds the transposed lists (per distinct
// index, the bins that use it). The tap arithmetic is exact round-to-nearest
// (__fdiv_rn, __fmul_rn, no contraction), so sample positions are those of
// the plain version bit for bit.
//   - Forward: thread (v, px) walks the output rows py in order. For each of
//     the bin's distinct rows it needs the x-interpolated value
//     t = sum_cols wx * f[row, col] of its column px; rows only move forward,
//     so the rows a bin shares with the previous one are the last two it
//     computed, kept in registers. Each (row, column) pair of a bin column is
//     read once; columns shared by neighbouring bin columns are read by the
//     block's neighbouring warps at the same time and served by L1. Each
//     output vector is written once, a warp's 32 stores contiguous, in
//     either layout. Reads per output vector fall from up to 16 to about
//     (distinct rows x distinct columns) / (o * o): ~5-10 for RoIs spanning
//     tens of pixels, under 2 for RoIs of a few pixels; the FMAs fall alike.
//     Staging the footprint in shared memory adds nothing here: every thread
//     owns its channel vector, so no value is shared between threads that L1
//     does not already share. A variant that staged each distinct row with
//     cp.async (3 rows in flight, f32 sums in shared memory) took 1.26 ms
//     against this design's 0.53 at the DC5 serving shape: its shared memory
//     left 3 blocks an SM and two barriers a row (tools/compare_roi_align.py,
//     H100 80GB HBM3, 700 W). Where C / 8 >= 64 (f32, DC5's C = 2048) a
//     thread takes two 16-byte vectors, for twice the loads in flight.
//   - Backward: the block walks the RoI's distinct rows. For row j, thread
//     (v, px) sums the y-transposed product u = sum_py wy * g[py, px] (its g
//     re-reads hit L1) into shared memory; after one barrier, threads
//     (v, k) take the distinct columns k and add
//     sum_px wx * u[px] into the gradient at (row j, column k) with one
//     16-byte red per channel vector. Atomics fall from up to 16 per g
//     element to one per touched (RoI, pixel, channel vector): the RoI's
//     footprint, (w + 2) x (h + 2) pixels for a RoI of w x h feature pixels
//     at most. u is double-buffered, so a row costs one barrier. A footprint
//     of any size streams through, one row at a time: nothing of it needs
//     to fit in shared memory.
// Accumulation is in f32 throughout. Atomics sum in an order that changes
// from run to run, so the backward is not bitwise reproducible; a
// deterministic gather design is the alternative if atomics still dominate.
//
// What holds the pair now (PERF.md, section 6). The forward at the DC5 serving
// shape writes its 803 MB once (0.25 ms at 3.35 TB/s) but still gathers
// ~5 feature vectors an output vector through L2, several GB; the backward
// at the DC5 training shape issues one 16-byte red per touched (RoI, pixel,
// channel vector), ~67 M reds resolved in L2, and a barrier per RoI row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 4;                 // P2..P5, strides 4, 8, 16, 32
constexpr int kMaxSamples = 64;               // out_size * sampling_ratio
constexpr int kMaxEntries = 2 * kMaxSamples;  // (index, weight) slots an axis
constexpr int kMaxThreads = 512;              // vectors x bin columns a block
constexpr int kMaxVectors = 32;               // channel vectors a block

// 16-byte (or scalar) loads and stores of VEC channels, accumulated in f32.
// Loads go through the read-only cache: feature pixels are read again by
// neighbouring bins and RoIs, g by the RoI's neighbouring rows. Stores (the
// forward's output, written once) stream with the evict-first hint, so that
// the output does not push the feature map out of the 50 MB L2 (2% at the
// DC5 serving shape; the same hint on g's loads gained nothing).
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

// Two 16-byte vectors a thread: the forward's f32 path where the channels
// fill at least two slices of kMaxVectors threads (C = 2048 at DC5: 0.42
// against 0.53 ms with one vector; at C = 256 one vector is faster).
template <>
struct Vec<float, 8> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[8]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    const float4 u = __ldg(reinterpret_cast<const float4*>(p + 4));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    v[4] = u.x; v[5] = u.y; v[6] = u.z; v[7] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p + 4),
           make_float4(v[4], v[5], v[6], v[7]));
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    __stcs(p, v[0]);
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
    __stcs(reinterpret_cast<uint4*>(p), t);
  }
};

// Four bf16 channels, one 8-byte load: the backward's bf16 path, so that a
// thread adds one float4 into the f32 buffer per vector, as the f32 path
// does, with as many threads; with 8 channels a thread made two float4
// reds and the launch half the threads (0.817 against 0.438 ms on a DC5
// step's RoIs, tools/compare_roi_align.py --dtype bfloat16).
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[4]) {
    uint2 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    __stcs(reinterpret_cast<uint2*>(p), t);
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
    __stcs(reinterpret_cast<unsigned short*>(p),
           __bfloat16_as_ushort(__float2bfloat16(v[0])));
  }
};

// The pyramid: one map (forward: features; backward: float32 gradients) per
// level, with its height, width and spatial scale (1 / stride).
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

// The level of RoI (b, r), clamped into the pyramid; level 0 without a level
// array. An unrolled select: indexing the parameter struct with a runtime
// value would copy it to the stack (local memory).
__device__ __forceinline__ Level roi_level(const Pyramid& pyr,
                                           const int* levels, int b, int r,
                                           int R) {
  const int l = levels ? levels[static_cast<int64_t>(b) * R + r] : 0;
  Level v{pyr.maps[0], pyr.h[0], pyr.w[0], pyr.scale[0]};
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < pyr.num && i <= l) {
      v = Level{pyr.maps[i], pyr.h[i], pyr.w[i], pyr.scale[i]};
    }
  }
  return v;
}

// One axis of a RoI: bin p's distinct (index, weight) pairs sit in slots
// p * 2 * sr .. + count[p]. The backward adds the transposed lists: the
// axis's distinct indices and, for distinct index d, the (bin, weight)
// pairs t_bin / t_w[t_start[d] .. t_start[d + 1]).
struct AxisPlan {
  int count[kMaxSamples];
  int idx[kMaxEntries];
  float w[kMaxEntries];
  int n_distinct;
  int distinct[kMaxEntries];
  int t_start[kMaxEntries + 1];
  int t_bin[kMaxEntries];
  float t_w[kMaxEntries];
  int ent_d[kMaxEntries];
  int cursor[kMaxEntries];
};

// Start and bin size of RoI `roi` on one axis (0: x, 1: y), in the level's
// pixels: ops/roi_align.py:_roi_weights.
__device__ __forceinline__ void axis_extent(const float* roi, int axis,
                                            float scale, int out_size,
                                            int aligned, float* lo,
                                            float* bin_size) {
  const float a0 = __fmul_rn(roi[axis], scale);
  const float a1 = __fmul_rn(roi[axis + 2], scale);
  *lo = aligned ? __fsub_rn(a0, 0.5f) : a0;
  float extent = __fsub_rn(a1, a0);
  if (!aligned) extent = fmaxf(extent, 1.0f);  // legacy min size 1
  *bin_size = __fdiv_rn(extent, static_cast<float>(out_size));
}

// Adds weight w at index i to the entries [first, n) of one bin; returns
// the new n.
__device__ __forceinline__ int add_entry(AxisPlan& P, int first, int n,
                                         int i, float w) {
  for (int e = n - 1; e >= first; --e) {
    if (P.idx[e] == i) {
      P.w[e] = __fadd_rn(P.w[e], w);
      return n;
    }
  }
  P.idx[n] = i;
  P.w[n] = w;
  return n + 1;
}

// Bin p of one axis (ops/roi_align.py:_axis_weights): sample s sits at
// lo + (p + (s + 0.5) / sr) * bin_size; its two taps' weights are summed per
// index over the bin's samples and divided by sr; zero weights are dropped.
__device__ void build_bin(AxisPlan& P, int p, float lo, float bin_size,
                          int sr, int len) {
  const int first = p * 2 * sr;
  int n = first;
  for (int s = 0; s < sr; ++s) {
    const float sub = __fdiv_rn(__fadd_rn(static_cast<float>(s), 0.5f),
                                static_cast<float>(sr));
    const float pos = __fadd_rn(
        lo, __fmul_rn(__fadd_rn(static_cast<float>(p), sub), bin_size));
    const bool valid = pos >= -1.0f && pos <= static_cast<float>(len);
    const float pc = fminf(fmaxf(pos, 0.0f), static_cast<float>(len - 1));
    const float x0 = floorf(pc);
    const float frac = __fsub_rn(pc, x0);
    const int i0 = static_cast<int>(x0);
    n = add_entry(P, first, n, i0, valid ? __fsub_rn(1.0f, frac) : 0.0f);
    n = add_entry(P, first, n, min(i0 + 1, len - 1), valid ? frac : 0.0f);
  }
  int m = first;
  for (int e = first; e < n; ++e) {
    if (P.w[e] != 0.0f) {
      P.idx[m] = P.idx[e];
      P.w[m] = __fdiv_rn(P.w[e], static_cast<float>(sr));
      ++m;
    }
  }
  P.count[p] = m - first;
}

// The transposed lists of one axis, by one thread. Indices only grow from
// bin to bin (and within a bin) unless the RoI is inverted, so a new index
// is found at the end of the distinct list or appended there; an inverted
// RoI falls back to a full search.
__device__ void transpose_plan(AxisPlan& P, int out_size, int sr) {
  int nd = 0;
  bool sorted = true;
  for (int p = 0; p < out_size; ++p) {
    for (int k = 0; k < P.count[p]; ++k) {
      const int e = p * 2 * sr + k;
      const int i = P.idx[e];
      int d = -1;
      if (nd > 0 && !(sorted && i > P.distinct[nd - 1])) {
        for (int q = nd - 1; q >= 0; --q) {
          if (P.distinct[q] == i) { d = q; break; }
          if (sorted && P.distinct[q] < i) break;
        }
      }
      if (d < 0) {
        if (nd > 0 && i < P.distinct[nd - 1]) sorted = false;
        d = nd++;
        P.distinct[d] = i;
        P.t_start[d + 1] = 0;
      }
      P.ent_d[e] = d;
      ++P.t_start[d + 1];
    }
  }
  P.t_start[0] = 0;
  for (int d = 0; d < nd; ++d) {
    P.t_start[d + 1] += P.t_start[d];
    P.cursor[d] = P.t_start[d];
  }
  for (int p = 0; p < out_size; ++p) {
    for (int k = 0; k < P.count[p]; ++k) {
      const int e = p * 2 * sr + k;
      const int at = P.cursor[P.ent_d[e]]++;
      P.t_bin[at] = p;
      P.t_w[at] = P.w[e];
    }
  }
  P.n_distinct = nd;
}

// Both axes' plans of RoI (b, r) on level lv, by the whole block (one
// thread a bin, then one thread an axis for the transposed lists). The
// caller synchronises.
__device__ __forceinline__ void build_plans(AxisPlan* plan, const float* roi,
                                            const Level& lv, int out_size,
                                            int sr, int aligned,
                                            bool transpose) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = tid; k < 2 * out_size; k += nthreads) {
    const int axis = k < out_size ? 0 : 1;
    float lo, bin_size;
    axis_extent(roi, axis, lv.scale, out_size, aligned, &lo, &bin_size);
    build_bin(plan[axis], k - axis * out_size, lo, bin_size, sr,
              axis ? lv.h : lv.w);
  }
  if (!transpose) return;
  __syncthreads();
  const int second = nthreads > 32 ? 32 : 0;    // another warp, if any
  if (tid == 0) transpose_plan(plan[0], out_size, sr);
  if (tid == second) transpose_plan(plan[1], out_size, sr);
}

template <int VEC>
__device__ __forceinline__ void copy(float (&dst)[VEC], const float (&src)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = src[i];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_fwd_kernel(Pyramid pyr, const float* __restrict__ rois,
                     const int* __restrict__ levels, T* __restrict__ out,
                     int C, int R, int out_size, int sr, int aligned,
                     int flatten) {
  __shared__ AxisPlan plan[2];    // x, y
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const Level lv = roi_level(pyr, levels, b, r, R);
  build_plans(plan, rois + (static_cast<int64_t>(b) * R + r) * 4, lv,
              out_size, sr, aligned, false);
  __syncthreads();

  const int v = blockIdx.z * blockDim.x + threadIdx.x;
  if (v >= C / VEC) return;
  const int c = v * VEC;
  const int px = threadIdx.y;
  const int W = lv.w;
  const T* f = static_cast<const T*>(lv.map) +
               static_cast<int64_t>(b) * lv.h * W * C + c;
  T* dst = out + (static_cast<int64_t>(b) * R + r) * out_size * out_size * C +
           c;
  const AxisPlan& X = plan[0];
  const AxisPlan& Y = plan[1];
  const int x0 = px * 2 * sr;
  const int x1 = x0 + X.count[px];

  // the x-interpolated values of the last two rows computed
  int row_a = -1, row_b = -1;
  float t_a[VEC], t_b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) t_a[i] = t_b[i] = 0.0f;
  for (int py = 0; py < out_size; ++py) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    const int y0 = py * 2 * sr;
    const int y1 = y0 + Y.count[py];
    for (int e = y0; e < y1; ++e) {
      const int row = Y.idx[e];
      const float wy = Y.w[e];
      float t[VEC];
      if (row == row_b) {
        copy<VEC>(t, t_b);
      } else if (row == row_a) {
        copy<VEC>(t, t_a);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) t[i] = 0.0f;
        const T* fr = f + static_cast<int64_t>(row) * W * C;
#pragma unroll 4
        for (int k = x0; k < x1; ++k) {
          float x[VEC];
          Vec<T, VEC>::load(fr + static_cast<int64_t>(X.idx[k]) * C, x);
          const float wx = X.w[k];
#pragma unroll
          for (int i = 0; i < VEC; ++i) t[i] = fmaf(wx, x[i], t[i]);
        }
        row_a = row_b;
        copy<VEC>(t_a, t_b);
        row_b = row;
        copy<VEC>(t_b, t);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wy, t[i], acc[i]);
    }
    const int bin = flatten ? px * out_size + py : py * out_size + px;
    Vec<T, VEC>::store(dst + static_cast<int64_t>(bin) * C, acc);
  }
}

// Adds v into p[0 .. VEC) with Hopper's 16-byte float4 atomics (global
// memory, compute capability 9.x; p is 16-byte aligned where VEC is 4 or
// 8), else one f32 atomic a channel.
template <int VEC>
__device__ __forceinline__ void red_add(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(p + i, v[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_bwd_kernel(Pyramid pyr, const float* __restrict__ rois,
                     const int* __restrict__ levels,
                     const T* __restrict__ grad, int C, int R, int out_size,
                     int sr, int aligned, int flatten) {
  __shared__ AxisPlan plan[2];    // x, y
  // u of two rows in turn: [row & 1][bin column][thread x][VEC]
  extern __shared__ float4 u_store[];
  float* u_buf = reinterpret_cast<float*>(u_store);
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const Level lv = roi_level(pyr, levels, b, r, R);
  build_plans(plan, rois + (static_cast<int64_t>(b) * R + r) * 4, lv,
              out_size, sr, aligned, true);
  __syncthreads();

  const int v = blockIdx.z * blockDim.x + threadIdx.x;
  const bool active = v < C / VEC;
  const int c = v * VEC;
  const int p = threadIdx.y;
  const int W = lv.w;
  const T* g = grad + (static_cast<int64_t>(b) * R + r) * out_size *
                          out_size * C + c;
  float* gf = static_cast<float*>(lv.map) +
              static_cast<int64_t>(b) * lv.h * W * C + c;
  const AxisPlan& X = plan[0];
  const AxisPlan& Y = plan[1];
  const int rows = Y.n_distinct;
  const int cols = X.n_distinct;
  const int slab = out_size * blockDim.x * VEC;
  float* mine = u_buf + (p * blockDim.x + threadIdx.x) * VEC;

  for (int j = 0; j < rows; ++j) {
    float* buf = u_buf + (j & 1) * slab;
    // u = sum over the bins py that sample row j of wy * g[py, p]
    float u[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) u[i] = 0.0f;
    if (active) {
      for (int e = Y.t_start[j]; e < Y.t_start[j + 1]; ++e) {
        const int py = Y.t_bin[e];
        const float wy = Y.t_w[e];
        const int bin = flatten ? p * out_size + py : py * out_size + p;
        float x[VEC];
        Vec<T, VEC>::load(g + static_cast<int64_t>(bin) * C, x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) u[i] = fmaf(wy, x[i], u[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) mine[(j & 1) * slab + i] = u[i];
    __syncthreads();
    if (!active) continue;
    // one red per distinct column k: sum over the bin columns px that
    // sample it of wx * u[px]
    float* gr = gf + static_cast<int64_t>(Y.distinct[j]) * W * C;
    for (int k = p; k < cols; k += blockDim.y) {
      float s[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[i] = 0.0f;
      for (int e = X.t_start[k]; e < X.t_start[k + 1]; ++e) {
        const float wx = X.t_w[e];
        const float* up = buf + (X.t_bin[e] * blockDim.x + threadIdx.x) * VEC;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] = fmaf(wx, up[i], s[i]);
      }
      red_add<VEC>(gr + static_cast<int64_t>(X.distinct[k]) * C, s);
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
      out_size * sampling_ratio > kMaxSamples) {
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

// Threads (channel vectors x bin columns) and grid (RoIs, images, channel
// slices) of a launch: up to 32 vectors, at most kMaxThreads threads.
bool launch_shape(int B, int C, int R, int out_size, int vec, dim3* grid,
                  dim3* block) {
  const int nvec = C / vec;
  int nv = kMaxThreads / out_size;
  if (nv > kMaxVectors) nv = kMaxVectors;
  if (nv > nvec) nv = nvec;
  if (nv < 1) nv = 1;
  const int slices = (nvec + nv - 1) / nv;
  if (slices > 65535) return false;
  *block = dim3(nv, out_size);
  *grid = dim3(R, B, slices);
  return true;
}

template <typename T, int VEC>
int launch_fwd(const Pyramid& pyr, const void* rois, const void* levels,
               void* out, int B, int C, int R, int out_size, int sr,
               int aligned, int flatten, cudaStream_t stream) {
  dim3 grid, block;
  if (!launch_shape(B, C, R, out_size, VEC, &grid, &block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  roi_align_fwd_kernel<T, VEC><<<grid, block, 0, stream>>>(
      pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<T*>(out), C, R, out_size, sr, aligned, flatten);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd(const Pyramid& pyr, const void* rois, const void* levels,
               const void* grad, int B, int C, int R, int out_size, int sr,
               int aligned, int flatten, cudaStream_t stream) {
  dim3 grid, block;
  if (!launch_shape(B, C, R, out_size, VEC, &grid, &block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(out_size) * block.x * VEC *
                      sizeof(float);
  roi_align_bwd_kernel<T, VEC><<<grid, block, smem, stream>>>(
      pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
      static_cast<const T*>(grad), C, R, out_size, sr, aligned, flatten);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// feats: num_levels (1..4) device pointers to (B, H_l, W_l, C) maps of dtype
// `dtype` (0 = float32, 1 = bfloat16), with host arrays of their heights,
// widths and spatial scales; levels: (B, R) int32, or null for level 0.
// vec: 1, or 4 (f32) / 8 (bf16) when C is a multiple of it and every map
// and `out` is 16-byte aligned. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take, else the
// launch's cudaGetLastError().
int roi_align_pyramid_fwd(void* const* feats, const int* heights,
                          const int* widths, const float* scales,
                          int num_levels, const void* rois,
                          const void* levels, void* out, int B, int C, int R,
                          int out_size, int sampling_ratio, int aligned,
                          int flatten, int dtype, int vec, void* stream) {
  Pyramid pyr;
  if (!make_pyramid(feats, heights, widths, scales, num_levels, B, C, R,
                    out_size, sampling_ratio, &pyr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && C % 8 == 0 && C / 8 >= 2 * kMaxVectors) {
    return launch_fwd<float, 8>(pyr, rois, levels, out, B, C, R, out_size,
                                sampling_ratio, aligned, flatten, s);
  } else if (dtype == 0 && vec == 4) {
    return launch_fwd<float, 4>(pyr, rois, levels, out, B, C, R, out_size,
                                sampling_ratio, aligned, flatten, s);
  } else if (dtype == 0 && vec == 1) {
    return launch_fwd<float, 1>(pyr, rois, levels, out, B, C, R, out_size,
                                sampling_ratio, aligned, flatten, s);
  } else if (dtype == 1 && vec == 8) {
    return launch_fwd<__nv_bfloat16, 8>(pyr, rois, levels, out, B, C, R,
                                        out_size, sampling_ratio, aligned,
                                        flatten, s);
  } else if (dtype == 1 && vec == 1) {
    return launch_fwd<__nv_bfloat16, 1>(pyr, rois, levels, out, B, C, R,
                                        out_size, sampling_ratio, aligned,
                                        flatten, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// grad_feats: num_levels device pointers to (B, H_l, W_l, C) float32
// buffers, zeroed by the caller and accumulated into; grad: the forward
// output's gradient, (B, R, o, o, C) or flat (B, R, o*o*C) x-major, of dtype
// `dtype`; levels as for the forward. vec: 1, or 4 when C is a multiple of
// 4 and `grad` and every buffer are 16-byte aligned.
// Returns a cudaError_t as roi_align_pyramid_fwd does.
int roi_align_pyramid_bwd(void* const* grad_feats, const int* heights,
                          const int* widths, const float* scales,
                          int num_levels, const void* rois,
                          const void* levels, const void* grad, int B, int C,
                          int R, int out_size, int sampling_ratio,
                          int aligned, int flatten, int dtype, int vec,
                          void* stream) {
  Pyramid pyr;
  if (!make_pyramid(grad_feats, heights, widths, scales, num_levels, B, C, R,
                    out_size, sampling_ratio, &pyr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    return launch_bwd<float, 4>(pyr, rois, levels, grad, B, C, R, out_size,
                                sampling_ratio, aligned, flatten, s);
  } else if (dtype == 0 && vec == 1) {
    return launch_bwd<float, 1>(pyr, rois, levels, grad, B, C, R, out_size,
                                sampling_ratio, aligned, flatten, s);
  } else if (dtype == 1 && vec == 4) {
    return launch_bwd<__nv_bfloat16, 4>(pyr, rois, levels, grad, B, C, R,
                                        out_size, sampling_ratio, aligned,
                                        flatten, s);
  } else if (dtype == 1 && vec == 1) {
    return launch_bwd<__nv_bfloat16, 1>(pyr, rois, levels, grad, B, C, R,
                                        out_size, sampling_ratio, aligned,
                                        flatten, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
