// Stride-1, dilation-1 depthwise k_t x k_f convolution whose output has the
// input's size (sm_90a).
//
// Replaces the TPU kernel rtfs_net_tpu/ops/pallas/dw_conv.py:dw_conv2d_same
// (Pallas body `_dw_kernel`). That kernel transposes to (C, T, F, B) to put
// the batch on the 128 lanes, tiles T with halo blocks through VMEM and keeps
// the weight table in SMEM; none of that has a counterpart here.
//
// Layout: x, y (B, C, T, F) contiguous, F minor, float32 or bfloat16;
// w (C, k_t * k_f) float32. Explicit zero padding (lo_t, hi_t), (lo_f, hi_f)
// with lo + hi = k - 1 on each axis, handled at the edges by predicated
// loads: no padded copy of x exists.
//   y[b, c, t, f] = sum_{dt, df} w[c, dt, df] * x[b, c, t + dt - lo_t, f + df - lo_f]
// Taps are summed in float32 in the order (dt, df); no bias.
//
// Bound on an H100: bytes. Each element is read once and written once,
// 2 * B*C*T*F * itemsize bytes, against 2 * k_t * k_f operations per output:
// at (16, 64, 251, 129) float32 that is 79 us of HBM traffic and 16 us of
// float32 arithmetic. The design keeps the k_t * k_f re-reads of each input
// out of HBM and mostly out of the load pipe: one thread owns a strip of
// kRows output rows at one f and slides down it, loading each input row's
// k_f neighbours once (adjacent threads take adjacent f, so a warp's load is
// one coalesced segment and the k_f - 1 shifted re-loads hit L1) and feeding
// them to the k_t outputs in flight, whose partial sums and the channel's
// weights sit in registers. Only the k_t - 1 halo rows between two strips are
// read twice, and a plane's strips are neighbouring blocks, so the second
// read comes from L2. Kernel sizes outside 2..5 take a plain one-thread-per-
// output kernel whose re-reads go through L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;  // output rows per thread of the sliding kernel

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// grid = (planes * tiles): block b takes tile b % tiles of plane b / tiles,
// a tile being kThreads consecutive (strip, f) pairs of that plane.
template <typename T, int KT, int KF>
__global__ void __launch_bounds__(kThreads)
dw_conv_sliding_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ y, int C, int Tn, int Fn, int lo_t,
                       int lo_f, int strips, int tiles) {
  const int plane = blockIdx.x / tiles;
  const int idx = (blockIdx.x - plane * tiles) * kThreads + threadIdx.x;
  const int strip = idx / Fn;
  if (strip >= strips) return;
  const int f = idx - strip * Fn;
  const int t0 = strip * kRows;

  const float* wc = w + (int64_t)(plane % C) * (KT * KF);
  float wr[KT][KF];
#pragma unroll
  for (int i = 0; i < KT; ++i) {
#pragma unroll
    for (int j = 0; j < KF; ++j) wr[i][j] = __ldg(wc + i * KF + j);
  }
  bool col_ok[KF];
#pragma unroll
  for (int j = 0; j < KF; ++j) {
    const int col = f - lo_f + j;
    col_ok[j] = col >= 0 && col < Fn;
  }

  const int64_t base = (int64_t)plane * Tn * Fn;
  const T* xp = x + base;
  T* yp = y + base;

  // acc[dt] is the partial sum of output row i - dt while input row i is read
  float acc[KT];
#pragma unroll
  for (int dt = 0; dt < KT; ++dt) acc[dt] = 0.0f;

#pragma unroll
  for (int i = 0; i < kRows + KT - 1; ++i) {
    const int r = t0 - lo_t + i;
    const bool row_ok = r >= 0 && r < Tn;
    const T* row = xp + (int64_t)r * Fn + (f - lo_f);
    float v[KF];
#pragma unroll
    for (int j = 0; j < KF; ++j) {
      v[j] = (row_ok && col_ok[j]) ? load(row + j) : 0.0f;
    }
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      float s = acc[dt];
#pragma unroll
      for (int j = 0; j < KF; ++j) s = fmaf(wr[dt][j], v[j], s);
      acc[dt] = s;
    }
    if (i >= KT - 1) {  // output row i - (KT - 1) has all its taps
      const int t = t0 + i - (KT - 1);
      if (t < Tn) store(yp + (int64_t)t * Fn + f, acc[KT - 1]);
    }
#pragma unroll
    for (int dt = KT - 1; dt > 0; --dt) acc[dt] = acc[dt - 1];
    acc[0] = 0.0f;
  }
}

// Any kernel size: one thread per output, the taps read through L1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_conv_generic_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ y, int C, int Tn, int Fn, int kt, int kf,
                       int lo_t, int lo_f, int tiles) {
  const int plane = blockIdx.x / tiles;
  const int idx = (blockIdx.x - plane * tiles) * kThreads + threadIdx.x;
  if (idx >= Tn * Fn) return;
  const int t = idx / Fn;
  const int f = idx - t * Fn;
  const float* wc = w + (int64_t)(plane % C) * (kt * kf);
  const int64_t base = (int64_t)plane * Tn * Fn;
  const T* xp = x + base;
  float s = 0.0f;
  for (int dt = 0; dt < kt; ++dt) {
    const int r = t - lo_t + dt;
    if (r < 0 || r >= Tn) continue;
    for (int df = 0; df < kf; ++df) {
      const int col = f - lo_f + df;
      if (col < 0 || col >= Fn) continue;
      s = fmaf(__ldg(wc + dt * kf + df), load(xp + (int64_t)r * Fn + col), s);
    }
  }
  store(y + base + idx, s);
}

template <typename T, int KT, int KF>
int launch_sliding(const T* x, const float* w, T* y, int planes, int C, int Tn,
                   int Fn, int lo_t, int lo_f, cudaStream_t s) {
  const int strips = (Tn + kRows - 1) / kRows;
  const int64_t tiles = ((int64_t)strips * Fn + kThreads - 1) / kThreads;
  if (tiles * planes > INT32_MAX) return (int)cudaErrorInvalidValue;
  dw_conv_sliding_kernel<T, KT, KF><<<(unsigned)(tiles * planes), kThreads, 0, s>>>(
      x, w, y, C, Tn, Fn, lo_t, lo_f, strips, (int)tiles);
  return 0;
}

template <typename T, int KT>
int launch_kt(const T* x, const float* w, T* y, int planes, int C, int Tn, int Fn,
              int kf, int lo_t, int lo_f, cudaStream_t s) {
  switch (kf) {
    case 2: return launch_sliding<T, KT, 2>(x, w, y, planes, C, Tn, Fn, lo_t, lo_f, s);
    case 3: return launch_sliding<T, KT, 3>(x, w, y, planes, C, Tn, Fn, lo_t, lo_f, s);
    case 4: return launch_sliding<T, KT, 4>(x, w, y, planes, C, Tn, Fn, lo_t, lo_f, s);
    default: return launch_sliding<T, KT, 5>(x, w, y, planes, C, Tn, Fn, lo_t, lo_f, s);
  }
}

template <typename T>
int launch(const void* xv, const float* w, void* yv, int planes, int C, int Tn,
           int Fn, int kt, int kf, int lo_t, int lo_f, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  if (kt >= 2 && kt <= 5 && kf >= 2 && kf <= 5) {
    switch (kt) {
      case 2: return launch_kt<T, 2>(x, w, y, planes, C, Tn, Fn, kf, lo_t, lo_f, s);
      case 3: return launch_kt<T, 3>(x, w, y, planes, C, Tn, Fn, kf, lo_t, lo_f, s);
      case 4: return launch_kt<T, 4>(x, w, y, planes, C, Tn, Fn, kf, lo_t, lo_f, s);
      default: return launch_kt<T, 5>(x, w, y, planes, C, Tn, Fn, kf, lo_t, lo_f, s);
    }
  }
  const int64_t tiles = ((int64_t)Tn * Fn + kThreads - 1) / kThreads;
  if (tiles * planes > INT32_MAX) return (int)cudaErrorInvalidValue;
  dw_conv_generic_kernel<T><<<(unsigned)(tiles * planes), kThreads, 0, s>>>(
      x, w, y, C, Tn, Fn, kt, kf, lo_t, lo_f, (int)tiles);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. planes = B * C. Returns 0 or a CUDA error
// code (cudaGetLastError() after the launch); the caller raises on non-zero.
extern "C" int rtfs_dw_conv2d_same(const void* x, const void* w, void* y,
                                   int planes, int C, int T, int F, int kt,
                                   int kf, int lo_t, int lo_f, int dtype,
                                   void* stream) {
  if (planes <= 0 || C <= 0 || planes % C != 0 || T <= 0 || F <= 0 || kt <= 0 ||
      kf <= 0 || lo_t < 0 || lo_t >= kt || lo_f < 0 || lo_f >= kf ||
      (int64_t)T * F > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  int err;
  if (dtype == 0) {
    err = launch<float>(x, wf, y, planes, C, T, F, kt, kf, lo_t, lo_f, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, wf, y, planes, C, T, F, kt, kf, lo_t, lo_f, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
