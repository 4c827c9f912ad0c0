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
// with lo + hi = k - 1 on each axis, applied while reading: no padded copy
// of x exists.
//   y[b, c, t, f] = sum_{dt, df} w[c, dt, df] * x[b, c, t + dt - lo_t, f + df - lo_f]
// Taps are summed in float32 in the order (dt, df); no bias.
//
// Bound on an H100: bytes. Each element is read once and written once,
// 2 * B*C*T*F * itemsize bytes, against 2 * k_t * k_f float32 operations
// per output: at (128, 64, 251, 129) that is 0.633 ms (float32) or 0.317 ms
// (bfloat16) of HBM traffic at 3.35 TB/s and 0.126 ms of float32 arithmetic
// at 67 TFLOP/s (an FMA being two operations): in bfloat16 the FMAs alone
// need 40% of the bytes' time.
//
// Design (dw_conv_band_kernel): a block owns a band of R output rows of one
// (b, c) plane across all of F, and walks bands with a stride of the grid
// (a persistent grid, as many blocks as fit on the SMs).
// - The input rows [t0 - lo_t, t0 + R + hi_t) of a plane are one contiguous
//   span of memory. The block copies it into shared memory with 16-byte
//   cp.async copies, while it computes the band before: two input buffers.
// - Misaligned starts: neither F = 129 nor a slice of a larger tensor keeps
//   rows or planes on 16-byte boundaries, so the span is treated as 1-D: its
//   start is aligned down and its end up to 16 bytes, and the extra elements
//   (parts of the neighbouring rows) are copied and never read. Only a
//   16-byte chunk that sticks out of the tensor itself, at its first or last
//   element, is copied element by element, so nothing outside x is read.
//   Padding rows and columns are never copied: the compute reads them as
//   zeros.
// - A thread task is V adjacent outputs (5 in float32, 6 in bfloat16) of 8
//   rows. The thread slides down the rows with the k_t x V partial sums and
//   the channel's float32 weights in registers; each input row's V + k_f - 1
//   values are read from shared memory once. Lanes are V elements apart, an
//   odd number of 4-byte words, so a warp's reads and writes of shared memory
//   fall in distinct banks. The loops are unrolled; 8 rows (not 16) keep the
//   body small enough for the instruction cache, which measured faster.
// - The outputs go to a third shared buffer laid out like the output band
//   [t0 * F, (t0 + R) * F), which is contiguous too, and are written back
//   with 16-byte stores; the at most two partial chunks at the band's ends,
//   which hold elements of the neighbouring bands, element by element.
// What holds it back: the compute. A 4x4 stencil costs 16 FMAs per output
// plus the shared-memory reads, conversions and stores, and the card issues
// it at well under its FMA rate; bfloat16 halves the bytes but not that
// work, so it runs near the float32 time, under half of its bytes bound.
// R and the block's threads come from the wrapper (ops/kernels/dw_conv.py:
// band_plan), which also picks the generic kernel when a band would not fit
// in shared memory. Kernel sizes outside 2..5 take a plain one-thread-per-
// output kernel whose re-reads go through L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 8;         // output rows per thread task
constexpr int kMaxThreads = 256;  // the band kernel's largest block
constexpr int kGenericThreads = 128;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Elements of T per 16 bytes.
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }

// Adjacent output columns per thread task: an odd word stride between the
// lanes of a warp (5 words in float32, 3 in bfloat16), so the lanes' shared
// reads and writes fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int cols() { return sizeof(T) == 4 ? 5 : 6; }

// The largest index <= g whose element of p starts on a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int64_t align_down(const T* p, int64_t g) {
  const int64_t mis = static_cast<int64_t>((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % vec<T>());
  return g - (g + mis) % vec<T>();
}

// Shared-memory elements of one input buffer and of the output buffer: the
// band plus up to one 16-byte chunk of slack at each end. Mirrored by
// ops/kernels/dw_conv.py:band_plan.
__host__ __device__ __forceinline__ int64_t round_up(int64_t a, int64_t b) {
  return (a + b - 1) / b * b;
}
template <typename T>
__host__ __device__ __forceinline__ int64_t in_elems(int R, int kt, int Fn) {
  return round_up((int64_t)(R + kt - 1) * Fn + 2 * vec<T>(), vec<T>());
}
template <typename T>
__host__ __device__ __forceinline__ int64_t out_elems(int R, int Fn) {
  return round_up((int64_t)R * Fn + 2 * vec<T>(), vec<T>());
}

struct Band {
  int64_t plane;
  int t0, rows;      // output rows [t0, t0 + rows)
  int r_s;           // first input row in the buffer
  int64_t g_s, g_e;  // the input span, elements of x
};

template <int KT>
__device__ __forceinline__ Band band_of(int64_t it, int bands, int R, int Tn, int Fn,
                                        int lo_t) {
  Band bd;
  bd.plane = it / bands;
  bd.t0 = static_cast<int>(it - bd.plane * bands) * R;
  bd.rows = min(R, Tn - bd.t0);
  bd.r_s = max(0, bd.t0 - lo_t);
  const int r_e = min(Tn, bd.t0 + R + (KT - 1 - lo_t));
  const int64_t base = bd.plane * Tn * Fn;
  bd.g_s = base + (int64_t)bd.r_s * Fn;
  bd.g_e = base + (int64_t)r_e * Fn;
  return bd;
}

// Start the copy of x[g_s, g_e) into buf, whose element 0 is x[align_down(g_s)].
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, int64_t n, const Band& bd,
                                      T* buf) {
  constexpr int V = vec<T>();
  const int64_t base = align_down(x, bd.g_s);
  const int chunks = static_cast<int>((bd.g_e - base + V - 1) / V);
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const int64_t g = base + (int64_t)q * V;
    T* dst = buf + q * V;
    if (g >= 0 && g + V <= n) {
      cp_async16(dst, x + g);
    } else {  // the chunk sticks out of x: copy only its elements in the span
      for (int e = 0; e < V; ++e) {
        const int64_t ge = g + e;
        if (ge >= bd.g_s && ge < bd.g_e) dst[e] = x[ge];
      }
    }
  }
}

// One thread task: the V adjacent outputs (f0 .. f0 + V - 1) of kStrip rows
// from shared memory. `in` points at input (ts - lo_t, f0 - lo_f), `out` at
// output (ts, f0); rows of both are Fn apart. Sliding down the rows, input
// row i is read once (V + KF - 1 values, zeros outside the plane: r0 and c0
// are the indices of its first row and column) and feeds the partial sums
// acc[dt][m] of outputs (ts + i - dt, f0 + m), kept in registers; the loops
// are unrolled, so the sums of rows outside the strip are never formed. Only
// the first `rows` rows and `ncols` columns of outputs are stored.
template <typename T, int KT, int KF, int V>
__device__ __forceinline__ void strip_task(const T* in, T* out, const float (&wr)[KT][KF],
                                           int Fn, int r0, int Tn, int c0, int rows,
                                           int ncols) {
  constexpr int W = V + KF - 1;
  bool col_ok[W];
#pragma unroll
  for (int j = 0; j < W; ++j) col_ok[j] = c0 + j >= 0 && c0 + j < Fn;
  float acc[KT][V] = {};
#pragma unroll
  for (int i = 0; i < kStrip + KT - 1; ++i) {
    const bool row_ok = r0 + i >= 0 && r0 + i < Tn;
    float x[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      x[j] = (row_ok && col_ok[j]) ? to_float(in[i * Fn + j]) : 0.0f;
    }
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      const int o = i - dt;  // tap row dt of input row i feeds output row o
      if (o < 0 || o >= kStrip) continue;  // outside the strip: never formed
#pragma unroll
      for (int m = 0; m < V; ++m) {
        float s = dt == 0 ? 0.0f : acc[dt][m];
#pragma unroll
        for (int j = 0; j < KF; ++j) s = fmaf(wr[dt][j], x[m + j], s);
        acc[dt][m] = s;
      }
    }
    if (i >= KT - 1) {  // output row i - (KT - 1) has all its taps
      const int o = i - (KT - 1);
      if (o < rows) {
#pragma unroll
        for (int m = 0; m < V; ++m) {
          if (m < ncols) store(out + (o * Fn + m), acc[KT - 1][m]);
        }
      }
    }
#pragma unroll
    for (int dt = KT - 1; dt > 0; --dt) {
#pragma unroll
      for (int m = 0; m < V; ++m) acc[dt][m] = acc[dt - 1][m];
    }
  }
}

// A persistent grid: block b takes bands b, b + gridDim.x, ... of the
// planes * bands bands (band it is band it % bands of plane it / bands).
template <typename T, int KT, int KF>
__global__ void __launch_bounds__(kMaxThreads, 2)
dw_conv_band_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, int C, int Tn, int Fn, int lo_t, int lo_f,
                    int R, int bands, int64_t total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = cols<T>();
  constexpr int VE = vec<T>();
  const int64_t in_n = in_elems<T>(R, KT, Fn);
  T* const buf0 = reinterpret_cast<T*>(smem_raw);  // input buffers at 0 and in_n
  T* const out = buf0 + 2 * in_n;
  const int64_t n = (total / bands) * Tn * Fn;  // elements of x
  const int groups = (Fn + V - 1) / V;           // V adjacent outputs per thread task

  int64_t it = blockIdx.x;
  stage(x, n, band_of<KT>(it, bands, R, Tn, Fn, lo_t), buf0);
  cp_async_commit();
  for (int k = 0; it < total; it += gridDim.x, ++k) {
    const int64_t next = it + gridDim.x;
    if (next < total) {  // the next band's copy runs behind this band's compute
      stage(x, n, band_of<KT>(next, bands, R, Tn, Fn, lo_t), buf0 + ((k + 1) & 1) * in_n);
    }
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this band's copy
    __syncthreads();  // ... has landed for every thread, and out is free again

    const Band bd = band_of<KT>(it, bands, R, Tn, Fn, lo_t);
    const T* in = buf0 + (k & 1) * in_n;
    const int in_off = static_cast<int>(bd.g_s - align_down(x, bd.g_s));
    const int64_t gy_s = bd.plane * Tn * Fn + (int64_t)bd.t0 * Fn;
    const int64_t gy_e = gy_s + (int64_t)bd.rows * Fn;
    const int64_t y_base = align_down(y, gy_s);
    const int out_off = static_cast<int>(gy_s - y_base);
    const float* wc = w + (bd.plane % C) * (KT * KF);
    float wr[KT][KF];
#pragma unroll
    for (int i = 0; i < KT; ++i) {
#pragma unroll
      for (int j = 0; j < KF; ++j) wr[i][j] = __ldg(wc + i * KF + j);
    }
    const int strips = (bd.rows + kStrip - 1) / kStrip;
    const int t_end = bd.t0 + bd.rows;
    for (int task = threadIdx.x; task < strips * groups; task += blockDim.x) {
      const int strip = task / groups;
      const int f0 = (task - strip * groups) * V;
      const int ts = bd.t0 + strip * kStrip;
      strip_task<T, KT, KF, V>(in + ((ts - lo_t - bd.r_s) * Fn + (f0 - lo_f) + in_off),
                               out + ((ts - bd.t0) * Fn + f0 + out_off), wr, Fn, ts - lo_t,
                               Tn, f0 - lo_f, min(kStrip, t_end - ts), min(V, Fn - f0));
    }
    __syncthreads();

    // write the band back: 16-byte stores, element by element at its ends
    const int chunks = static_cast<int>((gy_e - y_base + VE - 1) / VE);
    for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
      const int64_t g = y_base + (int64_t)q * VE;
      const T* src = out + q * VE;
      if (g >= gy_s && g + VE <= gy_e) {
        *reinterpret_cast<int4*>(y + g) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < VE; ++e) {
          const int64_t ge = g + e;
          if (ge >= gy_s && ge < gy_e) y[ge] = src[e];
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Any kernel size: one thread per output, the taps read through L1.
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
dw_conv_generic_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ y, int C, int Tn, int Fn, int kt, int kf,
                       int lo_t, int lo_f, int tiles) {
  const int plane = blockIdx.x / tiles;
  const int idx = (blockIdx.x - plane * tiles) * kGenericThreads + threadIdx.x;
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
      s = fmaf(__ldg(wc + dt * kf + df), to_float(xp[(int64_t)r * Fn + col]), s);
    }
  }
  store(y + base + idx, s);
}

struct Args {
  int planes, C, Tn, Fn, kt, kf, lo_t, lo_f, R, threads;
  cudaStream_t s;
};

template <typename T, int KT, int KF>
int launch_band(const T* x, const float* w, T* y, const Args& a) {
  auto kernel = dw_conv_band_kernel<T, KT, KF>;
  const int64_t smem =
      (2 * in_elems<T>(a.R, KT, a.Fn) + out_elems<T>(a.R, a.Fn)) * sizeof(T);
  if (smem > kMaxSmem || a.threads <= 0 || a.threads > kMaxThreads || a.threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  // per kernel: the shared-memory limit, lifted once; the SMs; the blocks
  // per SM of the last (threads, smem) asked for
  static bool opted_in = false;
  static int sms = 0, per_sm = 0, last_threads = 0;
  static int64_t last_smem = 0;
  cudaError_t err = cudaSuccess;
  if (!opted_in) {
    int dev = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  if (a.threads != last_threads || smem != last_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, a.threads, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    last_threads = a.threads;
    last_smem = smem;
  }
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int bands = (a.Tn + a.R - 1) / a.R;
  const int64_t total = (int64_t)a.planes * bands;
  const int64_t grid = total < (int64_t)per_sm * sms ? total : (int64_t)per_sm * sms;
  kernel<<<(unsigned)grid, a.threads, (size_t)smem, a.s>>>(x, w, y, a.C, a.Tn, a.Fn, a.lo_t,
                                                         a.lo_f, a.R, bands, total);
  return 0;
}

template <typename T, int KT>
int launch_kt(const T* x, const float* w, T* y, const Args& a) {
  switch (a.kf) {
    case 2: return launch_band<T, KT, 2>(x, w, y, a);
    case 3: return launch_band<T, KT, 3>(x, w, y, a);
    case 4: return launch_band<T, KT, 4>(x, w, y, a);
    default: return launch_band<T, KT, 5>(x, w, y, a);
  }
}

template <typename T>
int launch(const void* xv, const float* w, void* yv, const Args& a) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  if (a.R > 0) {
    if (a.kt < 2 || a.kt > 5 || a.kf < 2 || a.kf > 5) return (int)cudaErrorInvalidValue;
    switch (a.kt) {
      case 2: return launch_kt<T, 2>(x, w, y, a);
      case 3: return launch_kt<T, 3>(x, w, y, a);
      case 4: return launch_kt<T, 4>(x, w, y, a);
      default: return launch_kt<T, 5>(x, w, y, a);
    }
  }
  const int64_t tiles = ((int64_t)a.Tn * a.Fn + kGenericThreads - 1) / kGenericThreads;
  if (tiles * a.planes > INT32_MAX) return (int)cudaErrorInvalidValue;
  dw_conv_generic_kernel<T><<<(unsigned)(tiles * a.planes), kGenericThreads, 0, a.s>>>(
      x, w, y, a.C, a.Tn, a.Fn, a.kt, a.kf, a.lo_t, a.lo_f, (int)tiles);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. planes = B * C. rows_per_band > 0 takes
// the band kernel with that R and `threads` threads per block (k in 2..5 per
// axis); 0 takes the generic kernel. Returns 0 or a CUDA error code
// (cudaGetLastError() after the launch); the caller raises on non-zero.
extern "C" int rtfs_dw_conv2d_same(const void* x, const void* w, void* y,
                                   int planes, int C, int T, int F, int kt,
                                   int kf, int lo_t, int lo_f, int rows_per_band,
                                   int threads, int dtype, void* stream) {
  if (planes <= 0 || C <= 0 || planes % C != 0 || T <= 0 || F <= 0 || kt <= 0 ||
      kf <= 0 || lo_t < 0 || lo_t >= kt || lo_f < 0 || lo_f >= kf || rows_per_band < 0 ||
      (int64_t)T * F > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{planes, C, T, F, kt, kf, lo_t, lo_f, rows_per_band, threads,
               static_cast<cudaStream_t>(stream)};
  const float* wf = static_cast<const float*>(w);
  int err;
  if (dtype == 0) {
    err = launch<float>(x, wf, y, a);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, wf, y, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
