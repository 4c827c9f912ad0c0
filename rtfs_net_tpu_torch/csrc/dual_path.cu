// The SRU DualPathRNN's way into and out of the recurrence's layout,
// inference (sm_90a).
//
// Replaces no TPU kernel. On the TPU the DualPathRNN
// (rtfs_net_tpu/models/layers/rnn_blocks.py: DualPathRNN) is left to XLA,
// which fuses its norm and transposes into the ops around the Pallas SRU
// kernel. In PyTorch each of them was its own pass over the block's
// (B, C, T, F) features, with strided layout copies at a small share of
// the card's bandwidth. These two kernels are the only layout changes left
// on the path: one pass in, one pass out (ops/kernels/dual_path.py; the
// route is models/layers/rnn_blocks.py: DualPathRNN).
//
// Layouts: x, residual and out are (B, C, T, F), contiguous. The sequence
// layout, K1's (ops/kernels/sru.py), is (S, C, rows) with S the recurrent
// axis and rows the other axis times B, b-major:
//   along T (seq_f = 0): y[t, c, b*F + f]   (S = T, rows = B*F)
//   along F (seq_f = 1): y[f, c, b*T + t]   (S = F, rows = B*T)
//
// dual_path_norm_in_kernel: LayerNormalization4D over C
// (ops/normalizations.py), y = ((x - mean) * rsqrt(var + eps)) * gamma +
// beta, statistics in float32 (Welford, biased variance), cast to x's
// dtype and written in the sequence layout.
// dual_path_out_kernel: the overlap-add's output z, (S, C, rows) in the
// sequence layout, back to (B, C, T, F): out = z + bias[c] + residual,
// float32 sums, one rounding to the dtype.
//
// Bound on an H100: bytes; a few operations per element. norm_in reads x
// and writes y, out reads z and the residual and writes out, each element
// once: at the RTFS-Net-4 B=128 shapes (128, 64, 126, 65) in bfloat16 that
// is 268 MB and 402 MB, 80 and 120 us at 3.35 TB/s.
//
// Design: a block takes a 32 x 32 tile of one sample's (t, f) plane with
// 256 threads as (32, 8), each thread 4 positions 8 apart along t, so
// every warp's read of x or the residual is 32 neighbouring f (64 bytes in
// bfloat16). Where the sequence layout's minor axis is f as well (along
// T), each thread writes straight from its registers. Along F its minor
// axis is t, so each channel's tile passes through shared memory (one float
// of padding per row against bank conflicts) and is written or read
// transposed, 32 neighbouring t per warp.
// - norm_in needs all of C before it writes: a first sweep over C keeps
//   each position's Welford mean and M2 in registers, a second reads x
//   again (the block's C x 32 x 32 tile, mostly from L2) and writes. Each
//   sweep issues the loads of kUnroll channels before it uses any. Along F
//   the shared tile is double-buffered by the channel's parity, so one
//   barrier per channel suffices.
// - out has nothing to reduce: a block is one (b, c) tile.
// Measured on an H100 at the B=128 shapes: kUnroll 1 or 2 alike, 4 and 8
// slower (80-144 registers a thread cut the blocks an SM holds); 16-wide
// tiles (less waste at F = 65) with 8 channels a block in out slower at
// both axes.
// Grids are one-dimensional (tile, sample[, channel]), which keeps any B*C
// under the grid's limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32, kLines = 8, kPer = kTile / kLines;  // block (kTile, kLines)
constexpr int kUnroll = 2;  // norm_in: channels loaded before any is used

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// grid = tilesF * tilesT * B blocks, block (kTile, kLines).
template <typename T, bool kSeqF>
__global__ void __launch_bounds__(kTile * kLines)
dual_path_norm_in_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y, int C, int Tn,
                         int Fn, int tiles_f, int tiles_t, float eps) {
  __shared__ float tile[2][kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  int idx = blockIdx.x;
  const int f0 = (idx % tiles_f) * kTile;
  idx /= tiles_f;
  const int t0 = (idx % tiles_t) * kTile;
  const int b = idx / tiles_t;
  const int B = gridDim.x / (tiles_f * tiles_t);
  const int64_t plane = (int64_t)Tn * Fn;
  const T* xb = x + (int64_t)b * C * plane;
  const int f = f0 + tx;

  bool in[kPer];
  int64_t off[kPer];
  float mean[kPer], m2[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int t = t0 + ty + j * kLines;
    in[j] = t < Tn && f < Fn;
    off[j] = (int64_t)t * Fn + f;
    mean[j] = 0.0f;
    m2[j] = 0.0f;
  }
  for (int c0 = 0; c0 < C; c0 += kUnroll) {
    float v[kUnroll][kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        v[u][j] = c0 + u < C && in[j] ? to_float(xb[(c0 + u) * plane + off[j]]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u < C) {
        const float inv = 1.0f / static_cast<float>(c0 + u + 1);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float d = v[u][j] - mean[j];
          mean[j] += d * inv;
          m2[j] += d * (v[u][j] - mean[j]);
        }
      }
    }
  }
  float rstd[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) rstd[j] = rsqrtf(m2[j] / static_cast<float>(C) + eps);

  for (int c0 = 0; c0 < C; c0 += kUnroll) {
    float v[kUnroll][kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        v[u][j] = c0 + u < C && in[j] ? to_float(xb[(c0 + u) * plane + off[j]]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u;
      if (c < C) {  // the same for every thread, so the barrier below is reached by all
        const float g = gamma[c], be = beta[c];
        if constexpr (!kSeqF) {
          const int64_t rows = (int64_t)B * Fn;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            if (in[j]) {
              const int t = t0 + ty + j * kLines;
              store(y + ((int64_t)t * C + c) * rows + (int64_t)b * Fn + f,
                    (v[u][j] - mean[j]) * rstd[j] * g + be);
            }
          }
        } else {
          const int64_t rows = (int64_t)B * Tn;
          float (*buf)[kTile + 1] = tile[c & 1];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            buf[ty + j * kLines][tx] = (v[u][j] - mean[j]) * rstd[j] * g + be;
          }
          __syncthreads();
          const int t = t0 + tx;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const int fl = ty + j * kLines;
            if (t < Tn && f0 + fl < Fn) {
              store(y + ((int64_t)(f0 + fl) * C + c) * rows + (int64_t)b * Tn + t,
                    buf[tx][fl]);
            }
          }
        }
      }
    }
  }
}

// grid = tilesF * tilesT * B * C blocks, block (kTile, kLines).
template <typename T, bool kSeqF>
__global__ void __launch_bounds__(kTile * kLines)
dual_path_out_kernel(const T* __restrict__ z, const float* __restrict__ bias,
                     const T* __restrict__ res, T* __restrict__ out, int B, int C, int Tn,
                     int Fn, int tiles_f, int tiles_t) {
  __shared__ float tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  int idx = blockIdx.x;
  const int f0 = (idx % tiles_f) * kTile;
  idx /= tiles_f;
  const int t0 = (idx % tiles_t) * kTile;
  const int bc = idx / tiles_t;
  const int b = bc / C, c = bc % C;
  const float bi = bias[c];
  const int64_t base = (int64_t)bc * Tn * Fn;  // the (b, c) plane of out and res
  const int f = f0 + tx;
  if constexpr (!kSeqF) {
    const int64_t rows = (int64_t)B * Fn;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int t = t0 + ty + j * kLines;
      if (t < Tn && f < Fn) {
        const int64_t o = base + (int64_t)t * Fn + f;
        const float zv = to_float(z[((int64_t)t * C + c) * rows + (int64_t)b * Fn + f]);
        store(out + o, zv + bi + to_float(res[o]));
      }
    }
  } else {
    const int64_t rows = (int64_t)B * Tn;
    const int t = t0 + tx;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int fl = ty + j * kLines;
      if (t < Tn && f0 + fl < Fn) {
        tile[fl][tx] = to_float(z[((int64_t)(f0 + fl) * C + c) * rows + (int64_t)b * Tn + t]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int tl = ty + j * kLines;
      if (t0 + tl < Tn && f < Fn) {
        const int64_t o = base + (int64_t)(t0 + tl) * Fn + f;
        store(out + o, tile[tx][tl] + bi + to_float(res[o]));
      }
    }
  }
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

template <typename T>
int norm_in(const void* x, const void* gamma, const void* beta, void* y, int B, int C, int Tn,
            int Fn, bool seq_f, float eps, cudaStream_t s) {
  const int tf = tiles(Fn), tt = tiles(Tn);
  const int64_t blocks = (int64_t)tf * tt * B;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = seq_f ? dual_path_norm_in_kernel<T, true> : dual_path_norm_in_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), dim3(kTile, kLines), 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), C, Tn, Fn, tf, tt, eps);
  return 0;
}

template <typename T>
int residual_out(const void* z, const void* bias, const void* res, void* out, int B, int C,
                 int Tn, int Fn, bool seq_f, cudaStream_t s) {
  const int tf = tiles(Fn), tt = tiles(Tn);
  const int64_t blocks = (int64_t)tf * tt * B * C;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = seq_f ? dual_path_out_kernel<T, true> : dual_path_out_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), dim3(kTile, kLines), 0, s>>>(
      static_cast<const T*>(z), static_cast<const float*>(bias), static_cast<const T*>(res),
      static_cast<T*>(out), B, C, Tn, Fn, tf, tt);
  return 0;
}

bool valid(int B, int C, int Tn, int Fn, int seq_f, int dtype) {
  return B > 0 && C > 0 && Tn > 0 && Fn > 0 && (seq_f == 0 || seq_f == 1) &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; gamma, beta and bias float32 (C,).
// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int rtfs_dual_path_norm_in(const void* x, const void* gamma, const void* beta,
                                      void* y, int B, int C, int T, int F, int seq_f,
                                      float eps, int dtype, void* stream) {
  if (!valid(B, C, T, F, seq_f, dtype)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0
      ? norm_in<float>(x, gamma, beta, y, B, C, T, F, seq_f == 1, eps, s)
      : norm_in<__nv_bfloat16>(x, gamma, beta, y, B, C, T, F, seq_f == 1, eps, s);
  return err != 0 ? err : (int)cudaGetLastError();
}

extern "C" int rtfs_dual_path_out(const void* z, const void* bias, const void* residual,
                                  void* out, int B, int C, int T, int F, int seq_f, int dtype,
                                  void* stream) {
  if (!valid(B, C, T, F, seq_f, dtype)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0
      ? residual_out<float>(z, bias, residual, out, B, C, T, F, seq_f == 1, s)
      : residual_out<__nv_bfloat16>(z, bias, residual, out, B, C, T, F, seq_f == 1, s);
  return err != 0 ? err : (int)cudaGetLastError();
}
