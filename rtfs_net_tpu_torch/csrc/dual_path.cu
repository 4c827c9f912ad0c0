// The DualPathRNN's ways into and out of the recurrence's layouts,
// inference (sm_90a).
//
// Replaces no TPU kernel. On the TPU the DualPathRNN
// (rtfs_net_tpu/models/layers/rnn_blocks.py: DualPathRNN) is left to XLA,
// which fuses its norm, unfold and transposes into the ops around the
// recurrence. In PyTorch each of them was its own pass over the block's
// (B, C, T, F) features, with strided layout copies at a small share of
// the card's bandwidth. These kernels are the layout changes left on the
// path (ops/kernels/dual_path.py; the routes are
// models/layers/rnn_blocks.py: DualPathRNN): for the SRU one pass in and
// one pass out of K1's layout, for cuDNN's LSTM or GRU one pass in.
//
// Layouts: x, residual and out are (B, C, T, F), F contiguous (x of
// windows_in may have any other strides). The sequence layout, K1's
// (ops/kernels/sru.py), is (S, C, rows) with S the recurrent axis and rows
// the other axis times B, b-major:
//   along T (seq_f = 0): y[t, c, b*F + f]   (S = T, rows = B*F)
//   along F (seq_f = 1): y[f, c, b*T + t]   (S = F, rows = B*T)
// The window layout, cuDNN's (L, rows, C*k) input with L = S - k + 1
// stride-1 windows of k steps, rows as above, columns c*k + j (the unfold's
// order):  w[l, r, c*k + j] = y[l + j, c, r].
//
// dual_path_norm_in_kernel: LayerNormalization4D over C
// (ops/normalizations.py), y = ((x - mean) * rsqrt(var + eps)) * gamma +
// beta, statistics in float32 (Welford, biased variance), cast to x's
// dtype and written in the sequence layout.
// dual_path_out_kernel: the overlap-add's output z, (S, C, rows) in the
// sequence layout, back to (B, C, T, F): out = z + bias[c] + residual,
// float32 sums, one rounding to the dtype.
// dual_path_windows_in_kernel: the same norm (two-pass float32 statistics,
// one rounding to x's dtype), written k times into the window layout.
//
// Bound on an H100: bytes; a few operations per element. norm_in reads x
// and writes y, out reads z and the residual and writes out, each element
// once: at the RTFS-Net-4 B=128 shapes (128, 64, 126, 65) in bfloat16 that
// is 268 MB and 402 MB, 80 and 120 us at 3.35 TB/s. windows_in reads x
// once and writes the windows, k times x: at TF-GridNet's B=128 shapes
// (128, 128, 251, 129), k = 4, in bfloat16 1.061 GB in and 4.145 GB (along
// F) or 4.193 GB (along T) out, 1.554 and 1.568 ms.
//
// Design of norm_in and out: a block takes a 32 x 32 tile of one sample's
// (t, f) plane with 256 threads as (32, 8), each thread 4 positions 8 apart
// along t, so every warp's read of x or the residual is 32 neighbouring f
// (64 bytes in bfloat16). Where the sequence layout's minor axis is f as
// well (along T), each thread writes straight from its registers. Along F
// its minor axis is t, so each channel's tile passes through shared memory
// (one float of padding per row against bank conflicts) and is written or
// read transposed, 32 neighbouring t per warp.
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
//
// Design of windows_in: the output is four times the input, so the writes
// set the pace. A block stages, for one sample, all C channels of a tile of
// (TL + k - 1) sequence steps x OW rows in shared memory, in x's dtype,
// channel-minor: position p holds its C values at p*Cp, Cp >= C padded so
// that Cp values span an odd number of 4-byte banks. One thread a position
// loads its C values (neighbouring threads on neighbouring f, so each load
// instruction reads consecutive addresses of x), sums them, then takes the
// variance and normalises in place, all from its own row of shared memory:
// no barrier until the tile is whole. Then each warp writes whole window
// rows (l, r): lane i gathers 16 bytes of c*k + j values from the tile and
// stores them as one vector, so a warp stores 512 consecutive bytes. Each
// normalised value is read from device memory once (plus the k - 1 steps
// of overlap between neighbouring tiles along T) and written k times.
// Tiles: along F, OW = 2 rows (bfloat16) by all 126 windows, 67 KB; along
// T, 16 rows by 16 windows, 80 KB (each read of x there is 16 neighbouring
// f); three or two blocks an SM.
// Measured on an H100 at the B=128 bfloat16 shapes (zero_ of the windows
// runs at 3.29 TB/s there): along T 2.56 ms, 61% of the bound, with 8x32,
// 32x8 and 16x8 tiles 2-7% slower; along F 3.57-3.77 ms with plain stores
// at every tile tried (128x2, 64x4, 32x4, 32x8; 16x16 and 8x32 4.96-5.17),
// 2.50 with evict-first stores (__stcs), which cost 25% along T, so the
// store follows the axis; __stcg and __stwt alike along F, slower along
// T; 32 loads in flight a thread instead of 16: 2.49 (T), 2.44 (F) ms.
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

// windows_in: the most threads a block takes; a block has one thread a
// tile position, rounded up to whole warps
constexpr int kWinThreads = 512;

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// grid = tiles_o * tiles_l * B blocks; dynamic shared memory: the tile,
// (TL + k - 1) * OW positions of Cp values of T. kK > 0 fixes k at compile
// time. Positions: p = o * SL + s along F (the step s is f, x's minor axis),
// p = s * OW + o along T (o is f), so neighbouring threads load
// neighbouring f.
template <typename T, bool kSeqF, int kK>
__global__ void __launch_bounds__(kWinThreads)
dual_path_windows_in_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                            const float* __restrict__ beta, T* __restrict__ w, int B, int C,
                            int Tn, int Fn, int64_t sb, int64_t sc, int64_t st, int k_arg,
                            int TL, int OW, int Cp, int tiles_o, int tiles_l, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int k = kK > 0 ? kK : k_arg;
  const int S = kSeqF ? Fn : Tn, other = kSeqF ? Tn : Fn;
  const int L = S - k + 1, SL = TL + k - 1;
  int idx = blockIdx.x;
  const int o0 = (idx % tiles_o) * OW;
  idx /= tiles_o;
  const int l0 = (idx % tiles_l) * TL;
  const int b = idx / tiles_l;
  const int on = min(OW, other - o0), ln = min(TL, L - l0), sn = ln + k - 1;

  // each thread its positions: load C values, then mean, variance and the
  // normalised values, from its own row of the tile
  const T* xb = x + (int64_t)b * sb;
  const float n = static_cast<float>(C);
  for (int p = threadIdx.x; p < SL * OW; p += blockDim.x) {
    const int s = kSeqF ? p % SL : p / OW, o = kSeqF ? p / SL : p % OW;
    if (s >= sn || o >= on) continue;
    const T* xp = xb + (kSeqF ? (int64_t)(o0 + o) * st + (l0 + s)
                              : (int64_t)(l0 + s) * st + (o0 + o));
    T* tp = tile + p * Cp;
    float sum = 0.0f;
#pragma unroll 32
    for (int c = 0; c < C; ++c) {
      const T v = xp[c * sc];
      tp[c] = v;
      sum += to_float(v);
    }
    const float mean = sum / n;
    float m2 = 0.0f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float d = to_float(tp[c]) - mean;
      m2 += d * d;
    }
    const float rstd = rsqrtf(m2 / n + eps);
#pragma unroll 8
    for (int c = 0; c < C; ++c) {  // torch's order: (x - mean) * rstd, * gamma, + beta
      const float y = __fmul_rn(to_float(tp[c]) - mean, rstd);
      store(tp + c, __fadd_rn(__fmul_rn(y, __ldg(gamma + c)), __ldg(beta + c)));
    }
  }
  __syncthreads();

  // each warp whole window rows (l, r): w[l, r, c*k + j] = y[l + j, c, r]
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int ck = C * k;
  const int64_t rows = (int64_t)B * other;
  const int jstep = kSeqF ? 1 : OW;  // positions from step s to s + 1
  constexpr int kV = 16 / sizeof(T);
  const bool vec = ck % kV == 0;
  for (int row = threadIdx.x >> 5; row < ln * on; row += warps) {
    const int l = row / on, o = row - l * on;
    const int p0 = kSeqF ? o * SL + l : l * OW + o;
    T* dst = w + ((int64_t)(l0 + l) * rows + (int64_t)b * other + o0 + o) * ck;
    if (vec) {
      for (int e = lane * kV; e < ck; e += 32 * kV) {
        int c = e / k, j = e - c * k;
        uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const uint32_t v = bits(tile[(p0 + j * jstep) * Cp + c]);
          if constexpr (sizeof(T) == 4) {
            word[i] = v;
          } else {
            word[i >> 1] |= v << (16 * (i & 1));
          }
          if (++j == k) {
            j = 0;
            ++c;
          }
        }
        const uint4 v = make_uint4(word[0], word[1], word[2], word[3]);
        if constexpr (kSeqF) {
          __stcs(reinterpret_cast<uint4*>(dst + e), v);  // evict first: see the note
        } else {
          *reinterpret_cast<uint4*>(dst + e) = v;
        }
      }
    } else {
      for (int e = lane; e < ck; e += 32) {
        const int c = e / k, j = e - c * k;
        dst[e] = tile[(p0 + j * jstep) * Cp + c];
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

template <typename T>
using WindowsInKernel = void (*)(const T*, const float*, const float*, T*, int, int, int, int,
                                 int64_t, int64_t, int64_t, int, int, int, int, int, int, float);

template <typename T, bool kSeqF>
WindowsInKernel<T> windows_in_kernel(int k) {
  return k == 4 ? dual_path_windows_in_kernel<T, kSeqF, 4>
                : dual_path_windows_in_kernel<T, kSeqF, 0>;
}

template <typename T>
int windows_in(const void* x, const void* gamma, const void* beta, void* w, int B, int C,
               int Tn, int Fn, int64_t sb, int64_t sc, int64_t st, bool seq_f, int k,
               float eps, cudaStream_t s) {
  const int S = seq_f ? Fn : Tn, other = seq_f ? Tn : Fn, L = S - k + 1;
  // Cp values of T span an odd number of 4-byte banks
  int Cp = C;
  if (sizeof(T) == 4) {
    Cp |= 1;
  } else {
    Cp += Cp & 1;
    if (Cp / 2 % 2 == 0) Cp += 2;
  }
  int OW = seq_f ? (sizeof(T) == 2 ? 2 : 1) : 16;
  int TL = seq_f ? 128 : (sizeof(T) == 2 ? 16 : 8);
  OW = OW < other ? OW : other;
  TL = TL < L ? TL : L;
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  auto bytes = [&] { return (int64_t)(TL + k - 1) * OW * Cp * (int64_t)sizeof(T); };
  while (bytes() > limit && TL > 1) TL = (TL + 1) / 2;
  while (bytes() > limit && OW > 1) OW = (OW + 1) / 2;
  if (bytes() > limit) return (int)cudaErrorInvalidConfiguration;
  const int tiles_o = (other + OW - 1) / OW, tiles_l = (L + TL - 1) / TL;
  const int64_t blocks = (int64_t)tiles_o * tiles_l * B;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int positions = (TL + k - 1) * OW;
  int threads = (positions + 31) / 32 * 32;
  threads = threads < 64 ? 64 : (threads > kWinThreads ? kWinThreads : threads);
  const WindowsInKernel<T> kernel =
      seq_f ? windows_in_kernel<T, true>(k) : windows_in_kernel<T, false>(k);
  const int smem = static_cast<int>(bytes());
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(w), B, C, Tn, Fn, sb, sc, st, k, TL,
      OW, Cp, tiles_o, tiles_l, eps);
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

// x's strides sb, sc, st in elements (F's is 1); w is (L, rows, C*k),
// contiguous, L = S - k + 1 with 1 <= k <= S.
extern "C" int rtfs_dual_path_windows_in(const void* x, const void* gamma, const void* beta,
                                         void* w, int B, int C, int T, int F, long long sb,
                                         long long sc, long long st, int seq_f, int k,
                                         float eps, int dtype, void* stream) {
  if (!valid(B, C, T, F, seq_f, dtype) || k < 1 || k > (seq_f == 1 ? F : T)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0
      ? windows_in<float>(x, gamma, beta, w, B, C, T, F, sb, sc, st, seq_f == 1, k, eps, s)
      : windows_in<__nv_bfloat16>(x, gamma, beta, w, B, C, T, F, sb, sc, st, seq_f == 1, k,
                                  eps, s);
  return err != 0 ? err : (int)cudaGetLastError();
}
