// One SRU direction's recurrence on the (L, rows, H) layout, inference (sm_90a).
//
// Replaces the TPU kernel rtfs_net_tpu/ops/pallas/sru_kernel.py:
// sru_direction_pallas (Pallas body `_sru_dir_kernel`). Its tiling of the
// rows to a VMEM budget and its padding of the rows to a sublane multiple
// have no counterpart here: a register carry has no limit on L or rows.
//
// Layout (H minor):
//   u0, u1, u2, skip  (L, rows, H), each with its own element strides along
//                     t and rows and stride 1 along h, so the slices
//                     u[:, :, c, d*H:(d+1)*H] of one (L, rows, k, O)
//                     projection are read in place
//   v_f, v_r, b_f, b_r (H,) float32
//   out               (L, rows, H) contiguous, in the operands' dtype
// With a float32 carry c starting at 0 (reverse walks t = L-1 .. 0):
//   f = sigmoid(u1 + v_f*c + b_f),  r = sigmoid(u2 + v_r*c + b_r)   (c_{t-1})
//   c = f*c + (1-f)*u0,             h = r*c + (1-r)*skip
//
// Bound on an H100: bytes. Four operands read once and one output written
// once, 5 * L*rows*H * itemsize bytes, against about 22 float32 operations
// per output element. The step is not associative (the carry sits inside
// the sigmoid), so each (row, h) chain runs its L steps in order on one
// thread; the levers are the bytes each chain keeps in flight and how the
// chains spread over the card.
//
// Design: the ring of the layer kernel (sru_stack_layer.cu) on this layout.
// Thread index -> (row, h) = (idx / H, idx % H), so with H = 32 a warp
// takes one row's 32 h. Each warp has a ring of D steps in shared memory:
// per step the warp's 32 elements of each of u0, u1, u2 and skip, copied
// with 4-byte cp.async and drained in chunks of 4 steps between
// cp.async.wait_groups, each chunk run as one block of code.
// - Float32: each lane copies its own element, whatever the strides.
// - Bfloat16: a 4-byte word holds two neighbouring h, and lane l copies the
//   word of the warp's elements 2l and 2l + 1. That needs H even (so a word
//   never straddles two rows) and every operand's base and its t and row
//   strides to keep the words 4-byte aligned; the warp syncs after the wait
//   and after reading a chunk, as the layer kernel does.
// - The wrapper (ops/kernels/sru_direction.py: launch_plan) picks the kernel
//   and D by the layer kernel's rule (ops/kernels/sru.py: ring_plan): D = 32
//   where an SM holds at most one block, 8 up to what the card holds at
//   once, the narrow kernel beyond; and the narrow kernel for what a word
//   copy cannot take (odd H, a misaligned operand). The narrow kernel is the
//   first design: scalar loads through the strides, 4 steps unrolled.
// A launch holds half of the layer kernel's threads (one direction), so at
// the B = 1 and B = 4 shapes the chain of exact sigmoids sets the time.
//
// The file is self-contained (the build hashes only this source), so the
// cp.async helpers and the step are copies of sru_stack_layer.cu's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kChunk = 4;         // steps per wait of the ring, run as one block of code
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void sync_lanes() {
  if constexpr (sizeof(T) == 2) __syncwarp();
}

struct Gates {
  float vf, vr, bf, br;
};

// One step: updates the carry c, returns h.
__device__ __forceinline__ float forward_step(const Gates& g, float& c, float x0, float x1,
                                              float x2, float xs) {
  const float f = sigmoid(x1 + g.vf * c + g.bf);
  const float r = sigmoid(x2 + g.vr * c + g.br);
  c = f * c + (1.0f - f) * x0;
  return r * c + (1.0f - r) * xs;
}

// Element strides of one operand along t and along rows.
struct Strides {
  int64_t t, row;
};

struct Operands {
  const void *u0, *u1, *u2, *skip;
  Strides s0, s1, s2, ss;
};

// The ring kernel. grid = ceil(rows * H / kThreads); dynamic shared
// memory kWarps * D * 4 * 32 * sizeof(T).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
sru_direction_ring_kernel(Operands ops, const float* __restrict__ v_f,
                          const float* __restrict__ v_r, const float* __restrict__ b_f,
                          const float* __restrict__ b_r, T* __restrict__ out, int L,
                          int rows, int H, int reverse) {
  constexpr int kOps = 4, kChunks = D / kChunk, kSlot = kOps * 32;
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = (int64_t)rows * H;
  const int64_t first = (int64_t)blockIdx.x * kThreads + warp * 32;  // the warp's first element
  if (first >= n) return;  // the whole warp
  const int nvalid = n - first < 32 ? (int)(n - first) : 32;
  const int words = nvalid / kPerWord;  // H even in bfloat16, so nvalid is even
  const bool active = lane < nvalid;
  const int64_t idx = first + (active ? lane : 0);
  const int64_t row = idx / H;
  const int h = (int)(idx - row * H);
  const Gates g{v_f[h], v_r[h], b_f[h], b_r[h]};
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * (D * kSlot);

  // the element whose word this lane copies, and the copy cursors there
  const int64_t cidx = first + (lane < words ? kPerWord * lane : 0);
  const int64_t crow = cidx / H, ch = cidx - crow * H;
  const int64_t t0 = reverse ? L - 1 : 0, sign = reverse ? -1 : 1;
  const T* l0 = static_cast<const T*>(ops.u0) + crow * ops.s0.row + ch + t0 * ops.s0.t;
  const T* l1 = static_cast<const T*>(ops.u1) + crow * ops.s1.row + ch + t0 * ops.s1.t;
  const T* l2 = static_cast<const T*>(ops.u2) + crow * ops.s2.row + ch + t0 * ops.s2.t;
  const T* ls = static_cast<const T*>(ops.skip) + crow * ops.ss.row + ch + t0 * ops.ss.t;
  const int64_t d0 = sign * ops.s0.t, d1 = sign * ops.s1.t, d2 = sign * ops.s2.t,
                ds = sign * ops.ss.t;
  int issued = 0;  // steps whose copies are issued
  auto issue_chunk = [&]() {
    T* dst = ring + ((issued / kChunk) % kChunks) * (kChunk * kSlot) + lane * kPerWord;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      if (issued + kk < L) {
        if (lane < words) {
          cp_async4(dst + kk * kSlot, l0);
          cp_async4(dst + kk * kSlot + 32, l1);
          cp_async4(dst + kk * kSlot + 64, l2);
          cp_async4(dst + kk * kSlot + 96, ls);
        }
        l0 += d0; l1 += d1; l2 += d2; ls += ds;
      }
    }
    issued += kChunk;
    cp_async_commit();
  };
  for (int q = 0; q < kChunks - 1; ++q) issue_chunk();

  const int64_t o_step = sign * n;
  T* po = out + idx + t0 * n;
  float c = 0.0f;
  for (int base = 0; base < L; base += kChunk) {
    issue_chunk();  // into the slots the previous chunk freed
    cp_async_wait<kChunks - 1>();  // this chunk's copies have landed
    sync_lanes<T>();
    const T* src = ring + ((base / kChunk) % kChunks) * (kChunk * kSlot) + lane;
    float x[kChunk][kOps];
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
#pragma unroll
      for (int o = 0; o < kOps; ++o) x[kk][o] = to_float(src[kk * kSlot + o * 32]);
    }
    sync_lanes<T>();  // every lane has read the chunk
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      if (base + kk < L) {
        const float hv = forward_step(g, c, x[kk][0], x[kk][1], x[kk][2], x[kk][3]);
        if (active) store(po, hv);
        po += o_step;
      }
    }
  }
  cp_async_wait<0>();
}

// The narrow kernel: scalar loads through the strides, 4 steps unrolled.
// grid = ceil(rows * H / kThreads).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sru_direction_kernel(Operands ops, const float* __restrict__ v_f,
                     const float* __restrict__ v_r, const float* __restrict__ b_f,
                     const float* __restrict__ b_r, T* __restrict__ out, int L, int rows,
                     int H, int reverse) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)rows * H) return;
  const int64_t row = idx / H;
  const int h = (int)(idx - row * H);
  const Gates g{v_f[h], v_r[h], b_f[h], b_r[h]};
  const T* p0 = static_cast<const T*>(ops.u0) + row * ops.s0.row + h;
  const T* p1 = static_cast<const T*>(ops.u1) + row * ops.s1.row + h;
  const T* p2 = static_cast<const T*>(ops.u2) + row * ops.s2.row + h;
  const T* ps = static_cast<const T*>(ops.skip) + row * ops.ss.row + h;
  T* po = out + idx;
  const int64_t o_step = (int64_t)rows * H;

  float c = 0.0f;
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    const int64_t t = reverse ? L - 1 - i : i;
    store(po + t * o_step, forward_step(g, c, ld(p0 + t * ops.s0.t), ld(p1 + t * ops.s1.t),
                                        ld(p2 + t * ops.s2.t), ld(ps + t * ops.ss.t)));
  }
}

struct Args {
  Operands ops;
  const float *vf, *vr, *bf, *br;
  void* out;
  int L, rows, H, reverse;
  cudaStream_t s;
};

template <typename T, int D>
int ring(const Args& a, unsigned grid) {
  auto kernel = sru_direction_ring_kernel<T, D>;
  const int smem = kWarps * D * 4 * 32 * sizeof(T);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, a.s>>>(a.ops, a.vf, a.vr, a.bf, a.br,
                                         static_cast<T*>(a.out), a.L, a.rows, a.H, a.reverse);
  return 0;
}

template <typename T>
int launch(const Args& a, int depth) {
  const int64_t n = (int64_t)a.rows * a.H;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  switch (depth) {
    case 0:
      sru_direction_kernel<T><<<grid, kThreads, 0, a.s>>>(
          a.ops, a.vf, a.vr, a.bf, a.br, static_cast<T*>(a.out), a.L, a.rows, a.H, a.reverse);
      return 0;
    case 8: return ring<T, 8>(a, grid);
    case 32: return ring<T, 32>(a, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The ring copies 4-byte words: always aligned in float32; in bfloat16 when
// H is even and every operand's base and strides keep its words aligned.
bool ring_ok(int dtype, int H, const Operands& o) {
  if (dtype == 0) return true;
  if (H % 2) return false;
  for (const void* p : {o.u0, o.u1, o.u2, o.skip}) {
    if (reinterpret_cast<uintptr_t>(p) % 4) return false;
  }
  for (const Strides& s : {o.s0, o.s1, o.s2, o.ss}) {
    if (s.t % 2 || s.row % 2) return false;
  }
  return true;
}

}  // namespace

// strides: 8 element strides on the host, (t, row) of u0, u1, u2, skip in
// that order. dtype: 0 = float32, 1 = bfloat16. depth: the ring's D (8 or
// 32), or 0 for the narrow kernel; a ring on words that are not 4-byte
// aligned is refused. Returns cudaGetLastError() after the launch (0 on success);
// the caller raises on anything else.
extern "C" int rtfs_sru_direction(const void* u0, const void* u1, const void* u2,
                                  const void* skip, const int64_t* strides,
                                  const void* v_f, const void* v_r,
                                  const void* b_f, const void* b_r, void* out,
                                  int L, int rows, int H, int reverse, int depth,
                                  int dtype, void* stream) {
  if (L <= 0 || rows <= 0 || H <= 0 || strides == nullptr || (dtype != 0 && dtype != 1) ||
      ((int64_t)rows * H + kThreads - 1) / kThreads > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.ops = Operands{u0, u1, u2, skip, Strides{strides[0], strides[1]},
                   Strides{strides[2], strides[3]}, Strides{strides[4], strides[5]},
                   Strides{strides[6], strides[7]}};
  if (depth != 0 && !ring_ok(dtype, H, a.ops)) return (int)cudaErrorInvalidValue;
  a.vf = static_cast<const float*>(v_f);
  a.vr = static_cast<const float*>(v_r);
  a.bf = static_cast<const float*>(b_f);
  a.br = static_cast<const float*>(b_r);
  a.out = out; a.L = L; a.rows = rows; a.H = H; a.reverse = reverse;
  a.s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0 ? launch<float>(a, depth) : launch<__nv_bfloat16>(a, depth);
  return err != 0 ? err : (int)cudaGetLastError();
}
