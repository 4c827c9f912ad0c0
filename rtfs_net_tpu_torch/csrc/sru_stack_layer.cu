// One SRU layer's recurrence, both directions, inference (sm_90a).
//
// Replaces the TPU kernel rtfs_net_tpu/ops/pallas/sru_kernel_v3.py:
// sru_stack_layer (Pallas body `_kernel`, plus the carry-chunked long-L
// body `_kernel_chunk`, which existed only to fit VMEM and has no
// counterpart here: a register carry has no limit on L).
//
// Layout, as the TPU kernel's (rows = the folded batch, minor):
//   u    (L, k*O, rows)  chunk-major columns c*O + d*H + h, c in {0,1,2[,3]}
//   skip (L, O, rows)    the highway input when k == 3; when k == 4 the
//                        4th u chunk is the highway and skip is not read
//   v, b (2*O,) float32  v[d*H+h] = v_f, v[O+d*H+h] = v_r; b likewise
//   out  (L, O, rows)    in u's dtype (float32 or bfloat16)
// Per direction (d == 1 walks t = L-1 .. 0), float32 carry c starting at 0:
//   f = sigmoid(u1 + v_f*c + b_f),  r = sigmoid(u2 + v_r*c + b_r)   (c_{t-1})
//   c = f*c + (1-f)*u0,             h = r*c + (1-r)*skip
//
// Bound on an H100: bytes. Each element of u (and skip) is read once and
// each output written once, (k*O + O [+ O if k == 3]) * L * rows * itemsize
// bytes, against about 22 float32 operations per output element: at the
// RTFS-Net-4 shapes that is tens of microseconds of HBM traffic and a few
// of arithmetic.
//
// Why L is not split: f = sigmoid(u1 + v_f*c + b_f) puts the carry inside
// the sigmoid, so the step is not an associative operator and a split of L
// with a carry fix-up computes another function. Each (direction, h, row)
// chain runs its L steps in order on one thread, and the only levers are
// how many bytes each chain keeps in flight and how the chains spread over
// the card.
//
// Design: the forward ring of the training kernel (sru_train.cu), without
// its store of c. One thread owns one (direction, h, row) and walks L with
// the carry in a register; neighbouring threads take neighbouring rows, so
// each warp's access to an operand at one step is one 32-row segment.
// - Each warp has a ring of D steps in shared memory: per step one segment
//   of each of u0, u1, u2 and skip, filled with 4-byte cp.async copies (lane
//   l copies word l of the segment). The warp issues the copies of the
//   chunk of 4 steps D - 4 steps ahead as one cp.async group, waits
//   (cp.async.wait_group) for the chunk at hand, reads its 4 steps into
//   registers and runs them as one block of code with no wait in it, so the
//   shared reads and address arithmetic of a chunk are not queued behind
//   the previous step's carry chain.
// - In bfloat16 a lane's word holds two rows, so the warp syncs after the
//   wait (for the other lanes' copies) and after reading the chunk (before
//   its slots are refilled); in float32 each lane touches only its own row.
// - The wrapper (ops/kernels/sru.py: launch_plan) picks the kernel and D
//   per launch from the blocks each SM would hold. At most one (B = 1, the
//   T pass at B = 4): D = 32, the deepest ring, since the carry chain sets
//   the time there and each step waits less. Up to what the card holds at
//   once (B = 4 and 16): D = 8, which keeps every block's ring resident.
//   More than one wave of blocks (B = 128): the narrow kernel below, whose
//   lighter blocks (fewer registers, no shared memory) let an SM hold more
//   warps; they hide its load latency better than a ring does (measured on
//   an H100).
// - The narrow kernel, the first design (scalar loads straight from global
//   memory, 4 steps unrolled) with a cursor per operand walked along t,
//   also takes what a 4-byte copy cannot: bfloat16 with odd rows (rows =
//   125 at B = 1) or an operand that does not start 4-byte aligned.
//   Float32 segments are always aligned.
// What holds it back where the card is not full (B <= 4): the carry chain
// itself, two exact sigmoids (an expf and an IEEE division each) per step,
// 57 or 118 steps in order.
//
// The file is self-contained (the build hashes only this source), so the
// cp.async helpers and the step are copies of sru_train.cu's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Where a chain's operands lie: the element offsets of (t0, channel, row)
// and the signed steps from one visited t to the next.
struct Walk {
  int64_t plane, u_step, s_step;  // one chunk at one t; u's and skip's stride along t
  int64_t t0, du, ds, dp;         // first visited t; signed steps of u, skip, out
};

template <bool kSkipFromU>
__device__ __forceinline__ Walk walk_of(int L, int rows, int O, bool reverse) {
  Walk w;
  w.plane = (int64_t)O * rows;
  w.u_step = (kSkipFromU ? 4 : 3) * w.plane;
  w.s_step = kSkipFromU ? w.u_step : w.plane;
  w.t0 = reverse ? L - 1 : 0;
  const int64_t sign = reverse ? -1 : 1;
  w.du = sign * w.u_step;
  w.ds = sign * w.s_step;
  w.dp = sign * w.plane;
  return w;
}

// Copies of one operand's warp segment at one step into a ring slot: lane l
// copies word l (float32: row l; bfloat16: rows 2l and 2l + 1).
template <typename T>
__device__ __forceinline__ void copy_segment(T* slot, const T* src, int lane, int words) {
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  if (lane < words) cp_async4(slot + lane * kPerWord, src + lane * kPerWord);
}

template <typename T>
__device__ __forceinline__ void sync_lanes() {
  if constexpr (sizeof(T) == 2) __syncwarp();
}

// The ring kernel. grid = (ceil(rows / kThreads), O): blockIdx.y is the
// channel d*H + h; dynamic shared memory kWarps * D * 4 * 32 *
// sizeof(T).
template <typename T, bool kSkipFromU, int D>
__global__ void __launch_bounds__(kThreads)
sru_stack_layer_ring_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                            const float* __restrict__ v, const float* __restrict__ b,
                            T* __restrict__ out, int L, int rows, int H, int O) {
  constexpr int kOps = 4, kChunks = D / kChunk, kSlot = kOps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kThreads + warp * 32;
  if (row0 >= rows) return;  // the whole warp
  const int nrow = min(32, rows - row0);
  const int words = nrow * static_cast<int>(sizeof(T)) / 4;  // rows even in bfloat16
  const bool active = lane < nrow;
  const int ch = blockIdx.y;
  const bool reverse = ch >= H;  // only direction 1 has ch >= H
  const Gates g{v[ch], v[O + ch], b[ch], b[O + ch]};
  const Walk w = walk_of<kSkipFromU>(L, rows, O, reverse);
  const int64_t at = (int64_t)ch * rows + row0;  // the warp's first row
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * (D * kSlot);

  // copy cursors at the warp's segments of the next step to copy
  const T* l0 = u + at + w.t0 * w.u_step;
  const T* l1 = l0 + w.plane;
  const T* l2 = l1 + w.plane;
  const T* ls = kSkipFromU ? l2 + w.plane : skip + at + w.t0 * w.s_step;
  int issued = 0;  // steps whose copies are issued
  auto issue_chunk = [&]() {
    T* dst = ring + ((issued / kChunk) % kChunks) * (kChunk * kSlot);
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      if (issued + kk < L) {
        copy_segment(dst + kk * kSlot, l0, lane, words);
        copy_segment(dst + kk * kSlot + 32, l1, lane, words);
        copy_segment(dst + kk * kSlot + 64, l2, lane, words);
        copy_segment(dst + kk * kSlot + 96, ls, lane, words);
        l0 += w.du; l1 += w.du; l2 += w.du; ls += w.ds;
      }
    }
    issued += kChunk;
    cp_async_commit();
  };
  for (int q = 0; q < kChunks - 1; ++q) issue_chunk();

  T* po = out + at + lane + w.t0 * w.plane;
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
        po += w.dp;
      }
    }
  }
  cp_async_wait<0>();
}

// The narrow kernel, for launches of several waves and for segments a
// 4-byte copy cannot take: scalar loads from global memory, 4 steps
// unrolled. grid = (ceil(rows / kThreads), O).
template <typename T, bool kSkipFromU>
__global__ void __launch_bounds__(kThreads)
sru_stack_layer_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                       const float* __restrict__ v, const float* __restrict__ b,
                       T* __restrict__ out, int L, int rows, int H, int O) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int ch = blockIdx.y;
  const Gates g{v[ch], v[O + ch], b[ch], b[O + ch]};
  const Walk w = walk_of<kSkipFromU>(L, rows, O, ch >= H);
  const int64_t at = (int64_t)ch * rows + row;
  // one cursor per operand: at B = 128 in bfloat16 with k == 3 this ran
  // faster than u1's and u2's cursors derived from u0's (measured on an H100)
  const T* p0 = u + at + w.t0 * w.u_step;
  const T* p1 = p0 + w.plane;
  const T* p2 = p1 + w.plane;
  const T* ps = kSkipFromU ? p2 + w.plane : skip + at + w.t0 * w.s_step;
  T* po = out + at + w.t0 * w.plane;
  float c = 0.0f;
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    store(po, forward_step(g, c, ld(p0), ld(p1), ld(p2), ld(ps)));
    p0 += w.du; p1 += w.du; p2 += w.du; ps += w.ds; po += w.dp;
  }
}

// ---------------------------------------------------------------------------

struct Args {
  const void *u, *skip, *v, *b;
  void* out;
  int L, rows, H, O;
  cudaStream_t s;
};

template <typename T, bool kSkipFromU, int D>
int ring(const Args& a) {
  auto kernel = sru_stack_layer_ring_kernel<T, kSkipFromU, D>;
  const int smem = kWarps * D * 4 * 32 * sizeof(T);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.rows + kThreads - 1) / kThreads, a.O);
  kernel<<<grid, kThreads, smem, a.s>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.skip),
      static_cast<const float*>(a.v), static_cast<const float*>(a.b), static_cast<T*>(a.out),
      a.L, a.rows, a.H, a.O);
  return 0;
}

template <typename T, bool kSkipFromU>
int launch(const Args& a, int depth) {
  switch (depth) {
    case 0: {
      const dim3 grid((a.rows + kThreads - 1) / kThreads, a.O);
      sru_stack_layer_kernel<T, kSkipFromU><<<grid, kThreads, 0, a.s>>>(
          static_cast<const T*>(a.u), static_cast<const T*>(a.skip),
          static_cast<const float*>(a.v), static_cast<const float*>(a.b),
          static_cast<T*>(a.out), a.L, a.rows, a.H, a.O);
      return 0;
    }
    case 8: return ring<T, kSkipFromU, 8>(a);
    case 32: return ring<T, kSkipFromU, 32>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The ring needs the copied operands' segments 4-byte aligned: always in
// float32; in bfloat16 when rows is even and u (and skip) start 4-byte
// aligned. Stores are scalar and take any alignment.
bool ring_ok(int dtype, int rows, const void* u, const void* skip) {
  if (dtype == 0) return true;
  return rows % 2 == 0 && reinterpret_cast<uintptr_t>(u) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(skip) % 4 == 0;  // skip is null when k == 4
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. depth: the ring's D (8 or 32), or 0 for
// the narrow kernel; a ring on segments that are not 4-byte aligned is
// refused. Returns cudaGetLastError() after the launch (0 on success);
// the caller raises on anything else.
extern "C" int rtfs_sru_stack_layer(const void* u, const void* skip,
                                    const void* v, const void* b, void* out,
                                    int L, int rows, int H, int k, int ndir,
                                    int depth, int dtype, void* stream) {
  if ((k != 3 && k != 4) || (ndir != 1 && ndir != 2) || L <= 0 || rows <= 0 ||
      H <= 0 || (k == 3 && skip == nullptr) || (dtype != 0 && dtype != 1) ||
      (depth != 0 && !ring_ok(dtype, rows, u, k == 3 ? skip : nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.u = u; a.skip = k == 3 ? skip : nullptr; a.v = v; a.b = b; a.out = out;
  a.L = L; a.rows = rows; a.H = H; a.O = H * ndir;
  a.s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = k == 4 ? launch<float, true>(a, depth) : launch<float, false>(a, depth);
  } else {
    err = k == 4 ? launch<__nv_bfloat16, true>(a, depth)
                 : launch<__nv_bfloat16, false>(a, depth);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
