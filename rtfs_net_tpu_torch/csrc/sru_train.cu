// One SRU layer's recurrence, both directions, for training (sm_90a):
// a forward that also stores the cell state c, and the backward sweep.
//
// Replaces the TPU kernel rtfs_net_tpu/ops/pallas/sru_train.py:
// sru_direction_train (forward body `_fwd_kernel`, backward body
// `_bwd_kernel`). The TPU kernel takes one direction on (L, H, B) operands
// sliced out of the layer's projection and pads the batch to 128 lanes;
// here one launch covers both directions of a layer in the layout of the
// inference kernel (sru_stack_layer.cu), so nothing is sliced, padded or
// concatenated around it.
//
// Layout (rows = the folded batch, minor):
//   u     (L, k*O, rows)  chunk-major columns c*O + d*H + h, c in {0,1,2[,3]}
//   skip  (L, O, rows)    the highway input when k == 3; when k == 4 the
//                         4th u chunk is the highway and skip is not read
//   v, b  (2*O,) float32  v[d*H+h] = v_f, v[O+d*H+h] = v_r; b likewise
//   h, c  (L, O, rows)    forward outputs, in u's dtype
//   dh    (L, O, rows)    the incoming gradient, in u's dtype
//   du    (L, k*O, rows)  in u's dtype; chunk 3 is dskip when k == 4
//   dskip (L, O, rows)    in u's dtype, when k == 3
//   part  (4, O, rows)    float32 per-thread sums of da*c_prev, dm*c_prev,
//                         da and dm; the caller sums them over rows into
//                         dv = [dv_f, dv_r] and db = [db_f, db_r]
// Per direction (d == 1 walks t = L-1 .. 0), c_prev = c_{t-1} in the
// direction's order, 0 at its first step:
//   f = sigmoid(u1 + v_f*c_prev + b_f),  r = sigmoid(u2 + v_r*c_prev + b_r)
//   c = f*c_prev + (1-f)*u0,             h = r*c + (1-r)*skip
// The backward walks each direction's steps in reverse, carrying dc:
//   dr = dh*(c - skip), dm = dr*r*(1-r), dct = dh*r + dc,
//   df = dct*(c_prev - u0), da = df*f*(1-f)
//   du0 = dct*(1-f), du1 = da, du2 = dm, dskip = dh*(1-r)
//   dc <- dct*f + da*v_f + dm*v_r
//
// Precision: the carry and all arithmetic are float32. c is stored in u's
// dtype, as the TPU kernel stores it, so in bfloat16 the backward
// recomputes the gates from the rounded c (as the TPU kernel does); the
// plain version in ops/kernels/sru_train.py does the same.
//
// Gate gradients are reduced deterministically: each thread keeps float32
// sums over its L steps and writes them once; there are no atomics.
//
// Bound on an H100: bytes. The forward reads u (and skip) once and writes
// h and c, ((k*O [+O]) + 2*O) * L * rows * itemsize bytes; the backward
// reads u, c, dh (and skip) and writes du (and dskip),
// ((k*O + 2*O [+O]) + (k*O [+O])) * L * rows * itemsize bytes plus the
// float32 partials, against ~22 (forward) and ~41 (backward) float32
// operations per (channel, row, step). At (118, 256) k=4 float32, the T
// pass of a B=4 step, the forward's bytes take 13.8 us at 3.35 TB/s.
//
// Why L is not split: f = sigmoid(u1 + v_f*c + b_f) puts the carry inside
// the sigmoid, so the step is not an associative operator and a split of L
// with a carry fix-up computes another function. Each (direction, h, row)
// chain runs its L steps in order on one thread, and the only lever is how
// many bytes each chain keeps in flight.
//
// Design: one thread owns one (direction, h, row) and walks L with the
// carry in a register; neighbouring threads take neighbouring rows, so each
// warp's access to an operand at one step is one 32-row segment. The loads
// of a step do not depend on the carry, so a software pipeline keeps the
// operands of the next D - 4 steps in flight while the chain runs: u0, u1,
// u2 and skip in the forward; u0, u1, u2, skip, dh and c in the backward.
// - The ring is in shared memory, one per warp: D slots of one segment per
//   operand, filled with 4-byte cp.async copies (each lane copies one word
//   of the warp's segment). It advances by chunks of 4 steps: the warp
//   issues the copies of the chunk D - 4 steps ahead as one cp.async group,
//   waits (cp.async.wait_group) for the group of the chunk at hand, reads
//   its 4 steps' operands into registers, and then runs the 4 steps as one
//   block of code with no wait in it.
// - Why chunks: a warp issues in order, and at the B=4 shapes a launch puts
//   one warp on each scheduler, so nothing hides a stall. With a wait before
//   every step, each step's shared reads and address arithmetic queued
//   behind the previous step's carry chain; a block of 4 steps lets the
//   compiler hoist them. A ring of registers instead of shared memory did not
//   pipeline at all: a load's result is tracked by one of a warp's few
//   scoreboards, which the compiler shares among the ring's loads, so each
//   step waited for the newest loads (both measured on an H100).
// - In bfloat16 a lane's word holds two rows, so the warp syncs (__syncwarp)
//   after the wait, for the copies of the other lanes, and after reading the
//   chunk, before its slots are refilled. In float32 each lane copies and
//   reads only its own row and no sync is needed.
// - D is chosen per launch by the wrapper (ops/kernels/sru_train.py:
//   ring_depth) from the blocks each SM holds: deep (32 in the forward, 16 in
//   the backward) where a launch puts one or two blocks on an SM, as at the
//   B=4 shapes, 8 or 16 where the card is full (B=16), so that every block of
//   the launch fits on the card at once: a block's time is its whole chain,
//   and a second wave of blocks would double the launch.
// - Misaligned starts: a cp.async copies 4, 8 or 16 aligned bytes, never one
//   2-byte bfloat16. A warp's segment starts at element (t, channel, row0)
//   with row0 a multiple of 32; in bfloat16 it is 4-byte aligned for every t
//   and channel exactly when rows is even and every copied operand starts
//   4-byte aligned. Otherwise (rows = 125 at B=1, a slice at an odd offset)
//   the wrapper takes the narrow kernels: the same thread mapping with scalar
//   loads straight from global memory, 4 steps unrolled (the earlier design).
//   Float32 rows are always 4-byte aligned.
// Stores stay fire-and-forget. The backward reads c at t and at the step
// before; the value at t is the previous step's c_prev, kept in a register,
// so c is read once.
// What holds it back: at the B=4 shapes the carry chain itself (two exact
// sigmoids, an expf and an IEEE division each, per step, about 118 steps in
// order on one warp per scheduler); at B=16 in bfloat16 the instructions of
// a step, which halve no more than the bytes do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;  // steps per wait of the ring, run as one block of code
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

__device__ __forceinline__ Gates gates_of(const float* v, const float* b, int ch, int O) {
  return {v[ch], v[O + ch], b[ch], b[O + ch]};
}

// One forward step: updates the carry c, returns h.
__device__ __forceinline__ float forward_step(const Gates& g, float& c, float x0, float x1,
                                              float x2, float xs) {
  const float f = sigmoid(x1 + g.vf * c + g.bf);
  const float r = sigmoid(x2 + g.vr * c + g.br);
  c = f * c + (1.0f - f) * x0;
  return r * c + (1.0f - r) * xs;
}

// The backward's carries: dc and the four gate-gradient sums.
struct BackCarry {
  float dc = 0.0f, dvf = 0.0f, dvr = 0.0f, dbf = 0.0f, dbr = 0.0f;
};

// One backward step at t, with c_t = c[t] and c_prev = c at the step before
// t in the direction's order: writes du0, du1, du2, dskip.
__device__ __forceinline__ void backward_step(const Gates& g, BackCarry& k, float c_t,
                                              float c_prev, float x0, float x1, float x2,
                                              float xs, float dh, float out[4]) {
  const float f = sigmoid(x1 + g.vf * c_prev + g.bf);
  const float r = sigmoid(x2 + g.vr * c_prev + g.br);
  const float dm = dh * (c_t - xs) * r * (1.0f - r);
  const float dct = dh * r + k.dc;
  const float da = dct * (c_prev - x0) * f * (1.0f - f);
  out[0] = dct * (1.0f - f);
  out[1] = da;
  out[2] = dm;
  out[3] = dh * (1.0f - r);
  k.dvf += da * c_prev;
  k.dvr += dm * c_prev;
  k.dbf += da;
  k.dbr += dm;
  k.dc = dct * f + da * g.vf + dm * g.vr;
}

// Where a chain's operands lie: the element offsets of (t0, channel, row)
// and the signed steps from one visited t to the next.
struct Walk {
  int64_t plane, u_step, s_step;  // one chunk at one t; u's and skip's stride along t
  int64_t t0, du, ds, dp;         // first visited t; signed steps of u, skip, planes
};

template <bool kSkipFromU>
__device__ __forceinline__ Walk walk_of(int L, int rows, int O, bool forward_order) {
  Walk w;
  w.plane = (int64_t)O * rows;
  w.u_step = (kSkipFromU ? 4 : 3) * w.plane;
  w.s_step = kSkipFromU ? w.u_step : w.plane;
  w.t0 = forward_order ? 0 : L - 1;
  const int64_t sign = forward_order ? 1 : -1;
  w.du = sign * w.u_step;
  w.ds = sign * w.s_step;
  w.dp = sign * w.plane;
  return w;
}

// ---------------------------------------------------------------------------
// The ring kernels. grid = (ceil(rows / kThreads), O): blockIdx.y is the
// channel d*H + h; dynamic shared memory kWarps * D * ops * 32 * sizeof(T).

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

template <typename T, bool kSkipFromU, int D>
__global__ void __launch_bounds__(kThreads)
sru_train_forward_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                         const float* __restrict__ v, const float* __restrict__ b,
                         T* __restrict__ h, T* __restrict__ c_out, int L, int rows, int H,
                         int O) {
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
  const Gates g = gates_of(v, b, ch, O);
  const Walk w = walk_of<kSkipFromU>(L, rows, O, !reverse);
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

  T* ph = h + at + lane + w.t0 * w.plane;
  T* pc = c_out + at + lane + w.t0 * w.plane;
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
        if (active) {
          store(ph, hv);
          store(pc, c);
        }
        ph += w.dp; pc += w.dp;
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, bool kSkipFromU, int D>
__global__ void __launch_bounds__(kThreads)
sru_train_backward_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                          const T* __restrict__ c, const float* __restrict__ v,
                          const float* __restrict__ b, const T* __restrict__ dh,
                          T* __restrict__ du, T* __restrict__ dskip,
                          float* __restrict__ part, int L, int rows, int H, int O) {
  // u0, u1, u2, skip, dh at t; c at the next visited t
  constexpr int kOps = 6, kChunks = D / kChunk, kSlot = kOps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kThreads + warp * 32;
  if (row0 >= rows) return;
  const int nrow = min(32, rows - row0);
  const int words = nrow * static_cast<int>(sizeof(T)) / 4;
  const bool active = lane < nrow;
  const int ch = blockIdx.y;
  const bool reverse = ch >= H;
  const Gates g = gates_of(v, b, ch, O);
  // The sweep visits the direction's steps last to first: t = L-1 .. 0 for
  // direction 0, t = 0 .. L-1 for direction 1.
  const Walk w = walk_of<kSkipFromU>(L, rows, O, reverse);
  const int64_t at = (int64_t)ch * rows + row0;
  T* ring = reinterpret_cast<T*>(smem_raw) + warp * (D * kSlot);

  const T* l0 = u + at + w.t0 * w.u_step;
  const T* l1 = l0 + w.plane;
  const T* l2 = l1 + w.plane;
  const T* ls = kSkipFromU ? l2 + w.plane : skip + at + w.t0 * w.s_step;
  const T* lg = dh + at + w.t0 * w.plane;
  const T* lc = c + at + w.t0 * w.plane + w.dp;  // c one visited step ahead
  int issued = 0;
  auto issue_chunk = [&]() {
    T* dst = ring + ((issued / kChunk) % kChunks) * (kChunk * kSlot);
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const int step = issued + kk;
      if (step < L) {
        copy_segment(dst + kk * kSlot, l0, lane, words);
        copy_segment(dst + kk * kSlot + 32, l1, lane, words);
        copy_segment(dst + kk * kSlot + 64, l2, lane, words);
        copy_segment(dst + kk * kSlot + 96, ls, lane, words);
        copy_segment(dst + kk * kSlot + 128, lg, lane, words);
        if (step < L - 1) copy_segment(dst + kk * kSlot + 160, lc, lane, words);
        l0 += w.du; l1 += w.du; l2 += w.du; ls += w.ds; lg += w.dp; lc += w.dp;
      }
    }
    issued += kChunk;
    cp_async_commit();
  };
  for (int q = 0; q < kChunks - 1; ++q) issue_chunk();

  T* q0 = du + at + lane + w.t0 * w.u_step;
  T* q1 = q0 + w.plane;
  T* q2 = q1 + w.plane;
  T* qs = (kSkipFromU ? q2 + w.plane : dskip + at + lane + w.t0 * w.s_step);
  float c_t = active ? ld(c + at + lane + w.t0 * w.plane) : 0.0f;
  BackCarry k;
  for (int base = 0; base < L; base += kChunk) {
    issue_chunk();
    cp_async_wait<kChunks - 1>();
    sync_lanes<T>();
    const T* src = ring + ((base / kChunk) % kChunks) * (kChunk * kSlot) + lane;
    float x[kChunk][kOps];
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
#pragma unroll
      for (int o = 0; o < kOps; ++o) x[kk][o] = to_float(src[kk * kSlot + o * 32]);
    }
    sync_lanes<T>();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const int i = base + kk;
      if (i < L) {
        const float c_prev = i < L - 1 ? x[kk][5] : 0.0f;
        float out[4];
        backward_step(g, k, c_t, c_prev, x[kk][0], x[kk][1], x[kk][2], x[kk][3], x[kk][4],
                      out);
        if (active) {
          store(q0, out[0]);
          store(q1, out[1]);
          store(q2, out[2]);
          store(qs, out[3]);
        }
        q0 += w.du; q1 += w.du; q2 += w.du; qs += w.ds;
        c_t = c_prev;
      }
    }
  }
  cp_async_wait<0>();
  if (active) {
    const int64_t a = at + lane;
    part[a] = k.dvf;
    part[w.plane + a] = k.dvr;
    part[2 * w.plane + a] = k.dbf;
    part[3 * w.plane + a] = k.dbr;
  }
}

// ---------------------------------------------------------------------------
// The narrow kernels, for rows whose bfloat16 segments are not 4-byte
// aligned: scalar loads from global memory, 4 steps unrolled.

template <typename T, bool kSkipFromU>
__global__ void __launch_bounds__(kThreads)
sru_train_forward_narrow_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                                const float* __restrict__ v, const float* __restrict__ b,
                                T* __restrict__ h, T* __restrict__ c_out, int L, int rows,
                                int H, int O) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int ch = blockIdx.y;
  const Gates g = gates_of(v, b, ch, O);
  const Walk w = walk_of<kSkipFromU>(L, rows, O, ch < H);
  const int64_t at = (int64_t)ch * rows + row;
  const T* p0 = u + at + w.t0 * w.u_step;
  const T* ps = kSkipFromU ? p0 + 3 * w.plane : skip + at + w.t0 * w.s_step;
  T* ph = h + at + w.t0 * w.plane;
  T* pc = c_out + at + w.t0 * w.plane;
  float c = 0.0f;
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    const float hv = forward_step(g, c, ld(p0), ld(p0 + w.plane), ld(p0 + 2 * w.plane), ld(ps));
    store(ph, hv);
    store(pc, c);
    p0 += w.du; ps += w.ds; ph += w.dp; pc += w.dp;
  }
}

template <typename T, bool kSkipFromU>
__global__ void __launch_bounds__(kThreads)
sru_train_backward_narrow_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                                 const T* __restrict__ c, const float* __restrict__ v,
                                 const float* __restrict__ b, const T* __restrict__ dh,
                                 T* __restrict__ du, T* __restrict__ dskip,
                                 float* __restrict__ part, int L, int rows, int H, int O) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int ch = blockIdx.y;
  const Gates g = gates_of(v, b, ch, O);
  const Walk w = walk_of<kSkipFromU>(L, rows, O, ch >= H);
  const int64_t at = (int64_t)ch * rows + row;
  const T* p0 = u + at + w.t0 * w.u_step;
  const T* ps = kSkipFromU ? p0 + 3 * w.plane : skip + at + w.t0 * w.s_step;
  const T* pg = dh + at + w.t0 * w.plane;
  const T* pc = c + at + w.t0 * w.plane;
  T* q0 = du + at + w.t0 * w.u_step;
  T* qs = kSkipFromU ? q0 + 3 * w.plane : dskip + at + w.t0 * w.s_step;
  float c_t = ld(pc);
  BackCarry k;
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    pc += w.dp;
    const float c_prev = i < L - 1 ? ld(pc) : 0.0f;
    float out[4];
    backward_step(g, k, c_t, c_prev, ld(p0), ld(p0 + w.plane), ld(p0 + 2 * w.plane), ld(ps),
                  ld(pg), out);
    store(q0, out[0]);
    store(q0 + w.plane, out[1]);
    store(q0 + 2 * w.plane, out[2]);
    store(qs, out[3]);
    p0 += w.du; ps += w.ds; pg += w.dp; q0 += w.du; qs += w.ds;
    c_t = c_prev;
  }
  part[at] = k.dvf;
  part[w.plane + at] = k.dvr;
  part[2 * w.plane + at] = k.dbf;
  part[3 * w.plane + at] = k.dbr;
}

// ---------------------------------------------------------------------------

struct Args {
  const void *u, *skip, *c, *v, *b, *dh;
  void *h, *c_out, *du, *dskip, *part;
  int L, rows, H, O;
  cudaStream_t s;
};

bool bad_shape(int L, int rows, int H, int k, int ndir) {
  return (k != 3 && k != 4) || (ndir != 1 && ndir != 2) || L <= 0 || rows <= 0 || H <= 0;
}

// Lets a kernel take more than 48 KB of dynamic shared memory.
template <typename Kernel>
int opt_in(Kernel kernel, int smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, bool kSkipFromU, int D>
int forward_ring(const Args& a) {
  auto kernel = sru_train_forward_kernel<T, kSkipFromU, D>;
  const int smem = kWarps * D * 4 * 32 * sizeof(T);
  if (const int err = opt_in(kernel, smem)) return err;
  const dim3 grid((a.rows + kThreads - 1) / kThreads, a.O);
  kernel<<<grid, kThreads, smem, a.s>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.skip),
      static_cast<const float*>(a.v), static_cast<const float*>(a.b), static_cast<T*>(a.h),
      static_cast<T*>(a.c_out), a.L, a.rows, a.H, a.O);
  return 0;
}

template <typename T, bool kSkipFromU, int D>
int backward_ring(const Args& a) {
  auto kernel = sru_train_backward_kernel<T, kSkipFromU, D>;
  const int smem = kWarps * D * 6 * 32 * sizeof(T);
  if (const int err = opt_in(kernel, smem)) return err;
  const dim3 grid((a.rows + kThreads - 1) / kThreads, a.O);
  kernel<<<grid, kThreads, smem, a.s>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.skip), static_cast<const T*>(a.c),
      static_cast<const float*>(a.v), static_cast<const float*>(a.b),
      static_cast<const T*>(a.dh), static_cast<T*>(a.du), static_cast<T*>(a.dskip),
      static_cast<float*>(a.part), a.L, a.rows, a.H, a.O);
  return 0;
}

template <typename T, bool kSkipFromU>
int forward(const Args& a, int depth) {
  const dim3 grid((a.rows + kThreads - 1) / kThreads, a.O);
  switch (depth) {
    case 0:
      sru_train_forward_narrow_kernel<T, kSkipFromU><<<grid, kThreads, 0, a.s>>>(
          static_cast<const T*>(a.u), static_cast<const T*>(a.skip),
          static_cast<const float*>(a.v), static_cast<const float*>(a.b),
          static_cast<T*>(a.h), static_cast<T*>(a.c_out), a.L, a.rows, a.H, a.O);
      return 0;
    case 8: return forward_ring<T, kSkipFromU, 8>(a);
    case 16: return forward_ring<T, kSkipFromU, 16>(a);
    case 32: return forward_ring<T, kSkipFromU, 32>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool kSkipFromU>
int backward(const Args& a, int depth) {
  const dim3 grid((a.rows + kThreads - 1) / kThreads, a.O);
  switch (depth) {
    case 0:
      sru_train_backward_narrow_kernel<T, kSkipFromU><<<grid, kThreads, 0, a.s>>>(
          static_cast<const T*>(a.u), static_cast<const T*>(a.skip),
          static_cast<const T*>(a.c), static_cast<const float*>(a.v),
          static_cast<const float*>(a.b), static_cast<const T*>(a.dh),
          static_cast<T*>(a.du), static_cast<T*>(a.dskip), static_cast<float*>(a.part), a.L,
          a.rows, a.H, a.O);
      return 0;
    case 8: return backward_ring<T, kSkipFromU, 8>(a);
    case 16: return backward_ring<T, kSkipFromU, 16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The ring needs the copied operands' segments 4-byte aligned: always in
// float32; in bfloat16 when rows is even and each such operand starts
// 4-byte aligned. Stores are scalar and take any alignment.
bool ring_ok(int dtype, int rows, std::initializer_list<const void*> ptrs) {
  if (dtype == 0) return true;
  if (rows % 2) return false;
  for (const void* p : ptrs) {
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 4) return false;
  }
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. depth: the ring's D (8, 16 or 32 in
// the forward; 8 or 16 in the backward), or 0 for the narrow kernel; a
// ring on segments that are not 4-byte aligned is refused. Each returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
extern "C" int rtfs_sru_train_forward(const void* u, const void* skip,
                                      const void* v, const void* b, void* h,
                                      void* c, int L, int rows, int H, int k,
                                      int ndir, int depth, int dtype,
                                      void* stream) {
  if (bad_shape(L, rows, H, k, ndir) || (k == 3 && skip == nullptr) ||
      (dtype != 0 && dtype != 1) ||
      (depth != 0 && !ring_ok(dtype, rows, {u, k == 3 ? skip : nullptr}))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.u = u; a.skip = k == 3 ? skip : nullptr; a.v = v; a.b = b; a.h = h; a.c_out = c;
  a.L = L; a.rows = rows; a.H = H; a.O = H * ndir;
  a.s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = k == 4 ? forward<float, true>(a, depth) : forward<float, false>(a, depth);
  } else {
    err = k == 4 ? forward<__nv_bfloat16, true>(a, depth)
                 : forward<__nv_bfloat16, false>(a, depth);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

extern "C" int rtfs_sru_train_backward(const void* u, const void* skip,
                                       const void* c, const void* v,
                                       const void* b, const void* dh, void* du,
                                       void* dskip, void* part, int L,
                                       int rows, int H, int k, int ndir,
                                       int depth, int dtype, void* stream) {
  if (bad_shape(L, rows, H, k, ndir) ||
      (k == 3 && (skip == nullptr || dskip == nullptr)) || (dtype != 0 && dtype != 1) ||
      (depth != 0 &&
       !ring_ok(dtype, rows, {u, k == 3 ? skip : nullptr, c, dh}))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.u = u; a.skip = k == 3 ? skip : nullptr; a.c = c; a.v = v; a.b = b; a.dh = dh;
  a.du = du; a.dskip = k == 3 ? dskip : nullptr; a.part = part;
  a.L = L; a.rows = rows; a.H = H; a.O = H * ndir;
  a.s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = k == 4 ? backward<float, true>(a, depth) : backward<float, false>(a, depth);
  } else {
    err = k == 4 ? backward<__nv_bfloat16, true>(a, depth)
                 : backward<__nv_bfloat16, false>(a, depth);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
