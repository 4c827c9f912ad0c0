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
// float32 partials, against ~25 (forward) and ~45 (backward) float32
// operations per (channel, row, step). The design is the inference
// kernel's: one thread owns one (direction, h, row) and walks L with the
// carry in a register; neighbouring threads take neighbouring rows, so
// every load and store of a warp is one coalesced segment. The loads of
// a step do not depend on the carry, so the unrolled loop keeps several
// steps' loads in flight while the carry chain runs. The backward reads
// c at t and at the step before; the value at t is the previous
// iteration's c_prev, kept in a register, so c is read once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// grid = (ceil(rows / kThreads), O): blockIdx.y is the channel d*H + h.
template <typename T, bool kSkipFromU>
__global__ void __launch_bounds__(kThreads)
sru_train_forward_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                         const float* __restrict__ v,
                         const float* __restrict__ b, T* __restrict__ h,
                         T* __restrict__ c_out, int L, int rows, int H, int O) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int ch = blockIdx.y;
  const bool reverse = ch >= H;  // only direction 1 has ch >= H
  const float vf = v[ch], vr = v[O + ch];
  const float bf = b[ch], br = b[O + ch];

  const int64_t plane = (int64_t)O * rows;              // one chunk at one t
  const int64_t u_step = (kSkipFromU ? 4 : 3) * plane;  // u's stride along t
  const int64_t s_step = kSkipFromU ? u_step : plane;
  const int64_t at = (int64_t)ch * rows + row;
  const T* p0 = u + at;
  const T* p1 = p0 + plane;
  const T* p2 = p1 + plane;
  const T* ps = kSkipFromU ? p2 + plane : skip + at;
  T* ph = h + at;
  T* pc = c_out + at;

  float c = 0.0f;
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    const int64_t t = reverse ? L - 1 - i : i;
    const float x0 = load(p0 + t * u_step);
    const float x1 = load(p1 + t * u_step);
    const float x2 = load(p2 + t * u_step);
    const float xs = load(ps + t * s_step);
    const float f = sigmoid(x1 + vf * c + bf);
    const float r = sigmoid(x2 + vr * c + br);
    c = f * c + (1.0f - f) * x0;
    store(ph + t * plane, r * c + (1.0f - r) * xs);
    store(pc + t * plane, c);
  }
}

template <typename T, bool kSkipFromU>
__global__ void __launch_bounds__(kThreads)
sru_train_backward_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                          const T* __restrict__ c, const float* __restrict__ v,
                          const float* __restrict__ b,
                          const T* __restrict__ dh, T* __restrict__ du,
                          T* __restrict__ dskip, float* __restrict__ part,
                          int L, int rows, int H, int O) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int ch = blockIdx.y;
  const bool reverse = ch >= H;
  const float vf = v[ch], vr = v[O + ch];
  const float bf = b[ch], br = b[O + ch];

  const int64_t plane = (int64_t)O * rows;
  const int64_t u_step = (kSkipFromU ? 4 : 3) * plane;
  const int64_t s_step = kSkipFromU ? u_step : plane;
  const int64_t at = (int64_t)ch * rows + row;
  const T* p0 = u + at;
  const T* p1 = p0 + plane;
  const T* p2 = p1 + plane;
  const T* ps = kSkipFromU ? p2 + plane : skip + at;
  const T* pc = c + at;
  const T* pg = dh + at;
  T* q0 = du + at;
  T* q1 = q0 + plane;
  T* q2 = q1 + plane;
  T* qs = kSkipFromU ? q2 + plane : dskip + at;

  // The sweep visits the direction's steps last to first: t = L-1 .. 0 for
  // direction 0, t = 0 .. L-1 for direction 1. Its c_prev is c at the
  // next visited t.
  const int64_t back = reverse ? 1 : -1;  // from t to the step before it
  float c_t = load(pc + (reverse ? 0 : (int64_t)(L - 1)) * plane);
  float dc = 0.0f, s_dvf = 0.0f, s_dvr = 0.0f, s_dbf = 0.0f, s_dbr = 0.0f;
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    const int64_t t = reverse ? i : L - 1 - i;
    const float c_prev = i < L - 1 ? load(pc + (t + back) * plane) : 0.0f;
    const float x0 = load(p0 + t * u_step);
    const float x1 = load(p1 + t * u_step);
    const float x2 = load(p2 + t * u_step);
    const float xs = load(ps + t * s_step);
    const float g = load(pg + t * plane);
    const float f = sigmoid(x1 + vf * c_prev + bf);
    const float r = sigmoid(x2 + vr * c_prev + br);
    const float dm = g * (c_t - xs) * r * (1.0f - r);
    const float dct = g * r + dc;
    const float da = dct * (c_prev - x0) * f * (1.0f - f);
    store(q0 + t * u_step, dct * (1.0f - f));
    store(q1 + t * u_step, da);
    store(q2 + t * u_step, dm);
    store(qs + t * s_step, g * (1.0f - r));
    s_dvf += da * c_prev;
    s_dvr += dm * c_prev;
    s_dbf += da;
    s_dbr += dm;
    dc = dct * f + da * vf + dm * vr;
    c_t = c_prev;
  }
  part[at] = s_dvf;
  part[plane + at] = s_dvr;
  part[2 * plane + at] = s_dbf;
  part[3 * plane + at] = s_dbr;
}

bool bad_shape(int L, int rows, int H, int k, int ndir) {
  return (k != 3 && k != 4) || (ndir != 1 && ndir != 2) || L <= 0 ||
         rows <= 0 || H <= 0;
}

template <typename T>
void launch_forward(const void* u, const void* skip, const void* v,
                    const void* b, void* h, void* c, int L, int rows, int H,
                    int k, int O, cudaStream_t s) {
  const dim3 grid((rows + kThreads - 1) / kThreads, O);
  const T* uu = static_cast<const T*>(u);
  const float* vv = static_cast<const float*>(v);
  const float* bb = static_cast<const float*>(b);
  if (k == 4) {
    sru_train_forward_kernel<T, true><<<grid, kThreads, 0, s>>>(
        uu, nullptr, vv, bb, static_cast<T*>(h), static_cast<T*>(c), L, rows,
        H, O);
  } else {
    sru_train_forward_kernel<T, false><<<grid, kThreads, 0, s>>>(
        uu, static_cast<const T*>(skip), vv, bb, static_cast<T*>(h),
        static_cast<T*>(c), L, rows, H, O);
  }
}

template <typename T>
void launch_backward(const void* u, const void* skip, const void* c,
                     const void* v, const void* b, const void* dh, void* du,
                     void* dskip, void* part, int L, int rows, int H, int k,
                     int O, cudaStream_t s) {
  const dim3 grid((rows + kThreads - 1) / kThreads, O);
  const T* uu = static_cast<const T*>(u);
  const T* cc = static_cast<const T*>(c);
  const float* vv = static_cast<const float*>(v);
  const float* bb = static_cast<const float*>(b);
  const T* gg = static_cast<const T*>(dh);
  float* pp = static_cast<float*>(part);
  if (k == 4) {
    sru_train_backward_kernel<T, true><<<grid, kThreads, 0, s>>>(
        uu, nullptr, cc, vv, bb, gg, static_cast<T*>(du), nullptr, pp, L,
        rows, H, O);
  } else {
    sru_train_backward_kernel<T, false><<<grid, kThreads, 0, s>>>(
        uu, static_cast<const T*>(skip), cc, vv, bb, gg, static_cast<T*>(du),
        static_cast<T*>(dskip), pp, L, rows, H, O);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// the launch (0 on success); the caller raises on anything else.
extern "C" int rtfs_sru_train_forward(const void* u, const void* skip,
                                      const void* v, const void* b, void* h,
                                      void* c, int L, int rows, int H, int k,
                                      int ndir, int dtype, void* stream) {
  if (bad_shape(L, rows, H, k, ndir) || (k == 3 && skip == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int O = H * ndir;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_forward<float>(u, skip, v, b, h, c, L, rows, H, k, O, s);
  } else if (dtype == 1) {
    launch_forward<__nv_bfloat16>(u, skip, v, b, h, c, L, rows, H, k, O, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int rtfs_sru_train_backward(const void* u, const void* skip,
                                       const void* c, const void* v,
                                       const void* b, const void* dh, void* du,
                                       void* dskip, void* part, int L,
                                       int rows, int H, int k, int ndir,
                                       int dtype, void* stream) {
  if (bad_shape(L, rows, H, k, ndir) ||
      (k == 3 && (skip == nullptr || dskip == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int O = H * ndir;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_backward<float>(u, skip, c, v, b, dh, du, dskip, part, L, rows, H,
                           k, O, s);
  } else if (dtype == 1) {
    launch_backward<__nv_bfloat16>(u, skip, c, v, b, dh, du, dskip, part, L,
                                   rows, H, k, O, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
