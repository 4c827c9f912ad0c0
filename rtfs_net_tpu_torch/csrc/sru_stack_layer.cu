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
// of arithmetic. The design streams at the memory rate as far as a
// sequential recurrence allows: one thread owns one (direction, h, row)
// carry in a register and walks t over L; neighbouring threads take
// neighbouring rows, so every load and store of a warp is one coalesced
// 128-byte (float32) or 64-byte (bfloat16) segment. The loads of step t do
// not depend on the carry, so the unrolled loop keeps several steps' loads
// in flight while the carry chain runs. Nothing is staged in shared memory:
// no element is read twice.
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
sru_stack_layer_kernel(const T* __restrict__ u, const T* __restrict__ skip,
                       const float* __restrict__ v, const float* __restrict__ b,
                       T* __restrict__ out, int L, int rows, int H, int O) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int ch = blockIdx.y;
  const bool reverse = ch >= H;  // only direction 1 has ch >= H
  const float vf = v[ch], vr = v[O + ch];
  const float bf = b[ch], br = b[O + ch];

  const int64_t plane = (int64_t)O * rows;              // one chunk at one t
  const int64_t u_step = (kSkipFromU ? 4 : 3) * plane;  // u's stride along t
  const int64_t s_step = kSkipFromU ? u_step : plane;
  const T* p0 = u + (int64_t)ch * rows + row;
  const T* p1 = p0 + plane;
  const T* p2 = p1 + plane;
  const T* ps = kSkipFromU ? p2 + plane : skip + (int64_t)ch * rows + row;
  T* po = out + (int64_t)ch * rows + row;

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
    store(po + t * plane, r * c + (1.0f - r) * xs);
  }
}

template <typename T>
void launch(const void* u, const void* skip, const void* v, const void* b,
            void* out, int L, int rows, int H, int k, int O, cudaStream_t s) {
  const dim3 grid((rows + kThreads - 1) / kThreads, O);
  const T* uu = static_cast<const T*>(u);
  const float* vv = static_cast<const float*>(v);
  const float* bb = static_cast<const float*>(b);
  T* oo = static_cast<T*>(out);
  if (k == 4) {
    sru_stack_layer_kernel<T, true><<<grid, kThreads, 0, s>>>(
        uu, nullptr, vv, bb, oo, L, rows, H, O);
  } else {
    sru_stack_layer_kernel<T, false><<<grid, kThreads, 0, s>>>(
        uu, static_cast<const T*>(skip), vv, bb, oo, L, rows, H, O);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int rtfs_sru_stack_layer(const void* u, const void* skip,
                                    const void* v, const void* b, void* out,
                                    int L, int rows, int H, int k, int ndir,
                                    int dtype, void* stream) {
  if ((k != 3 && k != 4) || (ndir != 1 && ndir != 2) || L <= 0 || rows <= 0 ||
      H <= 0 || (k == 3 && skip == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int O = H * ndir;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(u, skip, v, b, out, L, rows, H, k, O, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(u, skip, v, b, out, L, rows, H, k, O, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
