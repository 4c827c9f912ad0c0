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
// per output element. One thread owns one (row, h) carry in a register and
// walks t over L; neighbouring threads take neighbouring h, then the next
// row, so with H = 32 a warp reads one row's 128-byte (float32) or 64-byte
// (bfloat16) segment of each operand per step. The loads of step t do not
// depend on the carry, so the unrolled loop keeps several steps' loads in
// flight while the carry chain runs.
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

// Element strides of one operand along t and along rows.
struct Strides {
  int64_t t, row;
};

// grid = ceil(rows * H / kThreads): thread idx is (row, h) = (idx / H, idx % H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sru_direction_kernel(const T* __restrict__ u0, const T* __restrict__ u1,
                     const T* __restrict__ u2, const T* __restrict__ skip,
                     Strides s0, Strides s1, Strides s2, Strides ss,
                     const float* __restrict__ v_f, const float* __restrict__ v_r,
                     const float* __restrict__ b_f, const float* __restrict__ b_r,
                     T* __restrict__ out, int L, int rows, int H, int reverse) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (int64_t)rows * H) return;
  const int64_t row = idx / H;
  const int h = (int)(idx - row * H);
  const float vf = v_f[h], vr = v_r[h], bf = b_f[h], br = b_r[h];

  const T* p0 = u0 + row * s0.row + h;
  const T* p1 = u1 + row * s1.row + h;
  const T* p2 = u2 + row * s2.row + h;
  const T* ps = skip + row * ss.row + h;
  T* po = out + idx;
  const int64_t o_step = (int64_t)rows * H;

  float c = 0.0f;
#pragma unroll 4
  for (int i = 0; i < L; ++i) {
    const int64_t t = reverse ? L - 1 - i : i;
    const float x0 = load(p0 + t * s0.t);
    const float x1 = load(p1 + t * s1.t);
    const float x2 = load(p2 + t * s2.t);
    const float xs = load(ps + t * ss.t);
    const float f = sigmoid(x1 + vf * c + bf);
    const float r = sigmoid(x2 + vr * c + br);
    c = f * c + (1.0f - f) * x0;
    store(po + t * o_step, r * c + (1.0f - r) * xs);
  }
}

template <typename T>
void launch(const void* u0, const void* u1, const void* u2, const void* skip,
            const int64_t* st, const float* v_f, const float* v_r,
            const float* b_f, const float* b_r, void* out, int L, int rows,
            int H, int reverse, cudaStream_t s) {
  const int64_t n = (int64_t)rows * H;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  sru_direction_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(u0), static_cast<const T*>(u1),
      static_cast<const T*>(u2), static_cast<const T*>(skip),
      Strides{st[0], st[1]}, Strides{st[2], st[3]}, Strides{st[4], st[5]},
      Strides{st[6], st[7]}, v_f, v_r, b_f, b_r, static_cast<T*>(out), L, rows,
      H, reverse);
}

}  // namespace

// strides: 8 element strides on the host, (t, row) of u0, u1, u2, skip in
// that order. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int rtfs_sru_direction(const void* u0, const void* u1, const void* u2,
                                  const void* skip, const int64_t* strides,
                                  const void* v_f, const void* v_r,
                                  const void* b_f, const void* b_r, void* out,
                                  int L, int rows, int H, int reverse, int dtype,
                                  void* stream) {
  if (L <= 0 || rows <= 0 || H <= 0 || strides == nullptr ||
      ((int64_t)rows * H + kThreads - 1) / kThreads > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v_f);
  const float* vr = static_cast<const float*>(v_r);
  const float* bf = static_cast<const float*>(b_f);
  const float* br = static_cast<const float*>(b_r);
  if (dtype == 0) {
    launch<float>(u0, u1, u2, skip, strides, vf, vr, bf, br, out, L, rows, H,
                  reverse, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(u0, u1, u2, skip, strides, vf, vr, bf, br, out, L,
                          rows, H, reverse, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
