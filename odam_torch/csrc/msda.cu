// Multi-scale deformable attention (MSDA) for Hopper (sm_90a): Deformable
// DETR's sampling core (Zhu et al., ICLR 2021, arXiv:2010.04159), which
// upstream computes with its own CUDA kernel (ms_deform_attn_cuda.cu) and, as
// its plain version, with grid_sample per level and head
// (ms_deform_attn_core_pytorch).  It replaces no TPU kernel: the JAX package
// runs no deformable detector.  odam_torch/ops/msda.py holds the wrapper and
// the plain version.
//
//   out[b, q, h, c] = sum over levels l and points p of
//       A[b, q, h, l, p] * bilinear(value_l[b, :, :, h, c], loc[b, q, h, l, p])
//
// value [B, S, H, dh] (float32 or bfloat16, the levels' pixels one after
// another, level l from start[l] over h[l] x w[l] rows), loc [B, Lq, H, L,
// P, 2] float32 in [0, 1] (x, y), A [B, Lq, H, L, P] float32, out [B, Lq, H,
// dh] in value's type; all contiguous.  The sample sits at pixel (x w - 0.5,
// y h - 0.5), grid_sample's align_corners=False, and a corner outside the
// map reads 0 (zero padding).  The bilinear weights, the products and the
// sum run in float32; the output is rounded once.
//
// What bounds it.  Per sample the kernel reads four corners of dh channels
// and does 8 dh + 8 float32 operations: gathers, not products, so no tensor
// core applies.  The least bytes (value, locations, weights and output once
// each) are far fewer than the bytes gathered: at the encoder's shape
// (16 x 17,821 queries, 8 heads, 4 levels x 4 points, dh 32, bf16) a call
// needs ~0.73 GB and gathers ~9.3 GB, most of it from L2, since the 146 MB
// value is re-read by neighbouring queries.  Latency of the gathers, not
// bandwidth, is the first limit of this design.
//
// Design, right and simple first.  One warp per (b, q, h); lane c owns
// channels c and c + 32 (dh 32 or 64), so each corner is one coalesced read
// of the head's dh contiguous values (64 bytes in bf16 at dh 32).  Lane i
// (i < L x P <= 32) loads sample i's location and weight, and the warp
// broadcasts each with a shuffle.  The points of a level are unrolled (P is
// a template argument), so the loads of a level's 4 P corners are in flight
// together.  The sample's in-map test is the same for the whole warp, so no
// lane diverges, and it predicates the loads rather than branching.  A
// block is 8 warps; it uses no shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps (so (b, q, h) items) a block
constexpr int kMaxLevels = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int CPL, int P>
__global__ void __launch_bounds__(kWarps * 32) ms_deform_attn_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attw, T* __restrict__ out, Levels lv, int S, int Lq, int H,
    int L, long long n_items) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);  // (b, q, h)
  if (item >= n_items) return;
  const int h = (int)(item % H);
  const long long b = item / H / Lq;
  const int dh = 32 * CPL;
  const int LP = L * P;
  float lx = 0.f, ly = 0.f, aw = 0.f;          // lane i holds sample i
  if (lane < LP) {
    lx = loc[item * 2 * LP + 2 * lane];
    ly = loc[item * 2 * LP + 2 * lane + 1];
    aw = attw[item * LP + lane];
  }
  const long long row = (long long)H * dh;     // elements from one pixel to the next
  const T* vb = value + b * S * row + (long long)h * dh + lane;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l];
    const T* vl = vb + (long long)lv.start[l] * row;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float x = __shfl_sync(0xffffffffu, lx, i) * (float)Wl - 0.5f;
      const float y = __shfl_sync(0xffffffffu, ly, i) * (float)Hl - 0.5f;
      const float a = __shfl_sync(0xffffffffu, aw, i);
      // outside (-1, w) x (-1, h) (or NaN) every corner is outside the map;
      // the test is predication, not a branch, so the unrolled points' loads
      // stay in flight together
      const bool inside = x > -1.f && y > -1.f && x < (float)Wl && y < (float)Hl;
      const float x0f = floorf(inside ? x : 0.f), y0f = floorf(inside ? y : 0.f);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float fx = x - x0f, fy = y - y0f;
      const float gx = 1.f - fx, gy = 1.f - fy;
      const bool in_x0 = inside && x0 >= 0, in_x1 = inside && x0 + 1 < Wl;
      const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < Hl;
      const float w00 = gy * gx, w01 = gy * fx, w10 = fy * gx, w11 = fy * fx;
      const long long p00 = ((long long)y0 * Wl + x0) * row;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const T* v = vl + p00 + c * 32;
        float s = 0.f;
        if (in_y0 && in_x0) s += w00 * to_f32(v[0]);
        if (in_y0 && in_x1) s += w01 * to_f32(v[row]);
        if (in_y1 && in_x0) s += w10 * to_f32(v[(long long)Wl * row]);
        if (in_y1 && in_x1) s += w11 * to_f32(v[((long long)Wl + 1) * row]);
        acc[c] += a * s;
      }
    }
  }
  T* o = out + item * dh + lane;
#pragma unroll
  for (int c = 0; c < CPL; ++c) o[c * 32] = from_f32<T>(acc[c]);
}

template <typename T, int CPL>
cudaError_t launch_p(const void* value, const void* loc, const void* attw, void* out,
                     const Levels& lv, int B, int S, int Lq, int H, int L, int P,
                     cudaStream_t stream) {
  const long long n_items = (long long)B * Lq * H;
  const long long blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks), block(kWarps * 32);
  const T* v = static_cast<const T*>(value);
  const float* lc = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  T* o = static_cast<T*>(out);
  switch (P) {
    case 1:
      ms_deform_attn_kernel<T, CPL, 1><<<grid, block, 0, stream>>>(v, lc, a, o, lv, S, Lq, H,
                                                                   L, n_items);
      break;
    case 2:
      ms_deform_attn_kernel<T, CPL, 2><<<grid, block, 0, stream>>>(v, lc, a, o, lv, S, Lq, H,
                                                                   L, n_items);
      break;
    case 4:
      ms_deform_attn_kernel<T, CPL, 4><<<grid, block, 0, stream>>>(v, lc, a, o, lv, S, Lq, H,
                                                                   L, n_items);
      break;
    case 8:
      ms_deform_attn_kernel<T, CPL, 8><<<grid, block, 0, stream>>>(v, lc, a, o, lv, S, Lq, H,
                                                                   L, n_items);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; dh 32 or 64; P 1, 2, 4 or 8; L <= 8 and
// L x P <= 32.  level_h, level_w, level_start: host arrays of L ints.
// Returns the launch's cudaError (0 = success).
extern "C" int odam_ms_deform_attn(const void* value, const void* loc, const void* attw,
                                   void* out, int dtype, int B, int S, int Lq, int H, int dh,
                                   int L, int P, const int* level_h, const int* level_w,
                                   const int* level_start, void* stream) {
  if (L < 1 || L > kMaxLevels || L * P > 32 || (dh != 32 && dh != 64))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_h[l];
    lv.w[l] = level_w[l];
    lv.start[l] = level_start[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dh == 32 ? launch_p<float, 1>(value, loc, attw, out, lv, B, S, Lq, H, L, P, s)
                   : launch_p<float, 2>(value, loc, attw, out, lv, B, S, Lq, H, L, P, s);
  else
    err = dh == 32 ? launch_p<__nv_bfloat16, 1>(value, loc, attw, out, lv, B, S, Lq, H, L, P, s)
                   : launch_p<__nv_bfloat16, 2>(value, loc, attw, out, lv, B, S, Lq, H, L, P, s);
  return (int)err;
}
