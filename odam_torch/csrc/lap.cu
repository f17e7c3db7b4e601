// Exact linear assignment on the card (sm_90a): a batch of shortest-
// augmenting-path solves, one warp a problem.
//
//   odam_lap_solve  <- odam_tpu/ops/lap.py:_solve_square_leq (plain XLA
//                      while-loops in the JAX package, not a Pallas kernel)
//
// Input cost [S, R, C] float32 with R <= C, rows of C floats contiguous and
// problems `stride_s` floats apart; output col4row [S, R] int32, the column
// of each row.  It computes the JAX package's solver step for step, with
// the same float32 arithmetic and tie-breaks, so the assignments equal the
// host solver's (odam_torch/ops/lap.py:_solve_square_leq) bit for bit:
//
// - Dijkstra step, each lane on columns lane, lane + 32, ...: the reduced
//   cost r = ((min_val + c[i][j]) - u[i]) - v[j] in the host's order (the
//   __fadd_rn / __fsub_rn intrinsics keep nvcc from contracting or
//   reordering it), spc / path relaxed on unscanned columns only.
// - The next column is the least (spc, assigned, index) over the unscanned
//   columns: each lane keeps its own least, a 5-step shuffle reduction the
//   warp's.  That is the JAX rule (lap.py:60-67): the lowest value; among
//   the minimizers an unassigned column first, else the first index; and
//   when every value is inf (masked <= lowest holds for all) the same key
//   picks the first unassigned unscanned column.
// - Dual updates (u + min_val) - spc and v - (min_val - spc) (lap.py:89-92),
//   lanes over rows and columns; the augmentation walk on lane 0.
//
// State lives in dynamic shared memory: u[R], v[C], spc[C], path[C],
// row4col[C], col4row[R] and the scanned masks sc[C], sr[R], 9R + 17C
// bytes (6.6 KB at 256 x 256; the wrapper refuses a problem above the
// 227 KB a block may use).  The Dijkstra loop scans a new column each
// iteration, so it ends within C iterations; past that, or on an
// augmentation walk longer than R steps, the kernel traps and the fault
// shows at the next synchronize.  Nothing is read back to the host.
//
// What bounds it: each row's Dijkstra sweep is a chain of dependent warp
// reductions (about 30 ns each), so a problem takes R x (sweeps per row)
// of them; the bytes (S x R x C x 4 in, S x R x 4 out) would take well
// under a microsecond at 3.35 TB/s.  It is latency-bound, and the S
// problems of a batch run side by side, one block each, on the 132 SMs.
// No tensor-core work applies.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// (val, assigned, idx) lexicographically below (bv, ba, bi)?
__device__ __forceinline__ bool key_less(float val, int asg, int idx, float bv, int ba, int bi) {
  if (val < bv) return true;
  if (bv < val) return false;
  if (asg != ba) return asg < ba;
  return idx < bi;
}

__global__ void __launch_bounds__(kWarp)
lap_kernel(const float* __restrict__ cost, int* __restrict__ out, int R, int C, long long stride_s) {
  extern __shared__ float smem[];
  float* u = smem;                                   // [R]
  float* v = u + R;                                  // [C]
  float* spc = v + C;                                // [C] shortest path cost per column
  int* path = reinterpret_cast<int*>(spc + C);       // [C] predecessor row per column
  int* row4col = path + C;                           // [C]
  int* col4row = row4col + C;                        // [R]
  unsigned char* sc = reinterpret_cast<unsigned char*>(col4row + R);   // [C] scanned columns
  unsigned char* sr = sc + C;                        // [R] scanned rows

  const int lane = threadIdx.x;
  const float* c = cost + static_cast<long long>(blockIdx.x) * stride_s;

  for (int j = lane; j < C; j += kWarp) { v[j] = 0.f; row4col[j] = -1; }
  for (int r = lane; r < R; r += kWarp) { u[r] = 0.f; col4row[r] = -1; }
  __syncwarp();

  for (int cur_row = 0; cur_row < R; ++cur_row) {
    for (int j = lane; j < C; j += kWarp) { spc[j] = CUDART_INF_F; path[j] = -1; sc[j] = 0; }
    for (int r = lane; r < R; r += kWarp) sr[r] = 0;
    __syncwarp();

    int i = cur_row, sink = -1;
    float min_val = 0.f;
    for (int iter = 0; sink < 0; ++iter) {
      if (iter >= C) __trap();                 // cannot happen for R <= C: no hang
      if (lane == 0) sr[i] = 1;
      const float ui = u[i];
      const float* ci = c + static_cast<long long>(i) * C;
      float bv = CUDART_INF_F;
      int ba = 2, bi = 0x7fffffff;             // no unscanned column in this lane
      for (int j = lane; j < C; j += kWarp) {
        if (sc[j]) continue;
        const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, __ldg(ci + j)), ui), v[j]);
        float s = spc[j];
        if (r < s) { s = r; spc[j] = r; path[j] = i; }
        const int a = row4col[j] >= 0 ? 1 : 0;
        if (key_less(s, a, j, bv, ba, bi)) { bv = s; ba = a; bi = j; }
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oa = __shfl_xor_sync(kFull, ba, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (key_less(ov, oa, oi, bv, ba, bi)) { bv = ov; ba = oa; bi = oi; }
      }
      if (bi >= C) __trap();                   // no unscanned column left
      if (lane == (bi & (kWarp - 1))) sc[bi] = 1;   // the column's own lane marks it
      const int nxt = row4col[bi];
      if (nxt < 0) sink = bi; else i = nxt;
      min_val = bv;
      __syncwarp();
    }

    // dual updates (JV potentials)
    for (int r = lane; r < R; r += kWarp) {
      if (r == cur_row) {
        u[r] = __fadd_rn(u[r], min_val);
      } else if (sr[r]) {
        const int j = min(max(col4row[r], 0), C - 1);
        u[r] = __fsub_rn(__fadd_rn(u[r], min_val), spc[j]);
      }
    }
    for (int j = lane; j < C; j += kWarp)
      if (sc[j]) v[j] = __fsub_rn(v[j], __fsub_rn(min_val, spc[j]));
    __syncwarp();

    // augment along the alternating path back to cur_row
    if (lane == 0) {
      int j = sink;
      for (int step = 0;; ++step) {
        if (step > R) __trap();
        const int r = path[j];
        row4col[j] = r;
        const int prev = col4row[r];
        col4row[r] = j;
        j = prev;
        if (r == cur_row) break;
      }
    }
    __syncwarp();
  }
  int* o = out + static_cast<long long>(blockIdx.x) * R;
  for (int r = lane; r < R; r += kWarp) o[r] = col4row[r];
}

// Shared bytes of one problem's state (the wrapper's lap.smem_bytes).
size_t smem_bytes(int R, int C) {
  return static_cast<size_t>(R) * 9 + static_cast<size_t>(C) * 17;
}

}  // namespace

extern "C" {

// Launches S blocks of one warp on `stream`; returns the cudaError_t of the
// attribute call (made once a new largest size) or of the launch (0 on
// success).  It allocates nothing and does not synchronize.
int odam_lap_solve(const float* cost, int* col4row, int S, int R, int C, long long stride_s,
                   void* stream) {
  static size_t smem_allowed = 48 * 1024;   // above it only after the attribute call
  const size_t smem = (smem_bytes(R, C) + 15) / 16 * 16;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(lap_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  lap_kernel<<<S, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(cost, col4row, R, C, stride_s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
