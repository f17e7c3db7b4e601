// Exact linear assignment on the card (sm_90a): a batch of shortest-
// augmenting-path solves, one warp a problem, one block a problem.
//
//   odam_lap_solve_regs, odam_lap_solve
//                  <- odam_tpu/ops/lap.py:_solve_square_leq (plain XLA
//                     while-loops in the JAX package, not a Pallas kernel)
//
// Input cost [S, R, C] float32 with R <= C, rows of C floats contiguous and
// problems `stride_s` floats apart; output col4row [S, R] int32, the column
// of each row.  Both kernels compute the JAX package's solver step for step,
// with its float32 arithmetic and tie-breaks, so the assignments equal the
// host solver's (odam_torch/ops/lap.py:_solve_square_leq) bit for bit:
//
// - Dijkstra step: the reduced cost r = ((min_val + c[i][j]) - u[i]) - v[j]
//   in the host's order (the __fadd_rn / __fsub_rn intrinsics keep nvcc from
//   contracting or reordering it), spc / path relaxed on unscanned columns;
// - the next column is the least (spc, assigned, index) over the unscanned
//   columns: JAX's rule (lap.py:60-67), the lowest value, among the
//   minimizers an unassigned column first, else the first index; when every
//   value is inf (masked <= lowest holds for all) the same order picks the
//   first unassigned unscanned column;
// - dual updates u = (u + min_val) - spc[col4row[u's row]] on the scanned
//   rows, v = v - (min_val - spc) on the scanned columns (lap.py:89-92), then
//   the augmentation walk back to the current row.
// Costs are finite: NaN never compares, and an open column that no finite
// path reaches (every candidate at inf) has no predecessor, in JAX's solver
// as here, so neither is in the contract.
//
// What bounds it: not its bytes (S x R x C x 4 in, S x R x 4 out take well
// under a microsecond at 3.35 TB/s) but the chain of dependent sweeps: each
// Dijkstra step needs the row that the previous step picked, so a problem
// costs (its sweeps) x (one sweep's latency) + (its rows) x (one row's
// work).  The S problems of a batch run side by side, one block each, on
// the 132 SMs; no tensor-core work applies.
//
// lap_regs_kernel<K> (C <= 32 K, K = 1, 2, 4, 8: every C up to 256).  On an
// NVIDIA H100 80GB HBM3 at 700 W (clock64 stamps at 1980 MHz, python -m
// odam_torch.scripts.profile_lap) the first kernel (lap_kernel below) took
// about 2,740 cycles a sweep at the decode's [30, 64], all in: 1,040 in its
// column loop, whose global loads of row i run one after another behind
// a branch and a shared-memory relaxation, 530 in its 5-level, 3-shuffle
// reduction, 220 to broadcast the next row through shared memory, and 750
// a row of dual update and augmentation on lane 0, 350 a row of resetting
// its shared state.  Each design step answers one of those:
// 1. the cost is staged into shared memory once (cp.async, 16 bytes a lane
//    where aligned) as far as it fits: `staged_rows` rows of C floats,
//    227 KB at most; a row past them is read from global memory with all
//    of a lane's K loads in flight before the first is used;
// 2. lane l owns columns l + 32k (k < K): their v, spc, path, row4col and
//    the potential u of the row each holds (ucol) live in registers, and
//    the scanned flags in one mask, so a sweep touches no shared memory
//    but the staged cost; the relaxation is branch-free over k, so the K
//    chains interleave; the next row and its u come from the owning lane
//    in two independent __shfl_sync;
// 3. the pick is two __reduce_min_sync: each lane's least spc as an order-
//    preserving uint32 (the sign bit flipped for a non-negative float, all
//    bits for a negative one, -0 taken as +0, +inf below the 0xffffffff of
//    a lane with nothing unscanned), then (assigned << 30 | index) from the
//    lanes that hold that value;
// 4. the row's work stays in registers: the dual update is per column
//    (a scanned row other than the current one is the row of a scanned
//    assigned column, so its spc[col4row[r]] is that column's spc; the
//    current row's u is 0 before its own step, as rows are taken in order),
//    and the augmentation walk runs on the whole warp with shuffles, each
//    lane also holding col4row of rows l + 32k.
// Measured the same way: 650 cycles a sweep at [30, 64] all in (200 in the
// columns, 150 in the pick, 28 for the next row, 190 a row of row work);
// without the stamps 0.0112 ms a decode against 0.0480, 311 ns a sweep
// against 1,332, and 457 ns against 2,489 at 256 x 256 (K = 8), where a
// sweep runs some 250 instructions (cuobjdump -sass) on one warp.
//
// lap_kernel (the first kernel, every size the shared memory takes, and the
// route for C > 256): state in dynamic shared memory, u[R], v[C], spc[C],
// path[C], row4col[C], col4row[R] and the scanned masks sc[C], sr[R],
// 9R + 17C bytes; lanes over columns, a 5-step xor-shuffle reduction of
// (value, assigned, index), the augmentation walk on lane 0.
//
// Both kernels trap rather than hang: a Dijkstra loop past C steps, a pick
// with no unscanned column or a walk longer than R steps cannot happen for
// R <= C and would show at the next synchronize.  Nothing is read back to
// the host; a launch allocates nothing and does not synchronize.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

#ifdef ODAM_LAP_CLOCK
// Dev build only (python -m odam_torch.scripts.profile_lap): clock64 stamps
// by part, summed over the sweeps and rows of problem 0 and written by its
// lane 0 to the buffer that odam_lap_clock_target names.
enum { kClkInit, kClkColumns, kClkPick, kClkNext, kClkRow, kClkTotal, kClkSweeps, kClkRows,
       kClkSlots };
__device__ long long* g_clock;
__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
#define CLK_DECL                                                               \
  long long clk_acc[kClkSlots] = {};                                           \
  const long long clk_t0 = clk();                                              \
  long long clk_t = clk_t0;
#define CLK(part) { const long long n_ = clk(); clk_acc[part] += n_ - clk_t; clk_t = n_; }
#define CLK_COUNT(part) (++clk_acc[part]);
#define CLK_STORE                                                              \
  if (blockIdx.x == 0 && threadIdx.x == 0 && g_clock) {                        \
    clk_acc[kClkTotal] = clk() - clk_t0;                                       \
    for (int s_ = 0; s_ < kClkSlots; ++s_) g_clock[s_] = clk_acc[s_];          \
  }
#else
#define CLK_DECL
#define CLK(part)
#define CLK_COUNT(part)
#define CLK_STORE
#endif

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;          // a lane with no unscanned column
constexpr unsigned kAssigned = 1u << 30;         // the pick's key: assigned << 30 | index
constexpr unsigned kIndex = kAssigned - 1;
constexpr size_t kSmemLimit = 232448;            // dynamic shared memory a block may use

// ------------------------------------------------------------ lap_regs_kernel

// A float's rank as a uint32: unsigned order = float order, -0 ranked as +0.
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned b = __float_as_uint(x);
  b = b == 0x80000000u ? 0u : b;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float order_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The least of a lane's K keys, as a tree (K is a power of two).
template <int K>
__device__ __forceinline__ unsigned tree_min(const unsigned (&a)[K]) {
  unsigned t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = a[k];
#pragma unroll
  for (int w = K / 2; w > 0; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) t[k] = min(t[k], t[k + w]);
  return t[0];
}

// a[kb] for a kb known only at run time, as a tree of selects on kb's bits,
// so the register array stays in registers.
template <int K, typename T>
__device__ __forceinline__ T slot(const T (&a)[K], int kb) {
  T t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = a[k];
#pragma unroll
  for (int w = 1; w < K; w *= 2)
#pragma unroll
    for (int k = 0; k < K; k += 2 * w) t[k] = (kb & w) ? t[k + w] : t[k];
  return t[0];
}

// The first `n` floats of `src` into shared `dst`, as asynchronous copies
// the whole warp starts before it waits for any.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int lane) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int q = lane;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (; 4 * q + 3 < n; q += kWarp)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(base + 16 * q),
                   "l"(src + 4 * q));
    q = n / 4 * 4 + lane;
  }
  for (; q < n; q += kWarp)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(base + 4 * q), "l"(src + q));
}

template <int K>
__global__ void __launch_bounds__(kWarp)
lap_regs_kernel(const float* __restrict__ cost, int* __restrict__ out, int R, int C,
                long long stride_s, int staged_rows) {
  extern __shared__ __align__(16) float cs[];       // [staged_rows, C] of the problem
  CLK_DECL
  const int lane = threadIdx.x;
  const float* c = cost + static_cast<long long>(blockIdx.x) * stride_s;
  stage(cs, c, staged_rows * C, lane);

  // column lane + 32k: potential, path cost and predecessor row, its row and
  // that row's potential; row lane + 32k: its column (R <= C <= 32 K)
  float v[K], spc[K], ucol[K];
  int path[K], r4c[K], c4r[K], col[K];
  unsigned pad = 0;                                 // bit k: column lane + 32k is past C
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.f;
    ucol[k] = 0.f;
    r4c[k] = -1;
    c4r[k] = -1;
    col[k] = min(lane + kWarp * k, C - 1);          // a past-C lane loads a real column
    if (lane + kWarp * k >= C) pad |= 1u << k;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();

  for (int cur_row = 0; cur_row < R; ++cur_row) {
    unsigned sc = pad;                              // scanned (or past C)
#pragma unroll
    for (int k = 0; k < K; ++k) { spc[k] = CUDART_INF_F; path[k] = -1; }
    CLK(kClkInit)

    int i = cur_row, sink = -1;
    float ui = 0.f, min_val = 0.f;                  // u[cur_row] is 0 until its own update
    for (int iter = 0;; ++iter) {
      if (iter >= C) __trap();                      // cannot happen for R <= C: no hang
      CLK_COUNT(kClkSweeps)
      float cv[K];
      if (i < staged_rows) {
        const float* ci = cs + i * C;
#pragma unroll
        for (int k = 0; k < K; ++k) cv[k] = ci[col[k]];
      } else {
        const float* ci = c + static_cast<long long>(i) * C;
#pragma unroll
        for (int k = 0; k < K; ++k) cv[k] = __ldg(ci + col[k]);
      }
      // branch-free over k, so the K chains interleave
      unsigned key[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool open = !(sc >> k & 1u);
        const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, cv[k]), ui), v[k]);
        const bool better = open && r < spc[k];
        spc[k] = better ? r : spc[k];
        path[k] = better ? i : path[k];
        key[k] = open ? order_key(spc[k]) : kNone;
      }
      const unsigned least = tree_min(key);
      CLK(kClkColumns)
      const unsigned low = __reduce_min_sync(kFull, least);
      if (low == kNone) __trap();                   // no unscanned column left
      unsigned cand[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned index = static_cast<unsigned>(lane + kWarp * k);
        const unsigned tag = (r4c[k] >= 0 ? kAssigned : 0u) | index;
        cand[k] = key[k] == low ? tag : kNone;
      }
      const unsigned pick = __reduce_min_sync(kFull, tree_min(cand));
      const int j = static_cast<int>(pick & kIndex), kb = j / kWarp, owner = j % kWarp;
      min_val = order_value(low);
      if (lane == owner) sc |= 1u << kb;
      CLK(kClkPick)
      if (!(pick & kAssigned)) { sink = j; break; }
      i = __shfl_sync(kFull, slot(r4c, kb), owner);
      ui = __shfl_sync(kFull, slot(ucol, kb), owner);
      CLK(kClkNext)
    }
    CLK(kClkNext)

    // dual updates (JV potentials), column by column
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool scanned = (sc & ~pad) >> k & 1u;
      const float nu = __fsub_rn(__fadd_rn(ucol[k], min_val), spc[k]);
      const float nv = __fsub_rn(v[k], __fsub_rn(min_val, spc[k]));
      ucol[k] = scanned && r4c[k] >= 0 ? nu : ucol[k];
      v[k] = scanned ? nv : v[k];
    }
    const float u_cur = __fadd_rn(0.f, min_val);

    // augment along the alternating path back to cur_row, the whole warp
    // stepping together: column j takes row r = path[j], with r's potential
    int j = sink;
    for (int step = 0;; ++step) {
      if (step > R) __trap();
      const int kb = j / kWarp, owner = j % kWarp;
      const int r = __shfl_sync(kFull, slot(path, kb), owner);
      if (r < 0) break;                                    // only a non-finite cost leaves
                                                           // a picked column unrelaxed
      const int rk = r / kWarp, rown = r % kWarp;
      const int prev = __shfl_sync(kFull, slot(c4r, rk), rown);   // -1 for cur_row
      float ur = u_cur;
      if (r != cur_row)                                    // r's u rides on its old column
        ur = __shfl_sync(kFull, slot(ucol, prev / kWarp), prev % kWarp);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool mine = lane == owner && k == kb;
        r4c[k] = mine ? r : r4c[k];
        ucol[k] = mine ? ur : ucol[k];
        c4r[k] = lane == rown && k == rk ? j : c4r[k];
      }
      j = prev;
      if (r == cur_row) break;
    }
    CLK(kClkRow)
    CLK_COUNT(kClkRows)
  }
  int* o = out + static_cast<long long>(blockIdx.x) * R;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + kWarp * k < R) o[lane + kWarp * k] = c4r[k];
  CLK_STORE
}

template <int K>
int launch_regs(const float* cost, int* col4row, int S, int R, int C, long long stride_s,
                int staged_rows, cudaStream_t stream) {
  static size_t smem_allowed = 48 * 1024;   // above it only after the attribute call
  const size_t smem = (static_cast<size_t>(staged_rows) * C * 4 + 15) / 16 * 16;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(lap_regs_kernel<K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  lap_regs_kernel<K><<<S, kWarp, smem, stream>>>(cost, col4row, R, C, stride_s, staged_rows);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- lap_kernel

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

  CLK_DECL
  const int lane = threadIdx.x;
  const float* c = cost + static_cast<long long>(blockIdx.x) * stride_s;

  for (int j = lane; j < C; j += kWarp) { v[j] = 0.f; row4col[j] = -1; }
  for (int r = lane; r < R; r += kWarp) { u[r] = 0.f; col4row[r] = -1; }
  __syncwarp();

  for (int cur_row = 0; cur_row < R; ++cur_row) {
    for (int j = lane; j < C; j += kWarp) { spc[j] = CUDART_INF_F; path[j] = -1; sc[j] = 0; }
    for (int r = lane; r < R; r += kWarp) sr[r] = 0;
    __syncwarp();
    CLK(kClkInit)

    int i = cur_row, sink = -1;
    float min_val = 0.f;
    for (int iter = 0; sink < 0; ++iter) {
      if (iter >= C) __trap();                 // cannot happen for R <= C: no hang
      if (lane == 0) sr[i] = 1;
      const float ui = u[i];
      CLK(kClkNext)
      CLK_COUNT(kClkSweeps)
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
      CLK(kClkColumns)
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oa = __shfl_xor_sync(kFull, ba, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (key_less(ov, oa, oi, bv, ba, bi)) { bv = ov; ba = oa; bi = oi; }
      }
      CLK(kClkPick)
      if (bi >= C) __trap();                   // no unscanned column left
      if (lane == (bi & (kWarp - 1))) sc[bi] = 1;   // the column's own lane marks it
      const int nxt = row4col[bi];
      if (nxt < 0) sink = bi; else i = nxt;
      min_val = bv;
      __syncwarp();
    }
    CLK(kClkNext)

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
    CLK(kClkRow)
    CLK_COUNT(kClkRows)
  }
  int* o = out + static_cast<long long>(blockIdx.x) * R;
  for (int r = lane; r < R; r += kWarp) o[r] = col4row[r];
  CLK_STORE
}

// Shared bytes of one problem's state (the wrapper's lap.smem_bytes).
size_t smem_bytes(int R, int C) {
  return static_cast<size_t>(R) * 9 + static_cast<size_t>(C) * 17;
}

}  // namespace

extern "C" {

// The registers route (lap.plan's "registers"): S blocks of one warp on
// `stream`, K = 1, 2, 4 or 8 columns a lane (C <= 32 K), the first
// `staged_rows` rows of each problem staged in shared memory.  Returns the
// cudaError_t of the attribute call (made once a new largest size) or of
// the launch, 0 on success; cudaErrorInvalidValue for a K or a size it
// does not take.
int odam_lap_solve_regs(const float* cost, int* col4row, int S, int R, int C, long long stride_s,
                        int K, int staged_rows, void* stream) {
  if (R > C || C > kWarp * K || staged_rows < 0 || staged_rows > R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_regs<1>(cost, col4row, S, R, C, stride_s, staged_rows, st);
    case 2: return launch_regs<2>(cost, col4row, S, R, C, stride_s, staged_rows, st);
    case 4: return launch_regs<4>(cost, col4row, S, R, C, stride_s, staged_rows, st);
    case 8: return launch_regs<8>(cost, col4row, S, R, C, stride_s, staged_rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The shared route (lap.plan's "shared", C > 256): S blocks of one warp on
// `stream`; returns as odam_lap_solve_regs does.
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

#ifdef ODAM_LAP_CLOCK
// Dev build only: where problem 0 writes its stamps (kClkSlots int64).
int odam_lap_clock_target(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_clock, &buf, sizeof(buf)));
}
#endif

}  // extern "C"
