// Touched-row Adagrad update of the fused embedding table, in place.
//
// Replaces the TPU kernel nasrec_tpu/ops/kernels/table_sweep_pallas.py ::
// sweep_adagrad_update.  Same contract, on the plain [vocab, E] f32 table,
// E = 16 (NASRec's tables) or 128 (DLRM-DCNv2's):
//
//   rows  [N] int32, sorted global vocab rows (sentinels >= vocab allowed);
//   seg   [N, E] f32, each row's summed and clip-scaled gradient at one
//         position, exact zeros at the row's other positions;
//   for each position with a nonzero seg whose row lies in
//   [row_offset, row_offset + vocab):
//       acc'   = acc + d*d
//       table' = table - lr * d / (sqrt(acc') + eps)
//
// The TPU kernel streams the whole table because the TPU's scatter was
// latency-bound.  Here the update touches rows only.  Bound: bytes, N*(4+4E)
// read for the positions plus 4*4E B for each touched row; what holds the
// kernel back is the latency of the random reads of acc and table rows, so
// the design keeps many of them in flight: E/4 threads a position, each with
// one 16-byte load and store of acc and of table (at E = 16 a warp holds 8
// positions; at E = 128 a warp is one position, its 512-byte row read whole
// by the warp), acc and table loaded together before the first divide.  rows and
// seg are read once and go through streaming loads, so they evict no table
// line from the caches.  (Two or four positions a thread, with all their loads
// issued first, took the same time and were taken out.)
//
// Two hazards, both handled before any access:
//   duplicates  a row appears at several positions and only one carries a
//               nonzero seg.  A group whose E values are all zero skips the
//               row (exact: a zero update leaves the row bit-identical), so
//               no zero write races with the real one.
//   bounds      rows outside [row_offset, row_offset + vocab) are skipped,
//               never clamped.
//
// The arithmetic is rounded step by step (no fused multiply-add) so that the
// result matches the plain PyTorch version bit for bit.  One templated body;
// the __global__ functions are `table_update_kernel` (E = 16) and
// `table_update128_kernel` (E = 128), so a device trace tells them apart.
//
// The 128-wide kernel takes an optional counter: where `written` is not null,
// it adds the number of rows it writes (a block's count, one atomic a block).
// The program passes one only while a profiler runs, so that a roofline can
// count the rows written without a pass of its own over seg.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float update_one(float d, float a_old, float t_old, float lr,
                                            float eps, float* a_new) {
  const float a = __fadd_rn(a_old, __fmul_rn(d, d));
  *a_new = a;
  return __fsub_rn(t_old, __fdiv_rn(__fmul_rn(lr, d), __fadd_rn(__fsqrt_rn(a), eps)));
}

// Returns whether this thread's position was written.
template <int kEmb>
__device__ __forceinline__ bool update_rows(float* __restrict__ table, float* __restrict__ acc,
                                            const int* __restrict__ rows,
                                            const float* __restrict__ seg, long long n,
                                            long long vocab, long long row_offset, float lr,
                                            float eps) {
  constexpr int kGroup = kEmb / 4;                   // threads a position, 4 floats each
  constexpr int kBlockPositions = kThreads / kGroup;
  constexpr unsigned kGroupMask = kGroup == 32 ? 0xffffffffu : (1u << (kGroup & 31)) - 1u;
  static_assert(kEmb % 4 == 0 && kGroup <= 32 && 32 % kGroup == 0, "a group lies in a warp");
  const int lane_shift = threadIdx.x & 31 & ~(kGroup - 1);  // first lane of this group
  const int part = threadIdx.x & (kGroup - 1);              // which 4 of the E floats
  const long long pos =
      static_cast<long long>(blockIdx.x) * kBlockPositions + threadIdx.x / kGroup;
  const bool in = pos < n;
  const float4 d = in ? __ldcs(reinterpret_cast<const float4*>(seg) + pos * kGroup + part)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const long long r = in ? static_cast<long long>(__ldcs(rows + pos)) - row_offset : -1;
  // Every lane reaches the ballot; each group of kGroup lanes is one position.
  const bool nz = d.x != 0.0f || d.y != 0.0f || d.z != 0.0f || d.w != 0.0f;
  const unsigned live = (__ballot_sync(0xffffffffu, nz) >> lane_shift) & kGroupMask;
  if (live == 0u || r < 0 || r >= vocab) return false;
  const long long at = r * kGroup + part;  // this thread's float4 of the row
  const float4 a = reinterpret_cast<const float4*>(acc)[at];
  const float4 t = reinterpret_cast<const float4*>(table)[at];
  float4 an, tn;
  tn.x = update_one(d.x, a.x, t.x, lr, eps, &an.x);
  tn.y = update_one(d.y, a.y, t.y, lr, eps, &an.y);
  tn.z = update_one(d.z, a.z, t.z, lr, eps, &an.z);
  tn.w = update_one(d.w, a.w, t.w, lr, eps, &an.w);
  reinterpret_cast<float4*>(acc)[at] = an;
  reinterpret_cast<float4*>(table)[at] = tn;
  return true;
}

__global__ void __launch_bounds__(kThreads)
table_update_kernel(float* __restrict__ table, float* __restrict__ acc,
                    const int* __restrict__ rows, const float* __restrict__ seg,
                    long long n, long long vocab, long long row_offset,
                    float lr, float eps) {
  update_rows<16>(table, acc, rows, seg, n, vocab, row_offset, lr, eps);
}

__global__ void __launch_bounds__(kThreads)
table_update128_kernel(float* __restrict__ table, float* __restrict__ acc,
                       const int* __restrict__ rows, const float* __restrict__ seg,
                       long long n, long long vocab, long long row_offset,
                       float lr, float eps, unsigned long long* __restrict__ written) {
  const bool wrote = update_rows<128>(table, acc, rows, seg, n, vocab, row_offset, lr, eps);
  if (written != nullptr) {  // the same for every thread: all reach the barrier
    // A warp is one position: its first lane counts it.
    const int rows_written = __syncthreads_count(wrote && (threadIdx.x & 31) == 0);
    if (threadIdx.x == 0 && rows_written > 0)
      atomicAdd(written, static_cast<unsigned long long>(rows_written));
  }
}

}  // namespace

extern "C" int nasrec_table_update(float* table, float* acc, const int* rows,
                                   const float* seg, long long n, long long vocab,
                                   long long row_offset, float lr, float eps,
                                   void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + kThreads / 4 - 1) / (kThreads / 4);
  table_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, acc, rows, seg, n, vocab, row_offset, lr, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nasrec_table_update128(float* table, float* acc, const int* rows,
                                      const float* seg, long long n, long long vocab,
                                      long long row_offset, float lr, float eps,
                                      unsigned long long* written, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
  table_update128_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table, acc, rows, seg, n, vocab, row_offset, lr, eps, written);
  return static_cast<int>(cudaGetLastError());
}
