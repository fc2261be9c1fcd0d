// Touched-row Adagrad update of the fused embedding table, in place.
//
// Replaces the TPU kernel nasrec_tpu/ops/kernels/table_sweep_pallas.py ::
// sweep_adagrad_update.  Same contract, on the plain [vocab, 16] f32 table:
//
//   rows  [N] int32, sorted global vocab rows (sentinels >= vocab allowed);
//   seg   [N, 16] f32, each row's summed and clip-scaled gradient at one
//         position, exact zeros at the row's other positions;
//   for each position with a nonzero seg whose row lies in
//   [row_offset, row_offset + vocab):
//       acc'   = acc + d*d
//       table' = table - lr * d / (sqrt(acc') + eps)
//
// The TPU kernel streams the whole table because the TPU's scatter was
// latency-bound.  Here the update touches rows only.  Bound: bytes, N*(4+64)
// read for the positions plus 4*64 B for each touched row; what holds the
// kernel back is the latency of the random 64-byte reads of acc and table,
// so the design keeps many of them in flight: four threads a position, each
// with one 16-byte load and store of acc and of table (a warp holds 8
// positions), acc and table loaded together before the first divide.  rows and
// seg are read once and go through streaming loads, so they evict no table
// line from the caches.  (Two or four positions a thread, with all their loads
// issued first, took the same time and were taken out.)
//
// Two hazards, both handled before any access:
//   duplicates  a row appears at several positions and only one carries a
//               nonzero seg.  A group whose 16 values are all zero skips the
//               row (exact: a zero update leaves the row bit-identical), so
//               no zero write races with the real one.
//   bounds      rows outside [row_offset, row_offset + vocab) are skipped,
//               never clamped.
//
// The arithmetic is rounded step by step (no fused multiply-add) so that the
// result matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;                       // threads a position, 4 floats each
constexpr int kBlockPositions = kThreads / kGroup;

__device__ __forceinline__ float update_one(float d, float a_old, float t_old, float lr,
                                            float eps, float* a_new) {
  const float a = __fadd_rn(a_old, __fmul_rn(d, d));
  *a_new = a;
  return __fsub_rn(t_old, __fdiv_rn(__fmul_rn(lr, d), __fadd_rn(__fsqrt_rn(a), eps)));
}

__global__ void __launch_bounds__(kThreads)
table_update_kernel(float* __restrict__ table, float* __restrict__ acc,
                    const int* __restrict__ rows, const float* __restrict__ seg,
                    long long n, long long vocab, long long row_offset,
                    float lr, float eps) {
  const int lane_shift = threadIdx.x & 31 & ~(kGroup - 1);  // first lane of this group
  const int part = threadIdx.x & (kGroup - 1);              // which 4 of the 16 floats
  const long long pos =
      static_cast<long long>(blockIdx.x) * kBlockPositions + threadIdx.x / kGroup;
  const bool in = pos < n;
  const float4 d = in ? __ldcs(reinterpret_cast<const float4*>(seg) + pos * kGroup + part)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const long long r = in ? static_cast<long long>(__ldcs(rows + pos)) - row_offset : -1;
  // Every lane reaches the ballot; each group of four lanes is one position.
  const bool nz = d.x != 0.0f || d.y != 0.0f || d.z != 0.0f || d.w != 0.0f;
  const unsigned live = (__ballot_sync(0xffffffffu, nz) >> lane_shift) & ((1u << kGroup) - 1u);
  if (live == 0u || r < 0 || r >= vocab) return;
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
}

}  // namespace

extern "C" int nasrec_table_update(float* table, float* acc, const int* rows,
                                   const float* seg, long long n, long long vocab,
                                   long long row_offset, float lr, float eps,
                                   void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + kBlockPositions - 1) / kBlockPositions;
  table_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, acc, rows, seg, n, vocab, row_offset, lr, eps);
  return static_cast<int>(cudaGetLastError());
}
