// Tiny-head self-attention core, forward and backward.
//
// Replaces the TPU kernel nasrec_tpu/ops/kernels/attention_pallas.py ::
// tiny_head_attention_bmajor (_fwd_kernel, _bwd_kernel).  Same function, laid
// out for this card: qkv is batch-major [B, S, 48] with q, k and v stacked on
// the last axis, as a feature linear leaves them, and o is [B, S, 16]:
//
//   forward   o = softmax(q k^T / sqrt(2)) v   per head (8 heads of width 2)
//   backward  dqkv from (qkv, do); nothing is saved, so the softmax
//             statistics and o are computed again first
//
// Bound: operations.  A position reads 192 bytes and writes 64 for about
// 72 S flops and 8 S exponentials, which at S = 64 is far above the card's
// flop/byte balance for f32 outside the tensor cores.  Design: one thread per
// (batch row, slot) position, a block per tile of whole batch rows, the row's
// keys and values in shared memory; the arithmetic, folded to two FFMA and one
// ex2 a probability, is in tiny_attn.cuh.

#include "tiny_attn.cuh"

namespace {

using namespace tiny_attn;

constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxThreads = 128;         // positions of one tile, at most
constexpr int kRec = kMaxThreads * kLd;  // floats of one record array
constexpr size_t kFwdSmem = 2 * kRec * sizeof(float);
constexpr size_t kBwdSmem = 5 * kRec * sizeof(float);

__global__ void __launch_bounds__(kMaxThreads, 4)
attn_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ o,
                long long batch, int S, int rpt) {
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = smem + kRec;
  const int t = threadIdx.x;
  const int r = t / S;
  const long long tiles = (batch + rpt - 1) / rpt;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long b0 = tile * rpt;
    const int rows = static_cast<int>(min(static_cast<long long>(rpt), batch - b0));
    const bool active = r < rows;
    const long long pos = b0 * S + t;
    float qs[kE];
    if (active) {
      const float* src = qkv + pos * (3 * kE);
      float tmp[kE];
      load16(src, qs);
#pragma unroll
      for (int e = 0; e < kE; ++e) qs[e] *= kQScale;
      load16(src + kE, tmp);
      store16(sk + t * kLd, tmp);
      load16(src + 2 * kE, tmp);
      store16(sv + t * kLd, tmp);
    }
    __syncthreads();
    if (active) {
      float ov[kE], lse2[kH];
      attn_fwd(qs, sk + r * S * kLd, sv + r * S * kLd, S, ov, lse2);
      store16(o + pos * kE, ov);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                float* __restrict__ dqkv, long long batch, int S, int rpt) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = smem + kRec;
  float* sv = smem + 2 * kRec;
  float* sdo = smem + 3 * kRec;
  float* srec = smem + 4 * kRec;
  const int t = threadIdx.x;
  const int r = t / S;
  const int row0 = r * S * kLd;
  const long long tiles = (batch + rpt - 1) / rpt;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long b0 = tile * rpt;
    const int rows = static_cast<int>(min(static_cast<long long>(rpt), batch - b0));
    const bool active = r < rows;
    const long long pos = b0 * S + t;
    float qs[kE], dov[kE];
    if (active) {
      const float* src = qkv + pos * (3 * kE);
      float tmp[kE];
      load16(src, qs);
#pragma unroll
      for (int e = 0; e < kE; ++e) qs[e] *= kQScale;
      store16(sq + t * kLd, qs);
      load16(src + kE, tmp);
      store16(sk + t * kLd, tmp);
      load16(src + 2 * kE, tmp);
      store16(sv + t * kLd, tmp);
      load16(dout + pos * kE, dov);
      store16(sdo + t * kLd, dov);
    }
    __syncthreads();
    float rec[kE];
    if (active) {
      float ov[kE], lse2[kH];
      attn_fwd(qs, sk + row0, sv + row0, S, ov, lse2);
      attn_row_record(dov, ov, lse2, rec);
      store16(srec + t * kLd, rec);
    }
    __syncthreads();
    if (active) {
      float* dst = dqkv + pos * (3 * kE);
      float dq[kE];
      attn_bwd_dq(qs, dov, rec, sk + row0, sv + row0, S, dq);
      store16(dst, dq);
      float kj[kE], vj[kE], dk[kE], dv[kE];
      load16(sk + t * kLd, kj);
      load16(sv + t * kLd, vj);
      attn_bwd_dkv(kj, vj, sq + row0, sdo + row0, srec + row0, S, dk, dv);
      store16(dst + kE, dk);
      store16(dst + 2 * kE, dv);
    }
    __syncthreads();
  }
}

int grid_for(long long batch, int rpt) {
  const long long tiles = (batch + rpt - 1) / rpt;
  return static_cast<int>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
}

}  // namespace

extern "C" int nasrec_attn_fwd(const float* qkv, float* o, long long batch, int S,
                               int rpt, int threads, void* stream) {
  if (bad_tile(S, rpt, threads, kMaxThreads)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  attn_fwd_kernel<<<grid_for(batch, rpt), threads, kFwdSmem,
                    static_cast<cudaStream_t>(stream)>>>(qkv, o, batch, S, rpt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nasrec_attn_bwd(const float* qkv, const float* dout, float* dqkv,
                               long long batch, int S, int rpt, int threads,
                               void* stream) {
  if (bad_tile(S, rpt, threads, kMaxThreads)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  attn_bwd_kernel<<<grid_for(batch, rpt), threads, kBwdSmem,
                    static_cast<cudaStream_t>(stream)>>>(qkv, dout, dqkv, batch, S, rpt);
  return static_cast<int>(cudaGetLastError());
}
