// Tiny-head self-attention over the slot axis, as __device__ functions shared
// by attention.cu (the standalone attention kernel) and transformer_body.cu
// (the fused transformer body).
//
// E = 16 features in H = 8 heads of width 2, so a head's score is a sum of two
// products and there is no contraction worth a tensor core: the work is FFMA
// and expf.  One thread owns one (batch row, slot) position.  Its query stays
// in registers; the keys and values of its batch row lie in shared memory as
// 16-float records, which every thread of the row reads at the same address
// (a broadcast, so no bank conflicts), four floats per load.
//
//   s_h[i,j] = (q[i,2h] k[j,2h] + q[i,2h+1] k[j,2h+1]) / sqrt(2)
//   p_h      = softmax_j(s_h)           two passes: max, then exp and sum
//   o[i,2h+d] = sum_j p_h[i,j] v[j,2h+d]
//
// The backward makes two sweeps, so that no sum crosses threads and no
// atomics are needed: a thread as query i loops over the keys for dq, and a
// thread as key j loops over the queries for dk and dv.  Both rebuild
// p = exp(s - m) * (1/sum) from the softmax statistics, and use
// sum_j dp[i,j] p[i,j] = sum_d do[i,2h+d] o[i,2h+d], which needs no sweep.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tiny_attn {

constexpr int kE = 16;   // features of a slot
constexpr int kH = 8;    // heads of width kE / kH = 2
// Stride, in floats, of a 16-float record in shared memory: 80 bytes keeps a
// record 16-byte aligned and spreads the float4 stores of 8 neighbouring
// threads over all 32 banks.
constexpr int kLd = 20;
constexpr float kScale = 0.70710678118654752440f;  // 1 / sqrt(head width)

__device__ __forceinline__ void load16(const float* src, float (&v)[kE]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 a = s4[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

__device__ __forceinline__ void store16(float* dst, const float (&v)[kE]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    d4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// The score of head h; the same expression wherever a score is rebuilt.
__device__ __forceinline__ float score(const float (&qs)[kE], const float (&k)[kE], int h) {
  return fmaf(qs[2 * h + 1], k[2 * h + 1], qs[2 * h] * k[2 * h]);
}

// Forward for one query position.  qs: the query, scaled by kScale.  sk, sv:
// the keys and values of its batch row (record j at + j * kLd).  Returns the
// output o and the statistics m (row max) and iden (1 / row sum) per head.
__device__ __forceinline__ void attn_fwd(const float (&qs)[kE], const float* sk,
                                         const float* sv, int S, float (&o)[kE],
                                         float (&m)[kH], float (&iden)[kH]) {
#pragma unroll
  for (int h = 0; h < kH; ++h) m[h] = -CUDART_INF_F;
  for (int j = 0; j < S; ++j) {
    float kj[kE];
    load16(sk + j * kLd, kj);
#pragma unroll
    for (int h = 0; h < kH; ++h) m[h] = fmaxf(m[h], score(qs, kj, h));
  }
  float sum[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) sum[h] = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e) o[e] = 0.0f;
  for (int j = 0; j < S; ++j) {
    float kj[kE], vj[kE];
    load16(sk + j * kLd, kj);
    load16(sv + j * kLd, vj);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float p = expf(score(qs, kj, h) - m[h]);
      sum[h] += p;
      o[2 * h] = fmaf(p, vj[2 * h], o[2 * h]);
      o[2 * h + 1] = fmaf(p, vj[2 * h + 1], o[2 * h + 1]);
    }
  }
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    iden[h] = 1.0f / sum[h];
    o[2 * h] *= iden[h];
    o[2 * h + 1] *= iden[h];
  }
}

// dsum[h] = sum_d do[2h+d] o[2h+d], the softmax backward's row term.
__device__ __forceinline__ void attn_row_term(const float (&dout)[kE], const float (&o)[kE],
                                              float (&dsum)[kH]) {
#pragma unroll
  for (int h = 0; h < kH; ++h)
    dsum[h] = fmaf(dout[2 * h + 1], o[2 * h + 1], dout[2 * h] * o[2 * h]);
}

// Backward, first sweep: this thread as query i, over the keys.  dq is the
// gradient of the unscaled query.
__device__ __forceinline__ void attn_bwd_dq(const float (&qs)[kE], const float (&dout)[kE],
                                            const float (&m)[kH], const float (&iden)[kH],
                                            const float (&dsum)[kH], const float* sk,
                                            const float* sv, int S, float (&dq)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) dq[e] = 0.0f;
  for (int j = 0; j < S; ++j) {
    float kj[kE], vj[kE];
    load16(sk + j * kLd, kj);
    load16(sv + j * kLd, vj);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float p = expf(score(qs, kj, h) - m[h]) * iden[h];
      const float dp = fmaf(dout[2 * h + 1], vj[2 * h + 1], dout[2 * h] * vj[2 * h]);
      const float ds = p * (dp - dsum[h]);
      dq[2 * h] = fmaf(ds, kj[2 * h], dq[2 * h]);
      dq[2 * h + 1] = fmaf(ds, kj[2 * h + 1], dq[2 * h + 1]);
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) dq[e] *= kScale;
}

// Backward, second sweep: this thread as key j, over the queries of its batch
// row.  sq: scaled queries; sdo: output gradients; sst: statistics records
// (m[0..7], iden[0..7]); sds: row terms (8 floats of each record used).
__device__ __forceinline__ void attn_bwd_dkv(const float (&kj)[kE], const float (&vj)[kE],
                                             const float* sq, const float* sdo,
                                             const float* sst, const float* sds, int S,
                                             float (&dk)[kE], float (&dv)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    dk[e] = 0.0f;
    dv[e] = 0.0f;
  }
  for (int i = 0; i < S; ++i) {
    float qi[kE], doi[kE], st[kE];
    load16(sq + i * kLd, qi);
    load16(sdo + i * kLd, doi);
    load16(sst + i * kLd, st);
    const float4 d0 = *reinterpret_cast<const float4*>(sds + i * kLd);
    const float4 d1 = *reinterpret_cast<const float4*>(sds + i * kLd + 4);
    const float dsum[kH] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float p = expf(score(qi, kj, h) - st[h]) * st[kH + h];
      const float dp = fmaf(doi[2 * h + 1], vj[2 * h + 1], doi[2 * h] * vj[2 * h]);
      const float ds = p * (dp - dsum[h]);
      dk[2 * h] = fmaf(ds, qi[2 * h], dk[2 * h]);       // qi carries the 1/sqrt(2)
      dk[2 * h + 1] = fmaf(ds, qi[2 * h + 1], dk[2 * h + 1]);
      dv[2 * h] = fmaf(p, doi[2 * h], dv[2 * h]);
      dv[2 * h + 1] = fmaf(p, doi[2 * h + 1], dv[2 * h + 1]);
    }
  }
}

// Tile geometry shared by both sources: a block works on `rpt` whole batch
// rows at a time, thread t on position t of the tile (row t / S, slot t % S).
constexpr int kMaxThreads = 128;       // positions of one tile, at most
constexpr int kRec = kMaxThreads * kLd;  // floats of one record array

// A launch the kernels cannot serve: a batch row must fit in one tile.
inline bool bad_tile(int S, int rpt, int threads) {
  return S < 1 || rpt < 1 || threads > kMaxThreads || rpt * S > threads;
}

}  // namespace tiny_attn
