// Tiny-head self-attention over the slot axis, as __device__ functions shared
// by attention.cu (the standalone attention kernel) and transformer_body.cu
// (the fused transformer body).
//
// E = 16 features in H = 8 heads of width 2, so a head's score is a sum of two
// products and there is no contraction worth a tensor core: the work is FFMA
// and one exponential a (query, key, head).  One thread owns one (batch row,
// slot) position.  Its query stays in registers; the keys and values of its
// batch row lie in shared memory as 16-float records, which every thread of
// the row reads at the same address (a broadcast, so no bank conflicts), four
// floats per load.
//
// The loops are bound by how many operations a warp scheduler can dispatch,
// so the softmax is folded into as few as it takes.  The query is scaled once by log2(e) / sqrt(2), which
// makes every exponential a bare ex2 of a fused multiply-add:
//
//   t_h[i,j] = q2[i,2h] k[j,2h] + q2[i,2h+1] k[j,2h+1]     q2 = q log2(e)/sqrt(2)
//   forward    m = max_j t;  p = ex2(t - m);  o = sum_j p v / sum_j p
//              lse2 = m + log2(sum_j p)       the one statistic a head
//   backward   p = ex2(t - lse2)              the normalised probability
//              ds = p (do . v - dsum)         dsum = do . o, which needs no sweep
//
// so a pair costs two FFMA and one MUFU for p, with no subtract and no
// multiply by 1/sum.  ex2.approx.ftz.f32 has a relative error of at most
// 2^-22 (2.4e-7) over its whole range; a result below 2^-126 becomes 0, which
// a probability that small may.  The arguments here are at most a rounding
// above 0, and p enters sums of at most 128 terms that are held to 1e-5 of the
// output's largest magnitude, forty times the error of one term.
//
// The backward makes two sweeps, so that no sum crosses threads and no
// atomics are needed: a thread as query i loops over the keys for dq, and a
// thread as key j loops over the queries for dk and dv.  dq and dk carry the
// factor 1/sqrt(2) without the log2(e): dq sums ds k and is scaled by
// 1/sqrt(2) at the end; dk sums ds q2 and is scaled by ln(2).

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
constexpr float kScale = 0.70710678118654752440f;   // 1 / sqrt(head width)
constexpr float kQScale = 1.02013944659678950f;     // log2(e) / sqrt(head width)
constexpr float kLn2 = 0.69314718055994530942f;

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

// 2^x in one MUFU operation (see the note on its error above).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// q2 . k of head h plus c: two FFMA.
__device__ __forceinline__ float dot2(const float (&a)[kE], const float (&b)[kE], int h,
                                      float c) {
  return fmaf(a[2 * h + 1], b[2 * h + 1], fmaf(a[2 * h], b[2 * h], c));
}

// Forward for one query position.  q2: the query, scaled by kQScale.  sk, sv:
// the keys and values of its batch row (record j at + j * kLd).  Returns the
// output o and the statistic lse2 per head.  Two passes over the keys, one for
// the maximum and one for the sums: a score is two FFMA, cheaper to compute
// twice than to rescale running sums by a second exponential.
__device__ __forceinline__ void attn_fwd(const float (&q2)[kE], const float* sk,
                                         const float* sv, int S, float (&o)[kE],
                                         float (&lse2)[kH]) {
  float m[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) m[h] = -CUDART_INF_F;
  for (int j = 0; j < S; ++j) {
    float kj[kE];
    load16(sk + j * kLd, kj);
#pragma unroll
    for (int h = 0; h < kH; ++h) m[h] = fmaxf(m[h], dot2(q2, kj, h, 0.0f));
  }
  float sum[kH];
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    sum[h] = 0.0f;
    m[h] = -m[h];
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) o[e] = 0.0f;
  for (int j = 0; j < S; ++j) {
    float kj[kE], vj[kE];
    load16(sk + j * kLd, kj);
    load16(sv + j * kLd, vj);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float p = ex2(dot2(q2, kj, h, m[h]));
      sum[h] += p;
      o[2 * h] = fmaf(p, vj[2 * h], o[2 * h]);
      o[2 * h + 1] = fmaf(p, vj[2 * h + 1], o[2 * h + 1]);
    }
  }
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    const float iden = 1.0f / sum[h];
    lse2[h] = log2f(sum[h]) - m[h];
    o[2 * h] *= iden;
    o[2 * h + 1] *= iden;
  }
}

// The backward's row record of one query: -lse2[0..7], then
// -dsum[0..7] with dsum[h] = sum_d do[2h+d] o[2h+d], the softmax backward's
// row term.
__device__ __forceinline__ void attn_row_record(const float (&dout)[kE], const float (&o)[kE],
                                                const float (&lse2)[kH], float (&rec)[kE]) {
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    rec[h] = -lse2[h];
    rec[kH + h] = -fmaf(dout[2 * h + 1], o[2 * h + 1], dout[2 * h] * o[2 * h]);
  }
}

// Backward, first sweep: this thread as query i, over the keys.  rec: its row
// record.  dq is the gradient of the unscaled query.
__device__ __forceinline__ void attn_bwd_dq(const float (&q2)[kE], const float (&dout)[kE],
                                            const float (&rec)[kE], const float* sk,
                                            const float* sv, int S, float (&dq)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) dq[e] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < S; ++j) {
    float kj[kE], vj[kE];
    load16(sk + j * kLd, kj);
    load16(sv + j * kLd, vj);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float p = ex2(dot2(q2, kj, h, rec[h]));
      const float ds = p * dot2(dout, vj, h, rec[kH + h]);
      dq[2 * h] = fmaf(ds, kj[2 * h], dq[2 * h]);
      dq[2 * h + 1] = fmaf(ds, kj[2 * h + 1], dq[2 * h + 1]);
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) dq[e] *= kScale;
}

// Backward, second sweep: this thread as key j, over the queries of its batch
// row.  sq: queries scaled by kQScale; sdo: output gradients; srec: row records.
__device__ __forceinline__ void attn_bwd_dkv(const float (&kj)[kE], const float (&vj)[kE],
                                             const float* sq, const float* sdo,
                                             const float* srec, int S, float (&dk)[kE],
                                             float (&dv)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    dk[e] = 0.0f;
    dv[e] = 0.0f;
  }
#pragma unroll 4
  for (int i = 0; i < S; ++i) {
    float qi[kE], doi[kE], rec[kE];
    load16(sq + i * kLd, qi);
    load16(sdo + i * kLd, doi);
    load16(srec + i * kLd, rec);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float p = ex2(dot2(qi, kj, h, rec[h]));
      const float ds = p * dot2(doi, vj, h, rec[kH + h]);
      dk[2 * h] = fmaf(ds, qi[2 * h], dk[2 * h]);
      dk[2 * h + 1] = fmaf(ds, qi[2 * h + 1], dk[2 * h + 1]);
      dv[2 * h] = fmaf(p, doi[2 * h], dv[2 * h]);
      dv[2 * h + 1] = fmaf(p, doi[2 * h + 1], dv[2 * h + 1]);
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) dk[e] *= kLn2;   // qi carries log2(e) / sqrt(2)
}

// Tile geometry shared by both sources: a block works on `rpt` whole batch
// rows at a time, thread t on position t of the tile (row t / S, slot t % S).
// A launch the kernels cannot serve: a batch row must fit in one tile.
inline bool bad_tile(int S, int rpt, int threads, int max_threads) {
  return S < 1 || rpt < 1 || threads > max_threads || threads % 32 != 0 || rpt * S > threads;
}

}  // namespace tiny_attn
