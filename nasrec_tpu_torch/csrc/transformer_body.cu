// Fused body of the transformer node, forward and backward.
//
// Replaces the TPU kernel nasrec_tpu/ops/kernels/transformer_body_pallas.py ::
// transformer_body_fused (_fwd_kernel, _bwd_kernel).  Same function, laid out
// for this card: x, out, o and the gradients are batch-major [B, S, 16] (the
// flat slot-major [B, S*16] the blocks exchange, viewed without a copy), the
// statistics are [B, S, 16] (8 row maxima, then 8 inverse row sums), and the
// twelve parameters come as one flat array in PyTorch's [out, in] layout:
//
//   qkv = W_in x + b_in            o   = tiny-head attention(qkv)
//   a   = W_out o + b_out          x4  = LN(a + x) g1 + h1
//   f   = W_fc2 relu(W_fc1 x4 + b_fc1) + b_fc2
//   out = LN(x4 + f) g2 + h2
//
// The training forward also writes o and the softmax statistics; the backward
// reads them, runs the chain after the attention again, and returns dx and the
// gradients of all twelve parameters.
//
// Bound: operations at S = 64 and 48 (about 72 S + 3,300 flops and 8 S
// exponentials a position against 128 to 320 bytes), closer to bytes at
// S = 16.  Design: one thread per (batch row, slot) position with everything
// of that position in registers, so the five feature linears and both
// LayerNorms never leave the thread; weights sit in shared memory and are read
// as float4 broadcasts; only the keys and values of a batch row are shared.
//
// Parameter gradients are sums over all positions.  A fixed grid of blocks
// walks the batch; after each tile the threads stage their per-position
// factors in shared memory, column-wise with a stride of 129 floats, and turn
// to a second role: thread (f, e) of 8 x 16 owns the entries (f, e) and
// (f + 8, e) of each weight gradient and adds the tile's outer products to
// registers.  Each block writes one partial; a second kernel sums the partials
// in block order.  No float atomics, so equal inputs give equal bits.

#include "tiny_attn.cuh"

namespace {

using namespace tiny_attn;

// Offsets into the flat parameter array (and its gradient).
constexpr int W_IN = 0;        // [48, 16]
constexpr int B_IN = 768;      // [48]
constexpr int W_OUT = 816;     // [16, 16]
constexpr int B_OUT = 1072;
constexpr int G1 = 1088;       // attention LayerNorm weight, bias
constexpr int H1 = 1104;
constexpr int W_FC1 = 1120;    // [16, 16]
constexpr int B_FC1 = 1376;
constexpr int W_FC2 = 1392;    // [16, 16]
constexpr int B_FC2 = 1648;
constexpr int G2 = 1664;       // FFN LayerNorm weight, bias
constexpr int H2 = 1680;
constexpr int kParams = 1696;

constexpr int kMaxBlocksFwd = 132 * 16;
constexpr int kCol = kMaxThreads + 1;    // stride of a staged column
constexpr int kColSlot = kE * kCol;      // floats of one column-staged array
constexpr int kColSlots = 8;
constexpr size_t kFwdSmem = (kParams + 2 * kRec) * sizeof(float);
// The backward's staging area holds either 8 column arrays or 6 record arrays.
constexpr int kStage = kColSlots * kColSlot > 6 * kRec ? kColSlots * kColSlot : 6 * kRec;
constexpr size_t kBwdSmem = (kParams + kStage) * sizeof(float);

// y = W x + b for a [16, 16] weight in shared memory.
__device__ __forceinline__ void lin16(const float* w, const float* b, const float (&x)[kE],
                                      float (&y)[kE]) {
#pragma unroll
  for (int f = 0; f < kE; ++f) {
    float acc = b[f];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 ww = *reinterpret_cast<const float4*>(w + f * kE + 4 * q);
      acc = fmaf(ww.x, x[4 * q], acc);
      acc = fmaf(ww.y, x[4 * q + 1], acc);
      acc = fmaf(ww.z, x[4 * q + 2], acc);
      acc = fmaf(ww.w, x[4 * q + 3], acc);
    }
    y[f] = acc;
  }
}

// dx += W^T dy for a [16, 16] weight in shared memory.
__device__ __forceinline__ void lin16_t_acc(const float* w, const float (&dy)[kE],
                                            float (&dx)[kE]) {
#pragma unroll
  for (int f = 0; f < kE; ++f) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 ww = *reinterpret_cast<const float4*>(w + f * kE + 4 * q);
      dx[4 * q] = fmaf(ww.x, dy[f], dx[4 * q]);
      dx[4 * q + 1] = fmaf(ww.y, dy[f], dx[4 * q + 1]);
      dx[4 * q + 2] = fmaf(ww.z, dy[f], dx[4 * q + 2]);
      dx[4 * q + 3] = fmaf(ww.w, dy[f], dx[4 * q + 3]);
    }
  }
}

// LayerNorm over the 16 features (biased variance): y = xhat g + h.
__device__ __forceinline__ void layer_norm(const float (&r)[kE], const float* g,
                                           const float* h, float eps, float (&y)[kE],
                                           float (&xhat)[kE], float& inv) {
  float mu = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e) mu += r[e];
  mu *= 1.0f / kE;
  float var = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float d = r[e] - mu;
    var = fmaf(d, d, var);
  }
  inv = rsqrtf(var * (1.0f / kE) + eps);
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    xhat[e] = (r[e] - mu) * inv;
    y[e] = fmaf(xhat[e], g[e], h[e]);
  }
}

// dr of y = xhat g + h, xhat = (r - mean) * inv.
__device__ __forceinline__ void layer_norm_bwd(const float (&dy)[kE], const float (&xhat)[kE],
                                               float inv, const float* g, float (&dr)[kE]) {
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    dr[e] = dy[e] * g[e];
    s1 += dr[e];
    s2 = fmaf(dr[e], xhat[e], s2);
  }
  s1 *= 1.0f / kE;
  s2 *= 1.0f / kE;
#pragma unroll
  for (int e = 0; e < kE; ++e) dr[e] = inv * (dr[e] - s1 - xhat[e] * s2);
}

// q (scaled) into registers, k and v into this position's records.
__device__ __forceinline__ void project_qkv(const float* sw, const float (&xv)[kE],
                                            float (&qs)[kE], float* krec, float* vrec) {
  float tmp[kE];
  lin16(sw + W_IN, sw + B_IN, xv, qs);
#pragma unroll
  for (int e = 0; e < kE; ++e) qs[e] *= kScale;
  lin16(sw + W_IN + kE * kE, sw + B_IN + kE, xv, tmp);
  store16(krec, tmp);
  lin16(sw + W_IN + 2 * kE * kE, sw + B_IN + 2 * kE, xv, tmp);
  store16(vrec, tmp);
}

__device__ __forceinline__ void load_params(const float* __restrict__ prm, float* sw) {
  for (int i = threadIdx.x; i < kParams; i += blockDim.x) sw[i] = prm[i];
}

template <bool kTrain>
__global__ void __launch_bounds__(kMaxThreads)
body_fwd_kernel(const float* __restrict__ x, const float* __restrict__ prm,
                float* __restrict__ out, float* __restrict__ o_out,
                float* __restrict__ stats_out, long long batch, int S, int rpt,
                float eps) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* sk = smem + kParams;
  float* sv = sk + kRec;
  load_params(prm, sw);
  __syncthreads();
  const int t = threadIdx.x;
  const int r = t / S;
  const int row0 = r * S * kLd;
  const long long tiles = (batch + rpt - 1) / rpt;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long b0 = tile * rpt;
    const int rows = static_cast<int>(min(static_cast<long long>(rpt), batch - b0));
    const bool active = r < rows;
    const long long pos = b0 * S + t;
    float xv[kE], qs[kE];
    if (active) {
      load16(x + pos * kE, xv);
      project_qkv(sw, xv, qs, sk + t * kLd, sv + t * kLd);
    }
    __syncthreads();
    if (active) {
      float ov[kE], m[kH], iden[kH];
      attn_fwd(qs, sk + row0, sv + row0, S, ov, m, iden);
      if (kTrain) {
        float st[kE];
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          st[h] = m[h];
          st[kH + h] = iden[h];
        }
        store16(o_out + pos * kE, ov);
        store16(stats_out + pos * kE, st);
      }
      float a[kE], x4[kE], xhat[kE], inv;
      lin16(sw + W_OUT, sw + B_OUT, ov, a);
#pragma unroll
      for (int e = 0; e < kE; ++e) a[e] += xv[e];
      layer_norm(a, sw + G1, sw + H1, eps, x4, xhat, inv);
      float p1[kE], f[kE], y[kE];
      lin16(sw + W_FC1, sw + B_FC1, x4, p1);
#pragma unroll
      for (int e = 0; e < kE; ++e) p1[e] = fmaxf(p1[e], 0.0f);
      lin16(sw + W_FC2, sw + B_FC2, p1, f);
#pragma unroll
      for (int e = 0; e < kE; ++e) f[e] += x4[e];
      layer_norm(f, sw + G2, sw + H2, eps, y, xhat, inv);
      store16(out + pos * kE, y);
    }
    __syncthreads();
  }
}

// Stage this position's 16 values as column p of a [16][kCol] array.
__device__ __forceinline__ void stage_col(float* slot, int p, const float (&v)[kE]) {
#pragma unroll
  for (int c = 0; c < kE; ++c) slot[c * kCol + p] = v[c];
}

__global__ void __launch_bounds__(kMaxThreads)
body_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                const float* __restrict__ o_in, const float* __restrict__ stats,
                const float* __restrict__ prm, float* __restrict__ dx,
                float* __restrict__ partial, long long batch, int S, int rpt,
                float eps) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* stage = smem + kParams;
  // Column arrays of the parameter-gradient passes ...
  float* c_dr2 = stage;
  float* c_hr = stage + kColSlot;
  float* c_g2 = stage + 2 * kColSlot;
  float* c_dp1 = stage + 3 * kColSlot;
  float* c_x4 = stage + 4 * kColSlot;
  float* c_g1 = stage + 5 * kColSlot;
  float* c_dx4 = stage + 6 * kColSlot;
  float* c_dr1 = stage + 7 * kColSlot;
  // ... and, over the same memory, the record arrays of the attention sweeps.
  float* sq = stage;
  float* sk = stage + kRec;
  float* sv = stage + 2 * kRec;
  float* sdo = stage + 3 * kRec;
  float* sst = stage + 4 * kRec;
  float* sds = stage + 5 * kRec;

  load_params(prm, sw);
  __syncthreads();
  const int t = threadIdx.x;
  const int r = t / S;
  const int row0 = r * S * kLd;
  // Second role: entry (f0, e) and (f0 + 8, e) of each weight gradient.
  const int f0 = t >> 4;
  const int e0 = t & (kE - 1);
  float a_fc2w[2] = {0.0f, 0.0f}, a_fc1w[2] = {0.0f, 0.0f}, a_wout[2] = {0.0f, 0.0f};
  float a_fc2b[2] = {0.0f, 0.0f}, a_fc1b[2] = {0.0f, 0.0f}, a_bout[2] = {0.0f, 0.0f};
  float a_win[6], a_bin[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    a_win[k] = 0.0f;
    a_bin[k] = 0.0f;
  }
  float a_ln = 0.0f;  // f0 = 0: dg2[e0]; 1: dh2[e0]; 2: dg1[e0]; 3: dh1[e0]

  const long long tiles = (batch + rpt - 1) / rpt;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long b0 = tile * rpt;
    const int rows = static_cast<int>(min(static_cast<long long>(rpt), batch - b0));
    const int npos = rows * S;
    const bool active = r < rows;
    const long long pos0 = b0 * S;
    const long long pos = pos0 + t;

    // The chain after the attention, forward again and then backward.
    float dr1[kE], dov[kE];
    if (active) {
      float xv[kE], ov[kE], dy[kE];
      load16(x + pos * kE, xv);
      load16(o_in + pos * kE, ov);
      load16(dout + pos * kE, dy);
      float a[kE], x4[kE], xh1[kE], inv1;
      lin16(sw + W_OUT, sw + B_OUT, ov, a);
#pragma unroll
      for (int e = 0; e < kE; ++e) a[e] += xv[e];
      layer_norm(a, sw + G1, sw + H1, eps, x4, xh1, inv1);
      float p1[kE], hr[kE], f[kE], y[kE], xh2[kE], inv2;
      lin16(sw + W_FC1, sw + B_FC1, x4, p1);
#pragma unroll
      for (int e = 0; e < kE; ++e) hr[e] = fmaxf(p1[e], 0.0f);
      lin16(sw + W_FC2, sw + B_FC2, hr, f);
#pragma unroll
      for (int e = 0; e < kE; ++e) f[e] += x4[e];
      layer_norm(f, sw + G2, sw + H2, eps, y, xh2, inv2);

      float dr2[kE], tmp[kE];
      layer_norm_bwd(dy, xh2, inv2, sw + G2, dr2);
#pragma unroll
      for (int e = 0; e < kE; ++e) tmp[e] = dy[e] * xh2[e];
      stage_col(c_dr2, t, dr2);
      stage_col(c_hr, t, hr);
      stage_col(c_g2, t, tmp);
      stage_col(c_x4, t, x4);

      float dp1[kE], dx4[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) dp1[e] = 0.0f;
      lin16_t_acc(sw + W_FC2, dr2, dp1);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        dp1[e] = p1[e] > 0.0f ? dp1[e] : 0.0f;
        dx4[e] = dr2[e];
      }
      lin16_t_acc(sw + W_FC1, dp1, dx4);
#pragma unroll
      for (int e = 0; e < kE; ++e) tmp[e] = dx4[e] * xh1[e];
      stage_col(c_dp1, t, dp1);
      stage_col(c_dx4, t, dx4);
      stage_col(c_g1, t, tmp);

      layer_norm_bwd(dx4, xh1, inv1, sw + G1, dr1);
      stage_col(c_dr1, t, dr1);
#pragma unroll
      for (int e = 0; e < kE; ++e) dov[e] = 0.0f;
      lin16_t_acc(sw + W_OUT, dr1, dov);
    }
    __syncthreads();

    // Gradients of fc2, fc1, the out-projection and both LayerNorms.
    {
      const float* o_tile = o_in + pos0 * kE;
      const float* dy_tile = dout + pos0 * kE;
      const float* ln_src = f0 == 0 ? c_g2 : f0 == 2 ? c_g1 : c_dx4;
      for (int p = 0; p < npos; ++p) {
        float u0 = c_dr2[f0 * kCol + p], u1 = c_dr2[(f0 + 8) * kCol + p];
        float v = c_hr[e0 * kCol + p];
        a_fc2w[0] = fmaf(u0, v, a_fc2w[0]);
        a_fc2w[1] = fmaf(u1, v, a_fc2w[1]);
        a_fc2b[0] += u0;
        a_fc2b[1] += u1;
        u0 = c_dp1[f0 * kCol + p];
        u1 = c_dp1[(f0 + 8) * kCol + p];
        v = c_x4[e0 * kCol + p];
        a_fc1w[0] = fmaf(u0, v, a_fc1w[0]);
        a_fc1w[1] = fmaf(u1, v, a_fc1w[1]);
        a_fc1b[0] += u0;
        a_fc1b[1] += u1;
        u0 = c_dr1[f0 * kCol + p];
        u1 = c_dr1[(f0 + 8) * kCol + p];
        v = o_tile[p * kE + e0];
        a_wout[0] = fmaf(u0, v, a_wout[0]);
        a_wout[1] = fmaf(u1, v, a_wout[1]);
        a_bout[0] += u0;
        a_bout[1] += u1;
        if (f0 == 1) {
          a_ln += dy_tile[p * kE + e0];
        } else if (f0 < 4) {
          a_ln += ln_src[e0 * kCol + p];
        }
      }
    }
    __syncthreads();

    // Attention backward from the saved statistics.
    float qs[kE], st[kE], dsum[kH];
    if (active) {
      float xv[kE], ov[kE];
      load16(x + pos * kE, xv);
      project_qkv(sw, xv, qs, sk + t * kLd, sv + t * kLd);
      store16(sq + t * kLd, qs);
      store16(sdo + t * kLd, dov);
      load16(stats + pos * kE, st);
      store16(sst + t * kLd, st);
      load16(o_in + pos * kE, ov);
      attn_row_term(dov, ov, dsum);
      float4* d4 = reinterpret_cast<float4*>(sds + t * kLd);
      d4[0] = make_float4(dsum[0], dsum[1], dsum[2], dsum[3]);
      d4[1] = make_float4(dsum[4], dsum[5], dsum[6], dsum[7]);
    }
    __syncthreads();
    float dq[kE], dk[kE], dv[kE];
    if (active) {
      float m[kH], iden[kH];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        m[h] = st[h];
        iden[h] = st[kH + h];
      }
      attn_bwd_dq(qs, dov, m, iden, dsum, sk + row0, sv + row0, S, dq);
      float kj[kE], vj[kE];
      load16(sk + t * kLd, kj);
      load16(sv + t * kLd, vj);
      attn_bwd_dkv(kj, vj, sq + row0, sdo + row0, sst + row0, sds + row0, S, dk, dv);
    }
    __syncthreads();
    if (active) {
      stage_col(stage, t, dq);
      stage_col(stage + kColSlot, t, dk);
      stage_col(stage + 2 * kColSlot, t, dv);
      lin16_t_acc(sw + W_IN, dq, dr1);
      lin16_t_acc(sw + W_IN + kE * kE, dk, dr1);
      lin16_t_acc(sw + W_IN + 2 * kE * kE, dv, dr1);
      store16(dx + pos * kE, dr1);
    }
    __syncthreads();

    // Gradients of the qkv projection: rows f0 + 8k of [48, 16].
    {
      const float* x_tile = x + pos0 * kE;
      for (int p = 0; p < npos; ++p) {
        const float v = x_tile[p * kE + e0];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const int row = f0 + 8 * k;
          const float u = stage[(row >> 4) * kColSlot + (row & (kE - 1)) * kCol + p];
          a_win[k] = fmaf(u, v, a_win[k]);
          a_bin[k] += u;
        }
      }
    }
    __syncthreads();
  }

  float* dst = partial + static_cast<long long>(blockIdx.x) * kParams;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = f0 + 8 * i;
    dst[W_FC2 + row * kE + e0] = a_fc2w[i];
    dst[W_FC1 + row * kE + e0] = a_fc1w[i];
    dst[W_OUT + row * kE + e0] = a_wout[i];
    if (e0 == 0) {
      dst[B_FC2 + row] = a_fc2b[i];
      dst[B_FC1 + row] = a_fc1b[i];
      dst[B_OUT + row] = a_bout[i];
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int row = f0 + 8 * k;
    dst[W_IN + row * kE + e0] = a_win[k];
    if (e0 == 0) dst[B_IN + row] = a_bin[k];
  }
  if (f0 == 0) dst[G2 + e0] = a_ln;
  if (f0 == 1) dst[H2 + e0] = a_ln;
  if (f0 == 2) dst[G1 + e0] = a_ln;
  if (f0 == 3) dst[H1 + e0] = a_ln;
}

// dprm[i] = sum over the blocks' partials, in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dprm, int nblocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kParams) return;
  float acc = 0.0f;
  for (int b = 0; b < nblocks; ++b) acc += partial[static_cast<long long>(b) * kParams + i];
  dprm[i] = acc;
}

}  // namespace

// o == nullptr selects the eval forward, which writes neither o nor stats.
extern "C" int nasrec_body_fwd(const float* x, const float* prm, float* out, float* o,
                               float* stats, long long batch, int S, int rpt,
                               int threads, float eps, void* stream) {
  if (bad_tile(S, rpt, threads)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long tiles = (batch + rpt - 1) / rpt;
  const int grid = static_cast<int>(tiles < kMaxBlocksFwd ? tiles : kMaxBlocksFwd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (o == nullptr) {
    body_fwd_kernel<false><<<grid, threads, kFwdSmem, st>>>(x, prm, out, nullptr, nullptr,
                                                            batch, S, rpt, eps);
  } else {
    body_fwd_kernel<true><<<grid, threads, kFwdSmem, st>>>(x, prm, out, o, stats, batch,
                                                           S, rpt, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// partial is scratch of [nblocks, 1696] floats; the grid is `nblocks` blocks of
// 128 threads, and equal (batch, S, rpt, nblocks) give equal bits.
extern "C" int nasrec_body_bwd(const float* x, const float* dout, const float* o,
                               const float* stats, const float* prm, float* dx,
                               float* partial, float* dprm, long long batch, int S,
                               int rpt, int nblocks, float eps, void* stream) {
  if (bad_tile(S, rpt, kMaxThreads) || nblocks < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      body_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  body_bwd_kernel<<<nblocks, kMaxThreads, kBwdSmem, st>>>(x, dout, o, stats, prm, dx,
                                                          partial, batch, S, rpt, eps);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  reduce_partials_kernel<<<(kParams + 255) / 256, 256, 0, st>>>(partial, dprm, nblocks);
  return static_cast<int>(cudaGetLastError());
}
