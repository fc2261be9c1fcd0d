// Fused body of the transformer node, forward and backward.
//
// Replaces the TPU kernel nasrec_tpu/ops/kernels/transformer_body_pallas.py ::
// transformer_body_fused (_fwd_kernel, _bwd_kernel).  Same function, laid out
// for this card: out, o and dout are batch-major [B, S, 16] (the flat
// slot-major [B, S*16] the blocks exchange, viewed without a copy); x and dx
// are either that or slot-minor [B, 16, S], as the slot projection before the
// body leaves its output, so that no transposed copy is made around the
// kernel; the statistics are [B, S, 8] (one lse2 a head, see tiny_attn.cuh);
// the twelve parameters come as one flat array in PyTorch's [out, in] layout:
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
// Bound: dispatched operations at S = 64 and 48 (about 72 S + 3,300 flops and
// 8 S exponentials a position against 128 to 320 bytes), closer to bytes at
// S = 16; the registers of one thread a position admit 8 warps a
// multiprocessor in the backward, so latency shows too.  Design: one thread
// per (batch row, slot) position with that position's values in registers, so
// the attention loops and both LayerNorms never leave the thread; only the keys
// and values of a batch row are shared.  The feature linears are products
// [32 positions x 16] . [16 x 16] of a warp and go to the tensor cores
// (lin16_mma below).  In the slot-minor layout a warp reads or writes feature e
// of 32 neighbouring slots at once, one coalesced line.
//
// Parameter gradients are sums over all positions of outer products
// dY^T [16 x positions] . X [positions x 16]: real matrix products, which go
// to the tensor cores.  A fixed grid of blocks walks the batch.  Each warp
// takes the products of its own 32 positions: its threads stage their factors
// column-wise, 36 floats a column (which makes every fragment load of
// mma.sync.m16n8k8 free of bank conflicts), in the rows that the warp owns of
// the attention's record arrays, which lie idle outside the sweeps; so a
// __syncwarp orders staging and products and no block barrier is spent on them.
// TF32 alone keeps three digits, so each operand is split into a high and a
// low TF32 part and a product is three mma (lo.hi, hi.lo, hi.hi), which keeps
// f32 accuracy (the term left out is 2^-22 of the product).  A bias gradient
// is the same product with a matrix of ones; the LayerNorm gradients are plain
// column sums.  Each warp's products of a tile start from zero and are added
// to the warp's running sums in shared memory by ordinary f32 adds; at the end
// the block adds its warps' sums in warp order and writes one partial; a
// second kernel sums the partials in block order.  No float atomics, so equal
// inputs give equal bits.

#include <cstdint>

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

constexpr int kMaxThreads = 128;         // positions of one tile, at most
constexpr int kMaxBlocksFwd = 132 * 16;
constexpr int kBwdBlocksPerSm = 2;       // what the backward's registers admit
constexpr int kRecArrays = 3;            // record arrays of the backward's attention sweeps
constexpr int kColLd = 36;               // a warp's staged column: 32 positions + 4
static_assert(kE * kColLd <= 32 * kLd, "a staged array must fit a warp's rows of a record array");

// The parameters that are not matrices, as the kernels keep them in shared
// memory: b_in, then b_out | g1 | h1, b_fc1, b_fc2 | g2 | h2.
constexpr int SB_IN = 0;
constexpr int SB_OUT = 48;
constexpr int SG1 = 64;
constexpr int SH1 = 80;
constexpr int SB_FC1 = 96;
constexpr int SB_FC2 = 112;
constexpr int SG2 = 128;
constexpr int SH2 = 144;
constexpr int kSmall = 160;

// The weights as the tensor cores take them (see split_weights).
constexpr int kWMats = 6;                  // q, k, v rows of W_in; W_out; W_fc1; W_fc2
constexpr int kWMat = kE * kLd;            // words of one split [16, 16] matrix
constexpr int kWSplit = 2 * kWMats * kWMat;   // hi arrays, then lo arrays

// A warp's running sums of the parameter gradients: six groups (fc2, fc1, out
// and the q, k and v rows of the input projection) of two mma fragments
// (weight columns 0-7 and 8-15, 128 floats each) and 16 bias sums, then the
// four LayerNorm gradients: 1696 floats, as many as there are parameters.
constexpr int kGroups = 6;
constexpr int kGroup = 2 * 128 + kE;
constexpr int kAccLn = kGroups * kGroup;
constexpr int kAccWarp = kAccLn + 4 * kE;
static_assert(kAccWarp == kParams, "one running sum a parameter");

// Forward: small parameters, split weights, keys, values, the warps' scratch rows.
inline size_t fwd_smem(int threads) {
  return (kSmall + kWSplit + 3 * threads * kLd) * sizeof(float);
}

// Backward: 72 KB at 128 threads.
inline size_t bwd_smem(int threads) {
  return (kSmall + kWSplit + threads / 32 * kAccWarp + kRecArrays * threads * kLd) *
         sizeof(float);
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

// x rounded to TF32's 10 mantissa bits, to nearest with ties away from zero
// (what cvt.rna.tf32.f32 gives), by an integer add and a mask: cvt shares its
// slow pipe with the exponentials, these do not.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as a high and a low TF32 part: x = hi + lo to within 2^-21 |x|.  The
// rest x - hi is exact and at most 2^-11 |x|; it is cut, not rounded, to 10
// bits, and since it falls on either side of zero the cut has no bias.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += A[16 x 8] B[8 x 8] on the tensor cores, TF32 in and f32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr uint32_t kOneTf32 = 0x3f800000u;

// The feature linears on the tensor cores.  A warp's 32 positions are two
// m16 tiles: Y[32 x 16] = X[32 x 16] W^T (or X W), 24 three-way-split mma
// against 256 FFMA and 64 shared loads a thread.  The price is a trip through
// shared memory between one-thread-one-position and the fragment layout: the
// lanes write their 16 values as records into 32 rows the warp owns, load
// them as A fragments, and read the product back from the same rows.  The
// weights are split once a block into hi and lo arrays, rows 20 words apart
// like a record, so that fragment loads of X, of W and (two-way at worst) of
// W^T spread over the banks.
constexpr int M_Q = 0, M_K = 1, M_V = 2, M_OUT = 3, M_FC1 = 4, M_FC2 = 5;

// prm's six [16, 16] matrices, split, into ws[hi | lo][matrix][f * kLd + e].
__device__ __forceinline__ void split_weights(const float* __restrict__ prm, uint32_t* ws) {
  for (int i = threadIdx.x; i < kWMats * kE * kE; i += blockDim.x) {
    const int m = i >> 8, fe = i & 255;
    const int src = m < 3 ? W_IN + i : m == 3 ? W_OUT + fe : m == 4 ? W_FC1 + fe : W_FC2 + fe;
    const int dst = m * kWMat + (fe >> 4) * kLd + (fe & 15);
    split_tf32(prm[src], ws[dst], ws[kWMats * kWMat + dst]);
  }
}

// The warp's 32 records as split A fragments: [m16 tile][k8 step][4].
struct AFrags {
  uint32_t hi[2][2][4], lo[2][2][4];
};

__device__ __forceinline__ void load_a_frags(const float* rows, int lane, AFrags& a) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* p = rows + (16 * m + g) * kLd + 8 * k + tig;
      split_tf32(p[0], a.hi[m][k][0], a.lo[m][k][0]);
      split_tf32(p[8 * kLd], a.hi[m][k][1], a.lo[m][k][1]);
      split_tf32(p[4], a.hi[m][k][2], a.lo[m][k][2]);
      split_tf32(p[8 * kLd + 4], a.hi[m][k][3], a.lo[m][k][3]);
    }
  }
}

// rows = X W^T + bias (kTrans false) or X W (kTrans true; bias may be null),
// for the warp's 32 positions: X as fragments, W as matrix `mat` of the split
// weights, the product written as records into `rows`.
template <bool kTrans>
__device__ __forceinline__ void warp_linear(const AFrags& a, const uint32_t* ws, int mat,
                                            const float* bias, float* rows, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t* whi = ws + mat * kWMat;
  const uint32_t* wlo = whi + kWMats * kWMat;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // B[k][n]: W[f = n][e = k], or transposed W[f = k][e = n].
      const int i0 = kTrans ? (8 * k + tig) * kLd + 8 * n + g : (8 * n + g) * kLd + 8 * k + tig;
      const int i1 = i0 + (kTrans ? 4 * kLd : 4);
      bh[k][0] = whi[i0];
      bh[k][1] = whi[i1];
      bl[k][0] = wlo[i0];
      bl[k][1] = wlo[i1];
    }
    const float b0 = bias ? bias[8 * n + 2 * tig] : 0.0f;
    const float b1 = bias ? bias[8 * n + 2 * tig + 1] : 0.0f;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float c[4] = {b0, b1, b0, b1};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        mma_tf32(c, a.lo[m][k], bh[k][0], bh[k][1]);
        mma_tf32(c, a.hi[m][k], bl[k][0], bl[k][1]);
        mma_tf32(c, a.hi[m][k], bh[k][0], bh[k][1]);
      }
      float* y = rows + (16 * m + g) * kLd + 8 * n + 2 * tig;
      *reinterpret_cast<float2*>(y) = make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(y + 8 * kLd) = make_float2(c[2], c[3]);
    }
  }
}

// y = W x + bias (or W^T x) for every lane's own 16 values, through the
// warp's scratch rows.  Every lane of the warp must call it.
template <bool kTrans>
__device__ __forceinline__ void lin16_mma(const uint32_t* ws, int mat, const float* bias,
                                          float* rows, int lane, const float (&x)[kE],
                                          float (&y)[kE]) {
  store16(rows + lane * kLd, x);
  __syncwarp();
  AFrags a;
  load_a_frags(rows, lane, a);
  __syncwarp();
  warp_linear<kTrans>(a, ws, mat, bias, rows, lane);
  __syncwarp();
  load16(rows + lane * kLd, y);
}

// q (scaled by kQScale) into registers, k and v as records into the warp's
// rows of the key and value arrays, from x through the warp's scratch rows.
__device__ __forceinline__ void project_qkv_mma(const uint32_t* ws, const float* sb,
                                                float* rows, float* krows, float* vrows,
                                                int lane, const float (&xv)[kE],
                                                float (&q2)[kE]) {
  store16(rows + lane * kLd, xv);
  __syncwarp();
  AFrags a;
  load_a_frags(rows, lane, a);
  __syncwarp();
  warp_linear<false>(a, ws, M_Q, sb + SB_IN, rows, lane);
  warp_linear<false>(a, ws, M_K, sb + SB_IN + kE, krows, lane);
  warp_linear<false>(a, ws, M_V, sb + SB_IN + 2 * kE, vrows, lane);
  __syncwarp();
  load16(rows + lane * kLd, q2);
#pragma unroll
  for (int e = 0; e < kE; ++e) q2[e] *= kQScale;
}

__device__ __forceinline__ void load_small_params(const float* __restrict__ prm, float* sb) {
  for (int i = threadIdx.x; i < kSmall; i += blockDim.x) {
    const int src = i < SB_OUT ? B_IN + i
                  : i < SB_FC1 ? B_OUT + i - SB_OUT
                  : i < SB_FC2 ? B_FC1 + i - SB_FC1 : B_FC2 + i - SB_FC2;
    sb[i] = prm[src];
  }
}

// The 16 features of slot s of batch row b, from [B, S, 16] or, slot-minor,
// from [B, 16, S].
__device__ __forceinline__ void load_x(const float* __restrict__ x, long long b, int s, int S,
                                       int slot_minor, float (&v)[kE]) {
  if (slot_minor) {
    const float* p = x + b * kE * S + s;
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = p[e * S];
  } else {
    load16(x + (b * S + s) * kE, v);
  }
}

__device__ __forceinline__ void store_x(float* __restrict__ x, long long b, int s, int S,
                                        int slot_minor, const float (&v)[kE]) {
  if (slot_minor) {
    float* p = x + b * kE * S + s;
#pragma unroll
    for (int e = 0; e < kE; ++e) p[e * S] = v[e];
  } else {
    store16(x + (b * S + s) * kE, v);
  }
}

template <bool kTrain>
__global__ void __launch_bounds__(kMaxThreads)
body_fwd_kernel(const float* __restrict__ x, const float* __restrict__ prm,
                float* __restrict__ out, float* __restrict__ o_out,
                float* __restrict__ stats_out, long long batch, int S, int rpt,
                int slot_minor, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  float* sb = smem;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + kSmall);
  float* sk = smem + kSmall + kWSplit;
  float* sv = sk + T * kLd;
  float* rows = sv + T * kLd + (t - lane) * kLd;   // the warp's scratch rows
  load_small_params(prm, sb);
  split_weights(prm, ws);
  __syncthreads();
  const int r = t / S;
  const int s = t - r * S;
  const int row0 = r * S * kLd;
  const long long tiles = (batch + rpt - 1) / rpt;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long b0 = tile * rpt;
    const int rows_here = static_cast<int>(min(static_cast<long long>(rpt), batch - b0));
    const bool active = r < rows_here;
    const long long pos = b0 * S + t;
    // A position outside the batch runs the linears on zeros with its warp
    // and loads and stores nothing.
    float xv[kE], q2[kE];
    if (active) {
      load_x(x, b0 + r, s, S, slot_minor, xv);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) xv[e] = 0.0f;
    }
    project_qkv_mma(ws, sb, rows, sk + (t - lane) * kLd, sv + (t - lane) * kLd, lane, xv, q2);
    __syncthreads();
    float ov[kE];
    if (active) {
      float lse2[kH];
      attn_fwd(q2, sk + row0, sv + row0, S, ov, lse2);
      if (kTrain) {
        store16(o_out + pos * kE, ov);
        float4* st = reinterpret_cast<float4*>(stats_out + pos * kH);
        st[0] = make_float4(lse2[0], lse2[1], lse2[2], lse2[3]);
        st[1] = make_float4(lse2[4], lse2[5], lse2[6], lse2[7]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) ov[e] = 0.0f;
    }
    float a[kE], x4[kE], xhat[kE], inv;
    lin16_mma<false>(ws, M_OUT, sb + SB_OUT, rows, lane, ov, a);
#pragma unroll
    for (int e = 0; e < kE; ++e) a[e] += xv[e];
    layer_norm(a, sb + SG1, sb + SH1, eps, x4, xhat, inv);
    float p1[kE], f[kE], y[kE];
    lin16_mma<false>(ws, M_FC1, sb + SB_FC1, rows, lane, x4, p1);
#pragma unroll
    for (int e = 0; e < kE; ++e) p1[e] = fmaxf(p1[e], 0.0f);
    lin16_mma<false>(ws, M_FC2, sb + SB_FC2, rows, lane, p1, f);
#pragma unroll
    for (int e = 0; e < kE; ++e) f[e] += x4[e];
    layer_norm(f, sb + SG2, sb + SH2, eps, y, xhat, inv);
    if (active) store16(out + pos * kE, y);
    __syncthreads();
  }
}

// Stage this lane's 16 values as column `lane` of the warp's [16][kColLd] array.
__device__ __forceinline__ void stage_col(float* arr, int lane, const float (&v)[kE]) {
#pragma unroll
  for (int c = 0; c < kE; ++c) arr[c * kColLd + lane] = v[c];
}

__device__ __forceinline__ void add_fragment(float* acc, int lane, const float (&c)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i * 32 + lane] += c[i];
}

// The 16 bias sums of a fragment whose every column holds the same sum: the
// lanes with tig = 0 hold rows g and g + 8.
__device__ __forceinline__ void add_bias_sums(float* acc, int lane, const float (&c)[4]) {
  if ((lane & 3) == 0) {
    acc[lane >> 2] += c[0];
    acc[(lane >> 2) + 8] += c[2];
  }
}

// One warp, after a __syncwarp: group acc += (dY^T X columns 0-7 | 8-15, dY^T 1)
// over the warp's 32 positions, from its staged arrays dy and xs.  Lane
// (g, tig) of an A fragment holds features g and g + 8 of positions tig and
// tig + 4 of a step of 8; each product is lo.hi, hi.lo, hi.hi.
__device__ __forceinline__ void warp_outer_products(const float* dy, const float* xs,
                                                    int lane, float* acc) {
  const int g = lane >> 2, tig = lane & 3;
  float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += 8) {
    uint32_t ah[4], al[4], bh[4], bl[4];
    split_tf32(dy[g * kColLd + k0 + tig], ah[0], al[0]);
    split_tf32(dy[(g + 8) * kColLd + k0 + tig], ah[1], al[1]);
    split_tf32(dy[g * kColLd + k0 + tig + 4], ah[2], al[2]);
    split_tf32(dy[(g + 8) * kColLd + k0 + tig + 4], ah[3], al[3]);
    split_tf32(xs[g * kColLd + k0 + tig], bh[0], bl[0]);
    split_tf32(xs[g * kColLd + k0 + tig + 4], bh[1], bl[1]);
    split_tf32(xs[(g + 8) * kColLd + k0 + tig], bh[2], bl[2]);
    split_tf32(xs[(g + 8) * kColLd + k0 + tig + 4], bh[3], bl[3]);
    mma_tf32(c0, al, bh[0], bh[1]);
    mma_tf32(c1, al, bh[2], bh[3]);
    mma_tf32(cs, al, kOneTf32, kOneTf32);
    mma_tf32(c0, ah, bl[0], bl[1]);
    mma_tf32(c1, ah, bl[2], bl[3]);
    mma_tf32(cs, ah, kOneTf32, kOneTf32);
    mma_tf32(c0, ah, bh[0], bh[1]);
    mma_tf32(c1, ah, bh[2], bh[3]);
  }
  add_fragment(acc, lane, c0);
  add_fragment(acc + 128, lane, c1);
  add_bias_sums(acc + 256, lane, cs);
}

// One warp, after a __syncwarp: acc[lane] += the sum over the warp's 32
// positions of column `lane` of two staged arrays, lanes 0-15 of `first` and
// lanes 16-31 of `second`.  Plain f32 adds: a sum needs no product.  Lane l
// starts at position l / 8 and wraps around, which spreads the 32 lanes' loads
// over the 32 banks (a column starts 4 banks after the one before it).
__device__ __forceinline__ void warp_column_sums(const float* first, const float* second,
                                                 int lane, float* acc) {
  const float* col = (lane < kE ? first : second) + (lane & (kE - 1)) * kColLd;
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sum += col[(j + (lane >> 3)) & 31];
  acc[lane] += sum;
}

// A [16, 16] weight gradient from its two accumulator fragments (columns
// 0-7 at acc, 8-15 at acc + 128): lane (g, tig) holds rows g and g + 8,
// columns 2 tig and 2 tig + 1.
__device__ __forceinline__ void write_weight(float* dst, const float* acc, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float* a = acc + n * 128;
    float* d = dst + 8 * n + 2 * tig;
    d[g * kE] = a[lane];
    d[g * kE + 1] = a[32 + lane];
    d[(g + 8) * kE] = a[64 + lane];
    d[(g + 8) * kE + 1] = a[96 + lane];
  }
}

__global__ void __launch_bounds__(kMaxThreads, kBwdBlocksPerSm)
body_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                const float* __restrict__ o_in, const float* __restrict__ stats,
                const float* __restrict__ prm, float* __restrict__ dx,
                float* __restrict__ partial, long long batch, int S, int rpt,
                int slot_minor, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  float* sb = smem;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + kSmall);
  float* acc_all = smem + kSmall + kWSplit;
  float* acc = acc_all + warp * kAccWarp;
  // Three record arrays: keys and values for the sweep over the keys, then
  // queries, output gradients and row records for the sweep over the queries.
  float* r0 = acc_all + T / 32 * kAccWarp;
  float* r1 = r0 + T * kLd;
  float* r2 = r0 + 2 * T * kLd;
  // In the rows this warp owns of each: its staged column arrays and the
  // scratch rows of its linears.
  float* st0 = r0 + (t - lane) * kLd;
  float* st1 = r1 + (t - lane) * kLd;
  float* st2 = r2 + (t - lane) * kLd;

  load_small_params(prm, sb);
  split_weights(prm, ws);
  for (int i = t; i < T / 32 * kAccWarp; i += T) acc_all[i] = 0.0f;
  __syncthreads();
  const int r = t / S;
  const int s = t - r * S;
  const int row0 = r * S * kLd;

  const long long tiles = (batch + rpt - 1) / rpt;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long b0 = tile * rpt;
    const int rows = static_cast<int>(min(static_cast<long long>(rpt), batch - b0));
    const bool active = r < rows;
    const long long pos = b0 * S + t;

    // The chain after the attention, forward again and then backward, with
    // the parameter gradients as their factors appear.  A position outside
    // the batch runs it on zeros: its dy = 0 makes every gradient factor
    // zero, so it adds nothing to any sum.
    float dr1[kE], dov[kE], rec[kE];
    {
      float xv[kE], ov[kE], dy[kE];
      if (active) {
        load_x(x, b0 + r, s, S, slot_minor, xv);
        load16(o_in + pos * kE, ov);
        load16(dout + pos * kE, dy);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) xv[e] = ov[e] = dy[e] = 0.0f;
      }
      float a[kE], x4[kE], xh1[kE], inv1;
      lin16_mma<false>(ws, M_OUT, sb + SB_OUT, st0, lane, ov, a);
#pragma unroll
      for (int e = 0; e < kE; ++e) a[e] += xv[e];
      layer_norm(a, sb + SG1, sb + SH1, eps, x4, xh1, inv1);
      float p1[kE], hr[kE], f[kE], y[kE], xh2[kE], inv2;
      lin16_mma<false>(ws, M_FC1, sb + SB_FC1, st0, lane, x4, p1);
#pragma unroll
      for (int e = 0; e < kE; ++e) hr[e] = fmaxf(p1[e], 0.0f);
      lin16_mma<false>(ws, M_FC2, sb + SB_FC2, st0, lane, hr, f);
#pragma unroll
      for (int e = 0; e < kE; ++e) f[e] += x4[e];
      layer_norm(f, sb + SG2, sb + SH2, eps, y, xh2, inv2);

      // fc2 and the FFN LayerNorm.
      float dr2[kE], tmp[kE];
      layer_norm_bwd(dy, xh2, inv2, sb + SG2, dr2);
      __syncwarp();
      stage_col(st0, lane, dr2);
      stage_col(st1, lane, hr);
      __syncwarp();
      warp_outer_products(st0, st1, lane, acc);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kE; ++e) tmp[e] = dy[e] * xh2[e];
      stage_col(st0, lane, tmp);
      stage_col(st1, lane, dy);
      __syncwarp();
      warp_column_sums(st0, st1, lane, acc + kAccLn);
      __syncwarp();

      // fc1 and the attention LayerNorm.
      float dp1[kE], dx4[kE];
      lin16_mma<true>(ws, M_FC2, nullptr, st0, lane, dr2, dp1);
#pragma unroll
      for (int e = 0; e < kE; ++e) dp1[e] = p1[e] > 0.0f ? dp1[e] : 0.0f;
      lin16_mma<true>(ws, M_FC1, nullptr, st0, lane, dp1, dx4);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        dx4[e] += dr2[e];
        tmp[e] = dx4[e] * xh1[e];
      }
      __syncwarp();
      stage_col(st0, lane, dp1);
      stage_col(st1, lane, x4);
      __syncwarp();
      warp_outer_products(st0, st1, lane, acc + kGroup);
      __syncwarp();
      stage_col(st0, lane, tmp);
      stage_col(st1, lane, dx4);
      __syncwarp();
      warp_column_sums(st0, st1, lane, acc + kAccLn + 2 * kE);
      __syncwarp();

      // The out-projection, and the attention's output gradient and row record.
      layer_norm_bwd(dx4, xh1, inv1, sb + SG1, dr1);
      stage_col(st0, lane, dr1);
      stage_col(st1, lane, ov);
      __syncwarp();
      warp_outer_products(st0, st1, lane, acc + 2 * kGroup);
      __syncwarp();
      lin16_mma<true>(ws, M_OUT, nullptr, st0, lane, dr1, dov);
      float lse2[kH];
      if (active) {
        const float4* st = reinterpret_cast<const float4*>(stats + pos * kH);
        const float4 s0 = st[0], s1 = st[1];
        lse2[0] = s0.x; lse2[1] = s0.y; lse2[2] = s0.z; lse2[3] = s0.w;
        lse2[4] = s1.x; lse2[5] = s1.y; lse2[6] = s1.z; lse2[7] = s1.w;
      } else {
#pragma unroll
        for (int h = 0; h < kH; ++h) lse2[h] = 0.0f;
      }
      attn_row_record(dov, ov, lse2, rec);
    }

    // Attention backward from the saved statistics: keys and values into
    // r0 and r1, the sweep over the keys for dq; then queries, output
    // gradients and row records into r0, r1 and r2, the sweep over the
    // queries for dk and dv.
    float q2[kE], xv[kE];
    if (active) {
      load_x(x, b0 + r, s, S, slot_minor, xv);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) xv[e] = 0.0f;
    }
    __syncwarp();
    project_qkv_mma(ws, sb, st2, st0, st1, lane, xv, q2);
    __syncthreads();
    float dq[kE], dk[kE], dv[kE], kj[kE], vj[kE];
    if (active) {
      attn_bwd_dq(q2, dov, rec, r0 + row0, r1 + row0, S, dq);
      load16(r0 + t * kLd, kj);
      load16(r1 + t * kLd, vj);
    }
    __syncthreads();    // every thread has read the keys and values
    if (active) {
      store16(r0 + t * kLd, q2);
      store16(r1 + t * kLd, dov);
      store16(r2 + t * kLd, rec);
    }
    __syncthreads();
    if (active) {
      attn_bwd_dkv(kj, vj, r0 + row0, r1 + row0, r2 + row0, S, dk, dv);
      load_x(x, b0 + r, s, S, slot_minor, xv);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) dq[e] = dk[e] = dv[e] = 0.0f;
    }
    __syncthreads();    // every sweep has read the records: the rows are free

    // The input projection: rows 0-15 of [48, 16] from dq, then dk, then dv.
    stage_col(st2, lane, xv);
    stage_col(st0, lane, dq);
    stage_col(st1, lane, dk);
    __syncwarp();
    warp_outer_products(st0, st2, lane, acc + 3 * kGroup);
    warp_outer_products(st1, st2, lane, acc + 4 * kGroup);
    __syncwarp();
    stage_col(st0, lane, dv);
    __syncwarp();
    warp_outer_products(st0, st2, lane, acc + 5 * kGroup);
    __syncwarp();
    {
      float part[kE];
      lin16_mma<true>(ws, M_Q, nullptr, st0, lane, dq, part);
#pragma unroll
      for (int e = 0; e < kE; ++e) dr1[e] += part[e];
      lin16_mma<true>(ws, M_K, nullptr, st0, lane, dk, part);
#pragma unroll
      for (int e = 0; e < kE; ++e) dr1[e] += part[e];
      lin16_mma<true>(ws, M_V, nullptr, st0, lane, dv, part);
#pragma unroll
      for (int e = 0; e < kE; ++e) dr1[e] += part[e];
    }
    if (active) store_x(dx, b0 + r, s, S, slot_minor, dr1);
    __syncwarp();
  }

  // The block's sums: its warps' sums added in warp order, then written out
  // of their fragments into the parameters' layout.
  __syncthreads();
  for (int i = t; i < kAccWarp; i += T) {
    float sum = acc_all[i];
    for (int w = 1; w < T / 32; ++w) sum += acc_all[w * kAccWarp + i];
    acc_all[i] = sum;
  }
  __syncthreads();
  float* dst = partial + static_cast<long long>(blockIdx.x) * kParams;
  for (int grp = warp; grp < kGroups; grp += T / 32) {
    const int w_off = grp == 0 ? W_FC2 : grp == 1 ? W_FC1 : grp == 2 ? W_OUT
                                                                     : W_IN + (grp - 3) * kE * kE;
    const int b_off = grp == 0 ? B_FC2 : grp == 1 ? B_FC1 : grp == 2 ? B_OUT
                                                                     : B_IN + (grp - 3) * kE;
    write_weight(dst + w_off, acc_all + grp * kGroup, lane);
    if (lane < kE) dst[b_off + lane] = acc_all[grp * kGroup + 256 + lane];
  }
  if (warp == 0) {
    // G2 and H2 are neighbours in the parameter array, and so are G1 and H1.
    dst[G2 + lane] = acc_all[kAccLn + lane];
    dst[G1 + lane] = acc_all[kAccLn + 2 * kE + lane];
  }
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
// slot_minor: x is [B, 16, S], not [B, S, 16].
extern "C" int nasrec_body_fwd(const float* x, const float* prm, float* out, float* o,
                               float* stats, long long batch, int S, int rpt,
                               int threads, int slot_minor, float eps, void* stream) {
  if (bad_tile(S, rpt, threads, kMaxThreads)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long tiles = (batch + rpt - 1) / rpt;
  const int grid = static_cast<int>(tiles < kMaxBlocksFwd ? tiles : kMaxBlocksFwd);
  const size_t smem = fwd_smem(threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaFuncSetAttribute(
      o == nullptr ? body_fwd_kernel<false> : body_fwd_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (o == nullptr) {
    body_fwd_kernel<false><<<grid, threads, smem, st>>>(x, prm, out, nullptr, nullptr, batch,
                                                        S, rpt, slot_minor, eps);
  } else {
    body_fwd_kernel<true><<<grid, threads, smem, st>>>(x, prm, out, o, stats, batch, S, rpt,
                                                       slot_minor, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// partial is scratch of [nblocks, 1696] floats; the grid is `nblocks` blocks of
// `threads` threads (two blocks of 128 fit a multiprocessor), and equal
// (batch, S, rpt, threads, nblocks) give equal bits.  slot_minor: x
// and dx are [B, 16, S], not [B, S, 16].
extern "C" int nasrec_body_bwd(const float* x, const float* dout, const float* o,
                               const float* stats, const float* prm, float* dx,
                               float* partial, float* dprm, long long batch, int S,
                               int rpt, int threads, int nblocks, int slot_minor, float eps,
                               void* stream) {
  if (bad_tile(S, rpt, threads, kMaxThreads) || nblocks < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(threads);
  const cudaError_t rc = cudaFuncSetAttribute(
      body_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  body_bwd_kernel<<<nblocks, threads, smem, st>>>(x, dout, o, stats, prm, dx, partial, batch,
                                                  S, rpt, slot_minor, eps);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  reduce_partials_kernel<<<(kParams + 255) / 256, 256, 0, st>>>(partial, dprm, nblocks);
  return static_cast<int>(cudaGetLastError());
}
