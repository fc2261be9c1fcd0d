// Pairwise dot-product scores of the DotProduct node, forward and backward.
//
// Replaces the TPU kernel nasrec_tpu/ops/kernels/dotprod_pallas.py ::
// dot_scores_tril_bmajor (_fwd_kernel, _bwd_kernel).  Same function, with the
// operands in the layout the node holds them: the projected dense row
// x[B, 16] and the projected slots yt[B, 16, m] (feature-major, slot-minor).
// With t[b, 0, e] = x[b, e], t[b, 1 + k, e] = yt[b, e, k] and n = m + 1:
//
//   forward   z[b, p(i,j)] = sum_e t[b,i,e] * t[b,j,e]             (j < i)
//   backward  dt[b,i,e]    = sum_{j != i} dz[b, p(max(i,j), min(i,j))] * t[b,j,e]
//             dx = dt[:, 0, :],  dyt[b, e, k] = dt[b, 1 + k, e]
//
// p(i, j) = i(i-1)/2 + j: z[B, P], P = n(n-1)/2, is the row-major strict lower
// triangle, which the out-projection consumes.  No [B, n, 16] tensor and no
// symmetric [n, n] matrix is ever formed, in device memory or in shared.
//
// Bound: bytes.  A batch row reads 64n bytes and writes 4P forward (n = 46:
// 2.9 KB in, 4.1 KB out, 33 K flops), far under the card's flop/byte balance;
// the first version was held back by its shared-memory loads (32 scalar loads
// for 16 FFMA), not by memory.  Design:
//
//   operand   a tile of `tb` batch rows lies in shared memory feature-major,
//             st[r][e][c] with c = 0 the dense row and c = 1 + k slot k, at a
//             stride `ld` between features that is a multiple of 4, so a
//             thread reads 4 neighbouring t[i..i+3][e] in one 16-byte load.
//             Batch rows lie 4 mod 32 floats apart, so lanes on different
//             batch rows read different banks.
//   copies    the next tile arrives by cp.async into a second buffer while
//             the block computes this one: 4-byte pieces for x and yt, which
//             the padded layout needs (a feature's run of m floats starts on
//             no 16-byte boundary when m is odd; staging yt as it lies in
//             16-byte pieces and reading it with scalar loads was slower),
//             16-byte pieces for dz, at its own offset from a 16-byte
//             boundary (a row of dz is 4P bytes).  Two barriers a tile.
//   forward   a thread owns a 4 x 4 block of the triangle from a table of
//             (i0, j0) built once for n on the host; per feature it loads
//             4 + 4 values for 16 FFMA.  Entries with j >= i or i >= n are
//             masked when the block is written.  (Blocks of 8 x 4 and 8 x 8
//             took the same time and were taken out.)
//   backward  a thread owns rows i0..i0+3 of dt with TE of the 16 features in
//             registers, and takes the operand rows j four at a time (one
//             16-byte load a feature), so one dz value meets TE FFMA and one
//             load 4 TE; it walks the triangle incrementally: dz[base(i) + j]
//             for j < i0, the 4 x 4 diagonal block, then dz[base(j) + i],
//             base(j + 1) = base(j) + j.  Tasks are ordered (block of rows,
//             batch row, features), so the lanes of a warp run loops of
//             nearly the same lengths.
//   stores    z, dx and dyt of a tile are contiguous in device memory: they
//             are staged in shared memory at the same offset from a 16-byte
//             boundary as their destination and stored 16 bytes a thread.
//
// bf16 (the JAX kernel emits its input's dtype and sums in f32): the same
// kernels take x, yt and dz in bf16 and write z, dx and dyt in bf16, each
// element rounded once from the f32 sum.  Shared memory holds the same f32
// tiles; a bf16 operand is converted as it is staged, by 16-byte loads of 8
// values (a batch row of x is 32 bytes and of yt 32 m bytes, so every tile
// starts on a 16-byte boundary) into registers and plain shared stores, and
// dz row tiles, whose start falls on any 2-byte boundary, by scalar loads to
// the first 16-byte boundary and 16-byte loads after it.  Those loads do not
// overlap the computation as cp.async does in f32: the simple form, left to
// a later change.  Outputs leave as in f32, 8 values a 16-byte store.
//
// The sums run in a fixed order, so equal inputs give equal bits.  What holds
// the kernels now (tools/dotprod_split.py): the shared-memory loads of the
// loops, the 4-byte cp.async, the staged writes and the 16-byte stores all go
// through the multiprocessor's one load-store pipe, and their times add up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kE = 16;
constexpr int kMaxThreads = 256;
constexpr int kBlock = 4;  // the forward's register block: kBlock x kBlock pairs
constexpr int kPad = 8;    // floats behind a staged tile that a masked lane may read

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

using bf16 = __nv_bfloat16;

// Elements of a 16-byte piece.
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// Elements between p and the 16-byte boundary below it.
template <typename T>
__device__ __forceinline__ int phase16(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (vec_elems<T>() - 1));
}

// 8 bf16 values of one 16-byte load, as floats.
__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 floats as bf16 (each rounded to nearest even), packed for one 16-byte store.
__device__ __forceinline__ uint4 pack8(const float4& a, const float4& b) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return raw;
}

// Four floats from a 16-byte boundary of shared memory, in one load.
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

__host__ __device__ constexpr int round_up(int v, int to) { return (v + to - 1) / to * to; }

// x[rows, 16] and yt[rows, 16, m] of a tile -> st[r][e][c] (stride rs between
// batch rows, ld between features), asynchronously.  magic = ceil(2^32 / m)
// turns the division by m into one multiply (exact for idx < 2^32 / m); 0
// stands for m = 1.
__device__ __forceinline__ void stage_operand(float* st, const float* __restrict__ x,
                                              const float* __restrict__ yt, int rows, int m,
                                              int ld, int rs, unsigned magic) {
  const int total = rows * kE * m;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int q = magic ? static_cast<int>(__umulhi(static_cast<unsigned>(idx), magic)) : idx;
    const int k = idx - q * m;  // q = (r, e) flattened
    cp_async4(st + (q >> 4) * rs + (q & (kE - 1)) * ld + 1 + k, yt + idx);
  }
  for (int idx = threadIdx.x; idx < rows * kE; idx += blockDim.x)
    cp_async4(st + (idx >> 4) * rs + (idx & (kE - 1)) * ld, x + idx);
}

// The same from bf16, converted: 8 values a thread from one 16-byte load
// (x and yt tiles start on 16-byte boundaries and hold a multiple of 16
// values), written to shared memory before this returns.
__device__ __forceinline__ void stage_operand(float* st, const bf16* __restrict__ x,
                                              const bf16* __restrict__ yt, int rows, int m,
                                              int ld, int rs, unsigned magic) {
  const int nvec = rows * kE * m / 8;
  const uint4* yv = reinterpret_cast<const uint4*>(yt);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float val[8];
    unpack8(yv[v], val);
    const int idx = 8 * v;
    int q = magic ? static_cast<int>(__umulhi(static_cast<unsigned>(idx), magic)) : idx;
    int k = idx - q * m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      st[(q >> 4) * rs + (q & (kE - 1)) * ld + 1 + k] = val[i];
      if (++k == m) k = 0, ++q;
    }
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int v = threadIdx.x; v < rows * kE / 8; v += blockDim.x) {
    float val[8];
    unpack8(xv[v], val);
    float* dst = st + (v >> 1) * rs + 8 * (v & 1) * ld;
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i * ld] = val[i];
  }
}

// `count` contiguous floats, asynchronously; dst and src lie at the same
// offset from a 16-byte boundary, so all but a head and a tail of at most 3
// floats each go in 16-byte pieces.
__device__ __forceinline__ void stage_elems(float* dst, const float* __restrict__ src,
                                            int count) {
  const int head = min(count, (4 - phase16(src)) & 3);
  const int nvec = (count - head) >> 2;
  for (int k = threadIdx.x; k < nvec; k += blockDim.x)
    cp_async16(dst + head + 4 * k, src + head + 4 * k);
  const int rest = count - 4 * nvec;
  for (int k = threadIdx.x; k < rest; k += blockDim.x) {
    const int idx = k < head ? k : 4 * nvec + k;
    cp_async4(dst + idx, src + idx);
  }
}

// `count` contiguous bf16 values as floats, written before this returns.  dst
// lies phase16(src) floats past a 16-byte boundary of shared memory, so the
// values after src's head of at most 7 go 8 at a time: one 16-byte load, two
// 16-byte shared stores.
__device__ __forceinline__ void stage_elems(float* dst, const bf16* __restrict__ src,
                                            int count) {
  const int head = min(count, (vec_elems<bf16>() - phase16(src)) & (vec_elems<bf16>() - 1));
  const int nvec = (count - head) >> 3;
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  for (int k = threadIdx.x; k < nvec; k += blockDim.x) {
    float val[8];
    unpack8(sv[k], val);
    float4* d = reinterpret_cast<float4*>(dst + head + 8 * k);
    d[0] = make_float4(val[0], val[1], val[2], val[3]);
    d[1] = make_float4(val[4], val[5], val[6], val[7]);
  }
  const int rest = count - 8 * nvec;
  for (int k = threadIdx.x; k < rest; k += blockDim.x) {
    const int idx = k < head ? k : 8 * nvec + k;
    dst[idx] = __bfloat162float(src[idx]);
  }
}

// The same from shared memory to device memory, 16 bytes a thread.
__device__ __forceinline__ void store_elems(float* __restrict__ dst, const float* src,
                                            int count) {
  const int head = min(count, (4 - phase16(dst)) & 3);
  const int nvec = (count - head) >> 2;
  float4* dv = reinterpret_cast<float4*>(dst + head);
  const float4* sv = reinterpret_cast<const float4*>(src + head);
  for (int k = threadIdx.x; k < nvec; k += blockDim.x) dv[k] = sv[k];
  const int rest = count - 4 * nvec;
  for (int k = threadIdx.x; k < rest; k += blockDim.x) {
    const int idx = k < head ? k : 4 * nvec + k;
    dst[idx] = src[idx];
  }
}

// Staged floats to bf16, each rounded once; src lies phase16(dst) floats past a
// 16-byte boundary, so 8 values go as two 16-byte loads and one 16-byte store.
__device__ __forceinline__ void store_elems(bf16* __restrict__ dst, const float* src,
                                            int count) {
  const int head = min(count, (vec_elems<bf16>() - phase16(dst)) & (vec_elems<bf16>() - 1));
  const int nvec = (count - head) >> 3;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const float4* sv = reinterpret_cast<const float4*>(src + head);
  for (int k = threadIdx.x; k < nvec; k += blockDim.x) dv[k] = pack8(sv[2 * k], sv[2 * k + 1]);
  const int rest = count - 8 * nvec;
  for (int k = threadIdx.x; k < rest; k += blockDim.x) {
    const int idx = k < head ? k : 8 * nvec + k;
    dst[idx] = __float2bfloat16(src[idx]);
  }
}

struct Shape {
  long long batch;
  int n;        // operand rows: the dense row and m = n - 1 slots
  int tb;       // batch rows a tile
  int ld;       // floats between the features of a staged batch row
  int rs;       // floats between staged batch rows: 16 * ld + 4
  unsigned magic;
};

// Shared memory, in floats (each a multiple of 4, so every buffer starts on a
// 16-byte boundary).  kPad: what a masked lane may read past its tile.  A
// staged array of T starts up to vec_elems<T>() - 1 floats into its buffer.
__host__ __device__ inline int operand_floats(int tb, int rs) { return tb * rs + kPad; }
template <typename T>
__host__ __device__ inline int staged_floats(int count) {
  return round_up(count + vec_elems<T>() - 1, 4) + kPad;
}

// First batch row and row count of tile `tile`.
struct Tile {
  long long b0;
  int rows;
};
__device__ __forceinline__ Tile tile_at(long long tile, const Shape& s) {
  const long long b0 = tile * s.tb;
  return Tile{b0, static_cast<int>(min(static_cast<long long>(s.tb), s.batch - b0))};
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dot_fwd_kernel(const T* __restrict__ x, const T* __restrict__ yt, T* __restrict__ z,
               const int* __restrict__ tiles, int ntiles, Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int n = s.n, m = n - 1, P = n * (n - 1) / 2, tb = s.tb, ld = s.ld, rs = s.rs;
  float* st[2] = {smem, smem + operand_floats(tb, rs)};
  float* sz = st[1] + operand_floats(tb, rs);
  int* stile = reinterpret_cast<int*>(sz + staged_floats<T>(tb * P));
  for (int k = threadIdx.x; k < 2 * ntiles; k += blockDim.x) stile[k] = tiles[k];

  const long long ntile_b = (s.batch + tb - 1) / tb;
  long long tile = blockIdx.x;
  if (tile < ntile_b) {
    const Tile t = tile_at(tile, s);
    stage_operand(st[0], x + t.b0 * kE, yt + t.b0 * kE * m, t.rows, m, ld, rs, s.magic);
  }
  cp_async_commit();
  for (int cur = 0; tile < ntile_b; tile += gridDim.x, cur ^= 1) {
    const Tile t = tile_at(tile, s);
    if (tile + gridDim.x < ntile_b) {
      const Tile nt = tile_at(tile + gridDim.x, s);
      stage_operand(st[cur ^ 1], x + nt.b0 * kE, yt + nt.b0 * kE * m, nt.rows, m, ld, rs,
                    s.magic);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has arrived; the next may still be in flight
    __syncthreads();

    T* zdst = z + t.b0 * P;
    float* zs = sz + phase16(zdst);
    const int ntask = t.rows * ntiles;
    for (int task = threadIdx.x; task < ntask; task += blockDim.x) {
      const int r = task / ntiles;
      const int tl = task - r * ntiles;
      const int i0 = stile[2 * tl], j0 = stile[2 * tl + 1];
      const float* ti = st[cur] + r * rs + i0;
      const float* tj = st[cur] + r * rs + j0;
      float acc[kBlock][kBlock];
#pragma unroll
      for (int a = 0; a < kBlock; ++a)
#pragma unroll
        for (int b = 0; b < kBlock; ++b) acc[a][b] = 0.0f;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        float va[kBlock], vb[kBlock];
#pragma unroll
        for (int a = 0; a < kBlock; a += 4) {
          const float4 q = load4(ti + e * ld + a);
          va[a] = q.x, va[a + 1] = q.y, va[a + 2] = q.z, va[a + 3] = q.w;
        }
#pragma unroll
        for (int b = 0; b < kBlock; b += 4) {
          const float4 q = load4(tj + e * ld + b);
          vb[b] = q.x, vb[b + 1] = q.y, vb[b + 2] = q.z, vb[b + 3] = q.w;
        }
#pragma unroll
        for (int a = 0; a < kBlock; ++a)
#pragma unroll
          for (int b = 0; b < kBlock; ++b) acc[a][b] = fmaf(va[a], vb[b], acc[a][b]);
      }
      float* zr = zs + r * P;
#pragma unroll
      for (int a = 0; a < kBlock; ++a) {
        const int i = i0 + a;
        if (i < n) {
          const int base = i * (i - 1) / 2;
#pragma unroll
          for (int b = 0; b < kBlock; ++b)
            if (j0 + b < i) zr[base + j0 + b] = acc[a][b];
        }
      }
    }
    __syncthreads();
    store_elems(zdst, zs, t.rows * P);
  }
  cp_async_wait<0>();
}

template <int TE>
__device__ __forceinline__ void add_row(float (&acc)[TE], float d, const float (&t)[TE]) {
#pragma unroll
  for (int y = 0; y < TE; ++y) acc[y] = fmaf(d, t[y], acc[y]);
}

template <typename T, int TE>
__global__ void __launch_bounds__(kMaxThreads)
dot_bwd_kernel(const T* __restrict__ x, const T* __restrict__ yt,
               const T* __restrict__ dz, T* __restrict__ dx,
               T* __restrict__ dyt, Shape s) {
  constexpr int NEB = kE / TE;  // a thread holds features eb, eb + NEB, eb + 2 NEB, ...
  extern __shared__ __align__(16) float smem[];
  const int n = s.n, m = n - 1, P = n * (n - 1) / 2, tb = s.tb, ld = s.ld, rs = s.rs;
  float* st[2] = {smem, smem + operand_floats(tb, rs)};
  float* sdz[2] = {st[1] + operand_floats(tb, rs),
                   st[1] + operand_floats(tb, rs) + staged_floats<T>(tb * P)};
  float* sdy = sdz[1] + staged_floats<T>(tb * P);
  float* sdx = sdy + staged_floats<T>(tb * kE * m);

  const long long ntile_b = (s.batch + tb - 1) / tb;
  long long tile = blockIdx.x;
  if (tile < ntile_b) {
    const Tile t = tile_at(tile, s);
    stage_operand(st[0], x + t.b0 * kE, yt + t.b0 * kE * m, t.rows, m, ld, rs, s.magic);
    stage_elems(sdz[0] + phase16(dz + t.b0 * P), dz + t.b0 * P, t.rows * P);
  }
  cp_async_commit();
  const int nib = (n + 3) >> 2;  // blocks of 4 rows i
  for (int cur = 0; tile < ntile_b; tile += gridDim.x, cur ^= 1) {
    const Tile t = tile_at(tile, s);
    if (tile + gridDim.x < ntile_b) {
      const Tile nt = tile_at(tile + gridDim.x, s);
      stage_operand(st[cur ^ 1], x + nt.b0 * kE, yt + nt.b0 * kE * m, nt.rows, m, ld, rs,
                    s.magic);
      stage_elems(sdz[cur ^ 1] + phase16(dz + nt.b0 * P), dz + nt.b0 * P, nt.rows * P);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    T* ydst = dyt + t.b0 * kE * m;
    T* xdst = dx + t.b0 * kE;
    float* ys = sdy + phase16(ydst);
    float* xs = sdx + phase16(xdst);
    const float* zb = sdz[cur] + phase16(dz + t.b0 * P);
    // Tasks in the order (block of rows i, batch row, features): the lanes of
    // a warp hold neighbouring blocks, so their loops below and above the block
    // have nearly the same lengths; lanes of one batch row and feature set
    // read the same operand address, lanes of different batch rows other banks.
    const int per_ib = t.rows * NEB;
    const int ntask = nib * per_ib;
    for (int task = threadIdx.x; task < ntask; task += blockDim.x) {
      const int ib = task / per_ib;
      const int rem = task - ib * per_ib;
      const int r = rem / NEB, eb = rem % NEB;
      const int i0 = ib * 4;
      const float* tr = st[cur] + r * rs + eb * ld;  // feature eb + NEB * y at tr + y * NEB * ld
      const float* zr = zb + r * P;
      float acc[4][TE], tv[4][TE];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int y = 0; y < TE; ++y) acc[a][y] = 0.0f;
      // Operand rows jb..jb+3 of this thread's features, one 16-byte load each.
      auto load_rows = [&](int jb) {
#pragma unroll
        for (int y = 0; y < TE; ++y) {
          const float4 q = load4(tr + y * NEB * ld + jb);
          tv[0][y] = q.x, tv[1][y] = q.y, tv[2][y] = q.z, tv[3][y] = q.w;
        }
      };
      // Rows past the operand's end take row n - 1's addresses; they are not written.
      int base[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = min(i0 + a, n - 1);
        base[a] = i * (i - 1) / 2;
      }
      // j below the block: dz[p(i, j)] = dz[base(i) + j].
#pragma unroll 1
      for (int jb = 0; jb < i0; jb += 4) {
        load_rows(jb);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int a = 0; a < 4; ++a) add_row(acc[a], zr[base[a] + jb + jj], tv[jj]);
      }
      // j inside the block: the pair's larger index names the row of dz.
      load_rows(i0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = i0 + jj;
        if (j < n) {
          const int bj = j * (j - 1) / 2;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            if (a == jj) continue;
            add_row(acc[a], a < jj ? zr[bj + i0 + a] : zr[base[a] + j], tv[jj]);
          }
        }
      }
      // j above the block: dz[p(j, i)] = dz[base(j) + i], base(j + 1) = base(j) + j.
      // The columns of the last four past n - 1 hold no operand and are skipped.
      int bj = (i0 + 4) * (i0 + 3) / 2 + i0;
#pragma unroll 1
      for (int jb = i0 + 4; jb < n; jb += 4) {
        load_rows(jb);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = jb + jj;
          if (j < n) {
#pragma unroll
            for (int a = 0; a < 4; ++a) add_row(acc[a], zr[bj + a], tv[jj]);
            bj += j;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + a;
        if (i >= n) continue;
#pragma unroll
        for (int y = 0; y < TE; ++y) {
          const int e = eb + NEB * y;
          if (i == 0) xs[r * kE + e] = acc[a][y];
          else ys[(r * kE + e) * m + i - 1] = acc[a][y];
        }
      }
    }
    __syncthreads();
    store_elems(ydst, ys, t.rows * kE * m);
    store_elems(xdst, xs, t.rows * kE);
  }
  cp_async_wait<0>();
}

// Persistent blocks: as many as fit the card at once, or one a tile if fewer.
// What fits is asked of the runtime once for a launch shape and kept (one
// entry for each kernel instance: a node launches the same shape every step).
struct GridCache {
  int device = -1, threads = 0, fit = 0;
  size_t smem = 0;
};

template <typename Kernel>
int launch_grid(Kernel kernel, int threads, size_t smem, long long tiles, GridCache* cache,
                int* grid) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (cache->device != dev || cache->threads != threads || cache->smem != smem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *cache = GridCache{dev, threads, per_sm * sms, smem};
  }
  *grid = static_cast<int>(tiles < cache->fit ? tiles : cache->fit);
  return 0;
}

// `ld` is a multiple of 4 and batch rows lie 16 * ld + 4 floats apart: 16-byte
// loads, and rows in different banks.
Shape make_shape(long long batch, int n, int tb) {
  const int m = n - 1, ld = round_up(n, 4);
  const unsigned magic =
      m == 1 ? 0u : static_cast<unsigned>(((1ull << 32) + m - 1) / static_cast<unsigned>(m));
  return Shape{batch, n, tb, ld, kE * ld + 4, magic};
}

bool bad_launch(long long batch, int n, int tb, int threads) {
  return batch < 0 || n < 2 || tb < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0;
}

template <typename T>
int launch_fwd(const T* x, const T* yt, T* z, const int* tiles, int ntiles,
               const Shape& s, int threads, cudaStream_t stream) {
  const int P = s.n * (s.n - 1) / 2;
  const size_t smem = sizeof(float) * (2 * operand_floats(s.tb, s.rs)
                                       + staged_floats<T>(s.tb * P))
                      + sizeof(int) * 2 * ntiles;
  static GridCache cache;
  int grid = 0;
  const int rc = launch_grid(dot_fwd_kernel<T>, threads, smem,
                             (s.batch + s.tb - 1) / s.tb, &cache, &grid);
  if (rc != 0) return rc;
  dot_fwd_kernel<T><<<grid, threads, smem, stream>>>(x, yt, z, tiles, ntiles, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TE>
int launch_bwd(const T* x, const T* yt, const T* dz, T* dx, T* dyt,
               const Shape& s, int threads, cudaStream_t stream) {
  const int m = s.n - 1, P = s.n * m / 2;
  const size_t smem = sizeof(float) * (2 * operand_floats(s.tb, s.rs)
                                       + 2 * staged_floats<T>(s.tb * P)
                                       + staged_floats<T>(s.tb * kE * m)
                                       + staged_floats<T>(s.tb * kE));
  static GridCache cache;
  int grid = 0;
  const int rc = launch_grid(dot_bwd_kernel<T, TE>, threads, smem,
                             (s.batch + s.tb - 1) / s.tb, &cache, &grid);
  if (rc != 0) return rc;
  dot_bwd_kernel<T, TE><<<grid, threads, smem, stream>>>(x, yt, dz, dx, dyt, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dotprod_fwd(const T* x, const T* yt, T* z, const int* tiles, int ntiles, long long batch,
                int n, int tb, int threads, void* stream) {
  if (bad_launch(batch, n, tb, threads) || ntiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  return launch_fwd(x, yt, z, tiles, ntiles, make_shape(batch, n, tb), threads,
                    static_cast<cudaStream_t>(stream));
}

template <typename T>
int dotprod_bwd(const T* x, const T* yt, const T* dz, T* dx, T* dyt, long long batch, int n,
                int te, int tb, int threads, void* stream) {
  if (bad_launch(batch, n, tb, threads)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const Shape s = make_shape(batch, n, tb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (te == 4) return launch_bwd<T, 4>(x, yt, dz, dx, dyt, s, threads, st);
  if (te == 8) return launch_bwd<T, 8>(x, yt, dz, dx, dyt, s, threads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [batch, 16], yt [batch, 16, n - 1] -> z [batch, n(n-1)/2].  `tiles` holds
// ntiles pairs (i0, j0), the 4 x 4 register blocks that cover the strict lower
// triangle of n; a tile has tb batch rows.
extern "C" int nasrec_dotprod_fwd(const float* x, const float* yt, float* z, const int* tiles,
                                  int ntiles, long long batch, int n, int tb, int threads,
                                  void* stream) {
  return dotprod_fwd(x, yt, z, tiles, ntiles, batch, n, tb, threads, stream);
}

// The same in bf16 (sums in f32, z rounded once).
extern "C" int nasrec_dotprod_fwd_bf16(const bf16* x, const bf16* yt, bf16* z, const int* tiles,
                                       int ntiles, long long batch, int n, int tb, int threads,
                                       void* stream) {
  return dotprod_fwd(x, yt, z, tiles, ntiles, batch, n, tb, threads, stream);
}

// (x, yt, dz [batch, n(n-1)/2]) -> dx [batch, 16], dyt [batch, 16, n - 1].
// A thread holds te of the 16 features, 4 or 8.
extern "C" int nasrec_dotprod_bwd(const float* x, const float* yt, const float* dz, float* dx,
                                  float* dyt, long long batch, int n, int te, int tb,
                                  int threads, void* stream) {
  return dotprod_bwd(x, yt, dz, dx, dyt, batch, n, te, tb, threads, stream);
}

// The same in bf16 (sums in f32, dx and dyt rounded once).
extern "C" int nasrec_dotprod_bwd_bf16(const bf16* x, const bf16* yt, const bf16* dz, bf16* dx,
                                       bf16* dyt, long long batch, int n, int te, int tb,
                                       int threads, void* stream) {
  return dotprod_bwd(x, yt, dz, dx, dyt, batch, n, te, tb, threads, stream);
}
