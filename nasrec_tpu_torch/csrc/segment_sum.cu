// Duplicate-row segment-sum of the sparse step's stem gradient.
//
// Replaces no Pallas kernel: in the JAX package the segment-sum
// (nasrec_tpu/train/sparse_embedding.py :: rowwise_segment_sum_slotwise) is
// XLA's cumsum and cummax around a sort, and the port ran the same composite
// in PyTorch (its plain version, ops/kernels/segment_sum.py ::
// segment_sum_plain).  On the card those two scans give each of their
// columns ([B, C, 16] and [B, C]) to one thread that walks the B rows in
// sequence: 18.9 ms of a 41 ms xlarge step.  Contract, for C columns of B
// positions:
//
//   rows   [C, B] int32, each column sorted (torch.sort, stable);
//   order  [C, B] int64, the batch row each sorted position came from;
//   g      [B, C, E] f32, the stem gradient in (b, c) row-major order;
//   seg    [C*B, E] f32: at the last position of each run of equal rows of a
//          column the run's sum of g[order[c, j], c, :], exact 0.0f at every
//          other position (the table update skips an all-zero position, so
//          the positions of a duplicate row never race);
//   is_end [C*B] bool: those last positions.
//
// Bound: bytes.  At B = 32768, C = 26 it reads g 54.5 MB, order 6.8 MB and
// rows 3.4 MB and writes seg 54.5 MB and is_end 0.85 MB: about 120 MB, 36 us
// at 3.35 TB/s.  Each byte is moved once, in whole 32-byte sectors:
//
//   tiles    a block is (column, tile of 256 positions), 256 threads; four
//            threads a position, each one float4 of its 16 floats, so the
//            gathered 64-byte row of g is one 16-byte load a thread and a
//            warp's stores to seg cover whole sectors.  The tile's rows, with
//            one neighbour on each side, and its order are staged in shared
//            memory by coalesced loads; is_end is written one byte a thread,
//            coalesced.  A group of four threads sums its 4 consecutive
//            positions in order; the groups' partial sums are combined by a
//            run-segmented scan (warp shuffles, then the 8 warps' totals
//            through shared memory); each group then walks its positions
//            again from the sum carried into it, writing each run's sum at
//            the run's end and zeros elsewhere.  Many blocks an SM keep the
//            random 64-byte reads of g in flight.
//   carries  a run that crosses tiles (a 4-row slot gives runs of about
//            8,192 positions at B = 32768) is finished by a second launch,
//            one block a column: it stages the column's tile records (the sum
//            of the tile's last open run, whether a run starts in the tile,
//            the tile's first run end) in shared memory, walks them in order,
//            and adds the sum carried into each tile to the tile's first run
//            end.  It is not launched when a column fits in one tile.
//
// Every sum is f32, in an order fixed by the shapes alone (no float atomics,
// no look-back between blocks), so two launches on the same inputs give the
// same bits.
//
// Width.  E = 16 (NASRec's tables; `segsum_tile_kernel`, `segsum_carry_kernel`)
// or E = 128 (DLRM-DCNv2's; `segsum_tile128_kernel`, `segsum_walk128_kernel`):
// one templated tile pass, E/4 threads a position.  At E = 128 a warp is one
// position (its 512-byte row one float4 a lane), a group walks 8 positions
// and a tile is 64 positions.  A multi-hot bag step passes one column, C = 1,
// of all its B*H lookups sorted at once (each slot's rows lie above the last
// slot's, so a global sort keeps the slots apart), with `order` already mapped
// to the bag whose pooled gradient each lookup takes: g is then the pooled
// gradient [bags, 128] and nothing of size [B*H, 128] is gathered first.  Such
// a column spans tens of thousands of tiles, too many for the carry pass's
// one walk a column, so at E = 128 the carries are found by a walk a tile
// instead: each tile whose first run end closes a run begun in an earlier
// tile (one warp each) looks back, 32 tile records at a time, for the tile
// that run began in, then sums those tiles' partials forward, in the carry
// pass's order; the work is the tiles the runs span, in parallel over runs.
// At [16384 x 214 lookups] the bound is the pooled gradient read once
// (218 MB), the indices (14 MB) and a summed row written for each of the
// 2.55 M rows touched (1.3 GB): 0.46 ms at 3.35 TB/s; the kernel reads g
// at every lookup and writes seg at every position, zeros included.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The tile pass's shape at width kEmb.
template <int kEmb>
struct TileShape {
  static constexpr int kLanes = kEmb / 4;                  // threads a position, a float4 each
  static constexpr int kItems = kEmb == 16 ? 4 : 8;        // consecutive positions a group
  static constexpr int kTile = kThreads / kLanes * kItems; // positions a block
  static constexpr int kChunk = 4096 / kEmb;               // tile records the carry pass stages
};

// A run-segmented partial sum of a range of positions: `v` sums the positions
// from the range's last run start (its first position if none) to its end;
// `start` says a run starts in the range.
struct Part {
  float4 v;
  bool start;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The partial of range a followed by range b.
__device__ __forceinline__ Part combine(const Part& a, const Part& b) {
  return {b.start ? b.v : add4(a.v, b.v), a.start || b.start};
}

__device__ __forceinline__ Part shfl_up(const Part& p, int d) {
  Part o;
  o.v.x = __shfl_up_sync(0xffffffffu, p.v.x, d);
  o.v.y = __shfl_up_sync(0xffffffffu, p.v.y, d);
  o.v.z = __shfl_up_sync(0xffffffffu, p.v.z, d);
  o.v.w = __shfl_up_sync(0xffffffffu, p.v.w, d);
  o.start = __shfl_up_sync(0xffffffffu, static_cast<int>(p.start), d) != 0;
  return o;
}

template <int kEmb>
__device__ __forceinline__ void segsum_tile(const int* __restrict__ rows,
                                            const long long* __restrict__ order,
                                            const float* __restrict__ g, float* __restrict__ seg,
                                            unsigned char* __restrict__ is_end,
                                            float* __restrict__ tail, int* __restrict__ info,
                                            long long b, int cols, int tiles) {
  constexpr int kLanes = TileShape<kEmb>::kLanes;
  constexpr int kItems = TileShape<kEmb>::kItems;
  constexpr int kTile = TileShape<kEmb>::kTile;
  static_assert(kTile <= kThreads, "is_end and order are staged one position a thread");
  __shared__ int s_rows[kTile + 2];          // rows[j0 - 1 .. j0 + kTile]
  __shared__ long long s_order[kTile];
  __shared__ float4 s_warp[kWarps][kLanes];  // each warp's inclusive partial
  __shared__ int s_warp_start[kWarps];
  __shared__ int s_first_end;

  const int col = blockIdx.x / tiles;
  const int tile = blockIdx.x - col * tiles;
  const long long j0 = static_cast<long long>(tile) * kTile;
  const long long base = static_cast<long long>(col) * b;   // the column's first position
  const int tid = threadIdx.x;

  for (int i = tid; i < kTile + 2; i += kThreads) {
    const long long j = j0 - 1 + i;
    s_rows[i] = (j >= 0 && j < b) ? rows[base + j] : 0;
  }
  // (At kEmb = 16 a tile is one position a thread and the test folds away.)
  if (kTile == kThreads || tid < kTile)
    s_order[tid] = j0 + tid < b ? order[base + j0 + tid] : 0;
  if (tid == 0) s_first_end = INT_MAX;
  __syncthreads();

  if ((kTile == kThreads || tid < kTile) && j0 + tid < b) {   // run ends, a position a thread
    const bool end = j0 + tid == b - 1 || s_rows[tid + 1] != s_rows[tid + 2];
    is_end[base + j0 + tid] = end;
    if (end) atomicMin(&s_first_end, tid);
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int q = tid & (kLanes - 1);          // which float4 of the kEmb floats
  const int first = tid / kLanes * kItems;   // the group's first position in the tile
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4 v[kItems];
  bool st[kItems], en[kItems], in[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int o = first + i;
    const long long j = j0 + o;
    in[i] = j < b;
    st[i] = in[i] && (j == 0 || s_rows[o + 1] != s_rows[o]);
    en[i] = in[i] && (j == b - 1 || s_rows[o + 1] != s_rows[o + 2]);
    v[i] = in[i] ? __ldg(g4 + (s_order[o] * cols + col) * kLanes + q) : zero;
  }

  // The group's own partial, in position order (positions past the column's
  // end come after all of its positions and are left out).
  Part agg{v[0], st[0]};
#pragma unroll
  for (int i = 1; i < kItems; ++i)
    if (in[i]) agg = st[i] ? Part{v[i], true} : Part{add4(agg.v, v[i]), agg.start};

  // Inclusive scan over the warp's groups (none at kEmb = 128: a warp is one
  // group), then each warp's total.
  Part inc = agg;
#pragma unroll
  for (int d = kLanes; d < 32; d <<= 1) {
    const Part o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  const Part before = shfl_up(inc, kLanes & 31);  // the warp's earlier groups
  if (lane >= 32 - kLanes) {
    s_warp[warp][q] = inc.v;
    if (q == 0) s_warp_start[warp] = inc.start;
  }
  __syncthreads();

  // The partial of the tile's positions before this group: the earlier
  // warps' totals in order, then the warp's earlier groups.
  bool have = warp > 0;
  Part carry{s_warp[0][q], s_warp_start[0] != 0};
  for (int w = 1; w < warp; ++w) carry = combine(carry, Part{s_warp[w][q], s_warp_start[w] != 0});
  if (lane >= kLanes) {
    carry = have ? combine(carry, before) : before;
    have = true;
  }

  float4* seg4 = reinterpret_cast<float4*>(seg);
  float4 acc = carry.v;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (!in[i]) continue;
    acc = (st[i] || !have) ? v[i] : add4(acc, v[i]);
    have = true;
    seg4[(base + j0 + first + i) * kLanes + q] = en[i] ? acc : zero;
  }

  // The tile's record for the carry pass.
  const long long rec = static_cast<long long>(col) * tiles + tile;
  if (tid >= kThreads - kLanes) {            // the last group: the whole tile's partial
    const Part total = combine(carry, agg);
    reinterpret_cast<float4*>(tail)[rec * kLanes + q] = total.v;
    if (q == 0)
      info[2 * rec] = (total.start ? 1 : 0) | (j0 > 0 && s_rows[1] == s_rows[0] ? 2 : 0);
  }
  if (tid == 0) info[2 * rec + 1] = s_first_end == INT_MAX ? -1 : s_first_end;
}

__global__ void __launch_bounds__(kThreads)
segsum_tile_kernel(const int* __restrict__ rows, const long long* __restrict__ order,
                   const float* __restrict__ g, float* __restrict__ seg,
                   unsigned char* __restrict__ is_end, float* __restrict__ tail,
                   int* __restrict__ info, long long b, int cols, int tiles) {
  segsum_tile<16>(rows, order, g, seg, is_end, tail, info, b, cols, tiles);
}

__global__ void __launch_bounds__(kThreads)
segsum_tile128_kernel(const int* __restrict__ rows, const long long* __restrict__ order,
                      const float* __restrict__ g, float* __restrict__ seg,
                      unsigned char* __restrict__ is_end, float* __restrict__ tail,
                      int* __restrict__ info, long long b, int cols, int tiles) {
  segsum_tile<128>(rows, order, g, seg, is_end, tail, info, b, cols, tiles);
}

// E = 16: one block a column walks the column's tile records in order.
__global__ void __launch_bounds__(kThreads)
segsum_carry_kernel(const float* __restrict__ tail, const int* __restrict__ info,
                    float* __restrict__ seg, long long b, int tiles) {
  constexpr int kEmb = 16;
  constexpr int kTile = TileShape<kEmb>::kTile;
  constexpr int kChunk = TileShape<kEmb>::kChunk;
  __shared__ float s_tail[kChunk][kEmb];
  __shared__ float s_carry[kChunk][kEmb];
  __shared__ int s_info[kChunk][2];

  const int col = blockIdx.x, tid = threadIdx.x;
  const long long rec = static_cast<long long>(col) * tiles;
  float carry = 0.0f;   // threads 0..15: the open run's sum entering the next tile
  for (int t0 = 0; t0 < tiles; t0 += kChunk) {
    const int n = min(kChunk, tiles - t0);
    for (int i = tid; i < n * kEmb; i += kThreads)
      s_tail[i / kEmb][i % kEmb] = tail[(rec + t0) * kEmb + i];
    for (int i = tid; i < n * 2; i += kThreads) s_info[i / 2][i % 2] = info[(rec + t0) * 2 + i];
    __syncthreads();
    if (tid < kEmb) {
      for (int k = 0; k < n; ++k) {
        s_carry[k][tid] = carry;
        carry = (s_info[k][0] & 1) ? s_tail[k][tid] : carry + s_tail[k][tid];
      }
    }
    __syncthreads();
    for (int i = tid; i < n * kEmb; i += kThreads) {
      const int k = i / kEmb;
      const int end = s_info[k][1];
      if ((s_info[k][0] & 2) && end >= 0) {  // the tile opens inside a run that ends in it
        float* at = seg + (static_cast<long long>(col) * b
                           + static_cast<long long>(t0 + k) * kTile + end) * kEmb + i % kEmb;
        *at = *at + s_carry[k][i % kEmb];
      }
    }
    __syncthreads();
  }
}

// E = 128: one warp a tile record.  A tile whose first run end closes a run
// begun in an earlier tile finds that tile (the nearest earlier one with a run
// start: tile 0 always has one), then adds the partials of the tiles from it
// to its own predecessor, in order, to its first run end: the same sums in the
// same order as segsum_carry_kernel's walk.
__global__ void __launch_bounds__(kThreads)
segsum_walk128_kernel(const float* __restrict__ tail, const int* __restrict__ info,
                      float* __restrict__ seg, long long b, int cols, int tiles) {
  constexpr int kLanes = TileShape<128>::kLanes;
  constexpr int kTile = TileShape<128>::kTile;
  const long long rec = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (rec >= static_cast<long long>(cols) * tiles) return;
  const int lane = threadIdx.x & 31;
  const int col = static_cast<int>(rec / tiles);
  const int tile = static_cast<int>(rec - static_cast<long long>(col) * tiles);
  const int end = info[2 * rec + 1];
  if (!(info[2 * rec] & 2) || end < 0) return;
  const long long rec0 = static_cast<long long>(col) * tiles;   // the column's tile 0
  int s = tile - 1;
  for (;;) {
    const int t = s - lane;
    const bool started = t >= 0 && (info[2 * (rec0 + t)] & 1);
    const unsigned found = __ballot_sync(0xffffffffu, started);
    if (found) {
      s -= __ffs(found) - 1;
      break;
    }
    s -= 32;
  }
  const float4* tail4 = reinterpret_cast<const float4*>(tail);
  float4 carry = tail4[(rec0 + s) * kLanes + lane];
  for (int t = s + 1; t < tile; ++t) carry = add4(carry, tail4[(rec0 + t) * kLanes + lane]);
  float4* at = reinterpret_cast<float4*>(seg)
               + (static_cast<long long>(col) * b + static_cast<long long>(tile) * kTile + end)
                     * kLanes + lane;
  *at = add4(*at, carry);
}

}  // namespace

extern "C" int nasrec_segment_sum(const int* rows, const long long* order, const float* g,
                                  float* seg, unsigned char* is_end, float* tail, int* info,
                                  long long b, int cols, void* stream) {
  constexpr int kTile = TileShape<16>::kTile;
  if (b == 0 || cols == 0) return 0;
  const long long tiles = (b + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  segsum_tile_kernel<<<static_cast<unsigned>(tiles * cols), kThreads, 0, s>>>(
      rows, order, g, seg, is_end, tail, info, b, cols, static_cast<int>(tiles));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  segsum_carry_kernel<<<cols, kThreads, 0, s>>>(tail, info, seg, b, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nasrec_segment_sum128(const int* rows, const long long* order, const float* g,
                                     float* seg, unsigned char* is_end, float* tail, int* info,
                                     long long b, int cols, void* stream) {
  constexpr int kTile = TileShape<128>::kTile;
  if (b == 0 || cols == 0) return 0;
  const long long tiles = (b + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  segsum_tile128_kernel<<<static_cast<unsigned>(tiles * cols), kThreads, 0, s>>>(
      rows, order, g, seg, is_end, tail, info, b, cols, static_cast<int>(tiles));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  const long long walkers = (tiles * cols + kWarps - 1) / kWarps;
  segsum_walk128_kernel<<<static_cast<unsigned>(walkers), kThreads, 0, s>>>(
      tail, info, seg, b, cols, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
