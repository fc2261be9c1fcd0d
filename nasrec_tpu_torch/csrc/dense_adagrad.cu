// Global-norm clip and Adagrad update of a train step's dense parameters,
// over the whole list of tensors at once.
//
// Replaces no Pallas kernel: the JAX package leaves the clip and the dense
// Adagrad to XLA, which fuses them (nasrec_tpu/train/optim.py ::
// clip_by_global_norm, adagrad_update).  The port's plain versions
// (ops/kernels/dense_adagrad.py) loop over the tensors in Python: a
// sum(square) a gradient for the norm, then g * scale and seven elementwise
// launches a parameter for the update.  On criteo-xlarge that is about 860
// launches of a few microseconds of card work each over 86 tensors, and the
// host's time to issue them, not the card, set the step's pace.  Here the
// same work is three launches:
//
//   dense_sq_partial_kernel   one block a chunk of kChunk floats of a tensor
//                             of the list (the gradients, and the table's
//                             summed gradient where it is trained): the
//                             chunk's sum of squares, each square rounded to
//                             f32 as the plain version's, summed in f64 in a
//                             fixed order (a thread's floats in sequence,
//                             then warp shuffles, then the block's warps in
//                             order), to one partial a block;
//   dense_clip_scale_kernel   one block: the partials in a fixed order, then
//                             scale = min(max_norm / (sqrt(sq) + 1e-6), 1),
//                             rounded step by step as global_norm_scale is
//                             (reciprocal, then times max_norm), written to
//                             device memory: nothing goes back to the host;
//   dense_adagrad_kernel      one block a chunk: for every element, with s
//                             read from device memory (1 without a clip),
//                                 gs = g * s
//                                 a  = a + gs * gs
//                                 p  = p - lr * gs / (sqrt(a) + eps)
//                             rounded operation by operation (no fused
//                             multiply-add), so that, given the same s, p and
//                             a are the plain version's bit for bit.
//
// No float atomics and no order that depends on timing: two launches on the
// same inputs give the same bits.
//
// Tensor table.  Pointers and sizes go in the kernel's arguments by value (a
// `__grid_constant__` struct under the 4 KB argument limit), as PyTorch's
// multi_tensor_apply does, so there is no host-to-device copy and no
// synchronisation.  Each tensor takes ceil(numel / kChunk) blocks, and a
// block finds its tensor by a binary search over the table's running block
// counts.  A list longer than a table (kMaxUpdate tensors for the update,
// kMaxNorm for the norm) takes one launch a table.  Any count and size of
// tensors works: empty, a single float, sizes that are not a multiple of 4.
// A tensor whose pointers all lie on 16-byte boundaries moves in float4s with
// a scalar tail; any other moves float by float.
//
// Bound: bytes.  On criteo-xlarge (86 tensors, 2,217,268 floats, and the
// table's summed gradient of 13,631,488 floats) the norm reads 63 MB and the
// update reads p, a and g and writes p and a: 44 MB; about 32 us in all at
// 3.35 TB/s.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 16384;  // floats a block; a multiple of 4
constexpr int kMaxUpdate = 100;      // tensors a launch of the update
constexpr int kMaxNorm = 180;        // tensors a launch of the norm's partials
constexpr int kFinalThreads = 1024;

template <int kDepth, int kMax>
struct TensorTable {
  float* ptr[kDepth][kMax];
  long long numel[kMax];
  int block_end[kMax];  // blocks of tensors 0..t of this table
  int n;
};

using UpdateTable = TensorTable<3, kMaxUpdate>;  // p, a, g
using NormTable = TensorTable<1, kMaxNorm>;

static_assert(sizeof(UpdateTable) + sizeof(void*) + 2 * sizeof(float) <= 4096,
              "the update's arguments exceed 4 KB");
static_assert(sizeof(NormTable) + sizeof(void*) + sizeof(long long) <= 4096,
              "the norm pass's arguments exceed 4 KB");

// This block's tensor, and its range [start, start + len) of that tensor.
template <int kDepth, int kMax>
__device__ __forceinline__ int locate(const TensorTable<kDepth, kMax>& tab, long long* start,
                                      long long* len) {
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = tab.n - 1;  // the first tensor whose blocks end after b
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab.block_end[mid] > b) hi = mid;
    else lo = mid + 1;
  }
  *start = static_cast<long long>(b - (lo > 0 ? tab.block_end[lo - 1] : 0)) * kChunk;
  *len = min(kChunk, tab.numel[lo] - *start);
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

__device__ __forceinline__ void sq_add(double* acc, float x) {
  *acc += static_cast<double>(__fmul_rn(x, x));
}

// The block's sum of `v`, in a fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* warp_sums, int warps) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < warps; ++w) total += warp_sums[w];
  return total;
}

__global__ void __launch_bounds__(kThreads)
dense_sq_partial_kernel(const __grid_constant__ NormTable tab, double* __restrict__ partials,
                        long long base) {
  __shared__ double warp_sums[kWarps];
  long long start, len;
  const int t = locate(tab, &start, &len);
  const float* x = tab.ptr[0][t] + start;
  double acc = 0.0;
  long long vec_end = 0;
  if (aligned16(x)) {
    vec_end = len & ~3ll;
    for (long long i = threadIdx.x * 4ll; i < vec_end; i += kThreads * 4ll) {
      const float4 v = *reinterpret_cast<const float4*>(x + i);
      sq_add(&acc, v.x);
      sq_add(&acc, v.y);
      sq_add(&acc, v.z);
      sq_add(&acc, v.w);
    }
  }
  for (long long i = vec_end + threadIdx.x; i < len; i += kThreads) sq_add(&acc, x[i]);
  const double total = block_sum(acc, warp_sums, kWarps);
  if (threadIdx.x == 0) partials[base + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFinalThreads)
dense_clip_scale_kernel(const double* __restrict__ partials, long long n, float max_norm,
                        float* __restrict__ scale) {
  __shared__ double warp_sums[kFinalThreads / 32];
  double acc = 0.0;
  for (long long i = threadIdx.x; i < n; i += kFinalThreads) acc += partials[i];
  const double sq = block_sum(acc, warp_sums, kFinalThreads / 32);
  if (threadIdx.x == 0) {
    // global_norm_scale: clamp(max_norm / (sqrt(sq) + 1e-6), max=1), where
    // PyTorch computes a number over a tensor as its reciprocal times the
    // number, and clamp keeps a NaN.
    const float r = __frcp_rn(__fadd_rn(__fsqrt_rn(__double2float_rn(sq)),
                                        static_cast<float>(1e-6)));
    const float s = __fmul_rn(r, max_norm);
    *scale = s > 1.0f ? 1.0f : s;
  }
}

__device__ __forceinline__ void adagrad_one(float* p, float* a, float g, float s, float lr,
                                            float eps) {
  const float gs = __fmul_rn(g, s);
  *a = __fadd_rn(*a, __fmul_rn(gs, gs));
  *p = __fsub_rn(*p, __fdiv_rn(__fmul_rn(lr, gs), __fadd_rn(__fsqrt_rn(*a), eps)));
}

__global__ void __launch_bounds__(kThreads)
dense_adagrad_kernel(const __grid_constant__ UpdateTable tab, const float* __restrict__ scale,
                     float lr, float eps) {
  long long start, len;
  const int t = locate(tab, &start, &len);
  float* p = tab.ptr[0][t] + start;
  float* a = tab.ptr[1][t] + start;
  const float* g = tab.ptr[2][t] + start;
  const float s = scale != nullptr ? *scale : 1.0f;
  long long vec_end = 0;
  if (aligned16(p) && aligned16(a) && aligned16(g)) {
    vec_end = len & ~3ll;
    for (long long i = threadIdx.x * 4ll; i < vec_end; i += kThreads * 4ll) {
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      float4 av = *reinterpret_cast<const float4*>(a + i);
      const float4 gv = __ldcs(reinterpret_cast<const float4*>(g + i));
      adagrad_one(&pv.x, &av.x, gv.x, s, lr, eps);
      adagrad_one(&pv.y, &av.y, gv.y, s, lr, eps);
      adagrad_one(&pv.z, &av.z, gv.z, s, lr, eps);
      adagrad_one(&pv.w, &av.w, gv.w, s, lr, eps);
      *reinterpret_cast<float4*>(p + i) = pv;
      *reinterpret_cast<float4*>(a + i) = av;
    }
  }
  for (long long i = vec_end + threadIdx.x; i < len; i += kThreads)
    adagrad_one(p + i, a + i, g[i], s, lr, eps);
}

// Fills `tab` with tensors [first, first + count) of `depth` pointer lists
// (`ptrs`: depth rows of n pointers) and their sizes; returns the table's
// blocks, or -1 where they do not fit an int.
template <int kDepth, int kMax>
long long fill(TensorTable<kDepth, kMax>* tab, const long long* ptrs, const long long* numels,
               int n, int first, int count) {
  long long blocks = 0;
  for (int k = 0; k < count; ++k) {
    const int i = first + k;
    for (int d = 0; d < kDepth; ++d)
      tab->ptr[d][k] = reinterpret_cast<float*>(ptrs[static_cast<long long>(d) * n + i]);
    tab->numel[k] = numels[i];
    blocks += (numels[i] + kChunk - 1) / kChunk;
    if (numels[i] < 0 || blocks > INT_MAX) return -1;
    tab->block_end[k] = static_cast<int>(blocks);
  }
  tab->n = count;
  return blocks;
}

}  // namespace

// The clip's scale over n f32 tensors: `ptrs` [n] device pointers, `numels`
// [n]; `partials` a device buffer of n_partials doubles, the sum over the
// tensors of ceil(numel / 16384); `scale` one f32 on the device.
extern "C" int nasrec_dense_clip_scale(const long long* ptrs, const long long* numels, int n,
                                       double* partials, long long n_partials, float max_norm,
                                       float* scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  NormTable tab;
  long long base = 0;
  for (int first = 0; first < n; first += kMaxNorm) {
    const long long blocks = fill(&tab, ptrs, numels, n, first, std::min(kMaxNorm, n - first));
    if (blocks < 0 || base + blocks > n_partials) return static_cast<int>(cudaErrorInvalidValue);
    if (blocks > 0) {
      dense_sq_partial_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          tab, partials, base);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    base += blocks;
  }
  if (base != n_partials) return static_cast<int>(cudaErrorInvalidValue);
  dense_clip_scale_kernel<<<1, kFinalThreads, 0, st>>>(partials, n_partials, max_norm, scale);
  return static_cast<int>(cudaGetLastError());
}

// Adagrad over n f32 tensors, in place: `ptrs` [3, n] device pointers (the
// parameters, their accumulators, their gradients), `numels` [n]; `scale`
// one f32 on the device, or null for 1.
extern "C" int nasrec_dense_adagrad(const long long* ptrs, const long long* numels, int n,
                                    const float* scale, float lr, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  UpdateTable tab;
  for (int first = 0; first < n; first += kMaxUpdate) {
    const long long blocks =
        fill(&tab, ptrs, numels, n, first, std::min(kMaxUpdate, n - first));
    if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (blocks > 0) {
      dense_adagrad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          tab, scale, lr, eps);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
