// Fast CTR TSV parser: text shard -> (label f32, dense f32, cat i32) arrays.
//
// A copy of nasrec_tpu/data/native/fast_parse.cpp (the code is unchanged).
// Native replacement for the Python row parser + transforms
// (nasrec_tpu_torch/data/transforms.py), with identical semantics:
//   row:    label \t dense... \t cat...   (short rows = trailing empty fields)
//   label:  float(field), empty -> 0
//   dense:  log(max(float(field), 0) + 1), empty -> 0; all-zero for Avazu
//   cat:    parse field as hex (empty -> -1), then fmod(vocab-1)+1 with the
//           dividend's sign (torch.fmod), so empty maps to bucket 0.
//
// Buffers of whole lines are split at line boundaries over host threads, each
// writing its own rows.  Its rows/s on the card's host is the xlarge.tsv
// cell's parse_rows_per_s.tsv (benchmark/metrics/).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfastparse.so fast_parse.cpp -lpthread

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline double parse_float(const char* p, const char* end) {
  // Minimal float parser (values are small integers or decimals; no exps in
  // these datasets).  Returns 0 on empty/invalid — matching safe_cast
  // default 0 (ref: nasrec/torchrec/utils.py:154).
  if (p >= end) return 0.0;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  double v = 0.0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10.0 + (*p - '0'); ++p; any = true; }
  if (p < end && *p == '.') {
    ++p;
    double f = 0.1;
    while (p < end && *p >= '0' && *p <= '9') { v += (*p - '0') * f; f *= 0.1; ++p; any = true; }
  }
  if (!any) return 0.0;
  return neg ? -v : v;
}

inline int64_t parse_hex(const char* p, const char* end) {
  // int(field, 16); empty -> -1 (ref: nasrec/utils/data_pipes.py:164).
  if (p >= end) return -1;
  int64_t v = 0;
  for (; p < end; ++p) {
    char c = *p;
    int d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
    else break;
    v = v * 16 + d;
  }
  return v;
}

struct Job {
  const char* buf;
  int64_t begin, end;     // byte range (end exclusive), aligned to line starts
  int num_dense, num_sparse, zero_dense;
  const int64_t* vocab;
  float* labels;          // [*, 1]
  float* dense;           // [*, num_dense]
  int32_t* cats;          // [*, num_sparse]
  int64_t row0;           // first output row index
  int64_t rows_done = 0;
};

void parse_range(Job* job) {
  const char* p = job->buf + job->begin;
  const char* stop = job->buf + job->end;
  const int nd = job->num_dense, ns = job->num_sparse;
  int64_t row = job->row0;
  while (p < stop) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', stop - p));
    if (!line_end) line_end = stop;
    // Split fields on tabs; missing trailing fields read as empty.
    const char* f = p;
    int field = 0;
    const int total = 1 + nd + ns;
    float* drow = job->dense + row * nd;
    int32_t* crow = job->cats + row * ns;
    for (int i = 0; i < nd; ++i) drow[i] = 0.0f;
    for (int i = 0; i < ns; ++i) {
      // default for empty/missing: hex=-1 -> fmod+1 = 0
      crow[i] = 0;
    }
    job->labels[row] = 0.0f;
    while (field < total && f <= line_end) {
      const char* tab = static_cast<const char*>(memchr(f, '\t', line_end - f));
      const char* fe = tab ? tab : line_end;
      if (field == 0) {
        job->labels[row] = static_cast<float>(parse_float(f, fe));
      } else if (field <= nd) {
        if (!job->zero_dense) {
          double v = parse_float(f, fe);
          if (v < 0) v = 0;
          drow[field - 1] = static_cast<float>(std::log(v + 1.0));
        }
      } else {
        int64_t h = parse_hex(f, fe);
        int64_t m = job->vocab[field - 1 - nd] - 1;
        // torch.fmod keeps the dividend's sign; only -1 (empty) is negative.
        int64_t r = h % m;  // C++ % matches fmod sign semantics
        crow[field - 1 - nd] = static_cast<int32_t>(r + 1);
      }
      ++field;
      if (!tab) break;
      f = tab + 1;
    }
    ++row;
    p = line_end + 1;
  }
  job->rows_done = row - job->row0;
}

int64_t count_lines(const char* buf, int64_t len) {
  int64_t n = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) { ++n; break; }
    ++n;
    p = nl + 1;
  }
  return n;
}

}  // namespace

extern "C" {

// Parse a buffer of complete TSV lines.  Output arrays must hold at least
// count_rows(buf) rows.  Returns the number of rows written.
int64_t parse_ctr_buffer(const char* buf, int64_t len, int num_dense,
                         int num_sparse, int zero_dense, const int64_t* vocab,
                         float* labels, float* dense, int32_t* cats,
                         int num_threads) {
  if (len <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  // Split at line boundaries; count rows per split for output offsets.
  std::vector<int64_t> starts{0};
  for (int t = 1; t < num_threads; ++t) {
    int64_t target = len * t / num_threads;
    const char* nl = static_cast<const char*>(
        memchr(buf + target, '\n', len - target));
    int64_t s = nl ? (nl - buf) + 1 : len;
    if (s > starts.back()) starts.push_back(s);
  }
  starts.push_back(len);

  std::vector<Job> jobs;
  int64_t row0 = 0;
  for (size_t i = 0; i + 1 < starts.size(); ++i) {
    Job j;
    j.buf = buf;
    j.begin = starts[i];
    j.end = starts[i + 1];
    j.num_dense = num_dense;
    j.num_sparse = num_sparse;
    j.zero_dense = zero_dense;
    j.vocab = vocab;
    j.labels = labels;
    j.dense = dense;
    j.cats = cats;
    j.row0 = row0;
    row0 += count_lines(buf + j.begin, j.end - j.begin);
    jobs.push_back(j);
  }
  std::vector<std::thread> threads;
  for (auto& j : jobs) threads.emplace_back(parse_range, &j);
  for (auto& t : threads) t.join();
  int64_t total = 0;
  for (auto& j : jobs) total += j.rows_done;
  return total;
}

int64_t count_rows(const char* buf, int64_t len) { return count_lines(buf, len); }

}  // extern "C"
