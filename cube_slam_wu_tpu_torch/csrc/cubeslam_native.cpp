// Native runtime support for cube_slam_wu_tpu.
//
// The reference implements its whole runtime in C++ (txt dataset parsing in
// detect_3d_cuboid/src/matrix_utils.cpp:209-245, the aggregating tictoc
// profiler in dependency/tictoc_profiler/, sequential file IO in the driver
// main_obj.cpp:585-616).  The TPU compute path of this framework is JAX/XLA;
// this library provides the native host-side runtime around it:
//
//   - csn_parse_table: fast whitespace-table parser (the txt dataset
//     contract: trajectories, yolo boxes, cuboid dumps),
//   - csn_prof_*: an aggregating wall-clock profiler with the same
//     tictoc-toggle semantics as ca::Profiler (profiler.hpp:54-84),
//   - csn_loader_*: a multi-threaded file prefetcher that overlaps disk IO
//     with device compute (the reference reads every frame's jpg + txt
//     synchronously inside the SLAM loop).
//
// Exposed as a plain C ABI consumed through ctypes
// (cube_slam_wu_tpu/native.py); built with `make -C native`.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct ProfEntry {
  double total_s = 0.0;
  double min_s = 1e300;
  double max_s = 0.0;
  long count = 0;
};

std::mutex g_prof_mu;
std::map<std::string, Clock::time_point> g_prof_open;
std::map<std::string, ProfEntry> g_prof_agg;

}  // namespace

extern "C" {

// Parse a whitespace-separated numeric table ('#'-prefixed lines skipped).
// Returns 0 on success; writes row-major doubles into `out` (capacity
// max_rows*max_cols, rows wider than max_cols are truncated, short rows are
// zero-padded) and the discovered (rows, cols) into out_rows/out_cols.
int csn_parse_table(const char* text, long text_len, double* out, long max_rows,
                    long max_cols, long* out_rows, long* out_cols) {
  long rows = 0;
  long max_seen_cols = 0;
  const char* p = text;
  const char* end = text + text_len;
  while (p < end && rows < max_rows) {
    // find line bounds
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    // skip blank / comment lines
    const char* q = p;
    while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q == line_end || *q == '#') {
      p = line_end + 1;
      continue;
    }
    long col = 0;
    double* row_out = out + rows * max_cols;
    for (long c = 0; c < max_cols; ++c) row_out[c] = 0.0;
    while (q < line_end && col < max_cols) {
      // skip intra-line whitespace ourselves: strtod would happily walk
      // across the newline into the next row
      while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
      if (q >= line_end) break;
      char* next = nullptr;
      double v = strtod(q, &next);
      if (next == q) break;
      row_out[col++] = v;
      q = next;
    }
    if (col > 0) {
      if (col > max_seen_cols) max_seen_cols = col;
      ++rows;
    }
    p = line_end + 1;
  }
  *out_rows = rows;
  *out_cols = max_seen_cols;
  return 0;
}

// ---------------------------------------------------------------------------
// profiler (ca::Profiler tictoc semantics)
// ---------------------------------------------------------------------------

void csn_prof_tictoc(const char* name) {
  std::lock_guard<std::mutex> lk(g_prof_mu);
  auto now = Clock::now();
  std::string key(name);
  auto it = g_prof_open.find(key);
  if (it == g_prof_open.end()) {
    g_prof_open.emplace(std::move(key), now);
  } else {
    double dt = std::chrono::duration<double>(now - it->second).count();
    auto& e = g_prof_agg[key];
    e.total_s += dt;
    e.count += 1;
    if (dt < e.min_s) e.min_s = dt;
    if (dt > e.max_s) e.max_s = dt;
    g_prof_open.erase(it);
  }
}

// Write an aggregated report into buf; returns bytes written (excl. NUL).
long csn_prof_report(char* buf, long cap) {
  std::lock_guard<std::mutex> lk(g_prof_mu);
  long off = 0;
  off += snprintf(buf + off, cap - off, "%-40s %8s %10s %10s %10s %12s\n",
                  "name", "calls", "avg_ms", "min_ms", "max_ms", "total_ms");
  for (const auto& kv : g_prof_agg) {
    if (off >= cap - 1) break;
    const ProfEntry& e = kv.second;
    double avg = e.count ? e.total_s / e.count : 0.0;
    off += snprintf(buf + off, cap - off,
                    "%-40s %8ld %10.3f %10.3f %10.3f %12.1f\n",
                    kv.first.c_str(), e.count, avg * 1e3, e.min_s * 1e3,
                    e.max_s * 1e3, e.total_s * 1e3);
  }
  return off;
}

void csn_prof_reset() {
  std::lock_guard<std::mutex> lk(g_prof_mu);
  g_prof_open.clear();
  g_prof_agg.clear();
}

// ---------------------------------------------------------------------------
// threaded file prefetcher
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  std::vector<std::string> data;
  std::vector<char> ready;  // 0 pending, 1 done, 2 error
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<long> next_job{0};
  std::vector<std::thread> threads;
  std::atomic<bool> stop{false};

  explicit Loader(std::vector<std::string> p, int n_threads)
      : paths(std::move(p)), data(paths.size()), ready(paths.size(), 0) {
    for (int t = 0; t < n_threads; ++t) {
      threads.emplace_back([this] { this->work(); });
    }
  }

  void work() {
    while (!stop.load()) {
      long job = next_job.fetch_add(1);
      if (job >= static_cast<long>(paths.size())) return;
      std::string contents;
      std::ifstream f(paths[job], std::ios::binary);
      char status = 2;
      if (f) {
        f.seekg(0, std::ios::end);
        contents.resize(static_cast<size_t>(f.tellg()));
        f.seekg(0);
        f.read(contents.data(), contents.size());
        status = f ? 1 : 2;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        data[job] = std::move(contents);
        ready[job] = status;
      }
      cv.notify_all();
    }
  }

  ~Loader() {
    stop.store(true);
    next_job.store(static_cast<long>(paths.size()));
    for (auto& t : threads) t.join();
  }
};

void* csn_loader_create(const char** paths, long n_paths, int n_threads) {
  std::vector<std::string> p(paths, paths + n_paths);
  if (n_threads < 1) n_threads = 1;
  return new Loader(std::move(p), n_threads);
}

// Blocks until file idx is loaded; copies up to cap bytes into buf.
// Returns the full file size, or -1 on read error / bad idx.
long csn_loader_get(void* handle, long idx, char* buf, long cap) {
  Loader* l = static_cast<Loader*>(handle);
  if (idx < 0 || idx >= static_cast<long>(l->paths.size())) return -1;
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv.wait(lk, [&] { return l->ready[idx] != 0; });
  if (l->ready[idx] == 2) return -1;
  long n = static_cast<long>(l->data[idx].size());
  if (buf && cap > 0) memcpy(buf, l->data[idx].data(), std::min(n, cap));
  return n;
}

void csn_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
