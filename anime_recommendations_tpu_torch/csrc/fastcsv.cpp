// Fast numeric-CSV parser for the ratings ingest path.
//
// The reference ingests a 2.03 GB animelist.csv through pandas
// (download.py:99-119); this parser handles the numeric-table case
// (MyAnimeList rating dumps: user_id,anime_id,rating,watching_status,
// watched_episodes) with a memory-mapped single pass and a thread per
// chunk. Exposed through ctypes (data/fastcsv.py of this package), which
// builds it at first use and reads with pandas where no compiler is found.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libfastcsv.so fastcsv.cpp

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Chunk {
  const char* begin;
  const char* end;       // exclusive; aligned to a line boundary
  int64_t rows = 0;
  int64_t start_row = 0; // filled in pass 2
};

// Parse one number (integer fast path, float fallback). Advances *p past the
// value. Missing values ("") become NaN.
inline double parse_value(const char** p, const char* end) {
  const char* s = *p;
  while (s < end && *s == ' ') s++;
  bool neg = false;
  if (s < end && (*s == '-' || *s == '+')) {
    neg = (*s == '-');
    s++;
  }
  if (s >= end || (!isdigit(static_cast<unsigned char>(*s)) && *s != '.')) {
    // empty / non-numeric field -> NaN, skip to delimiter
    while (s < end && *s != ',' && *s != '\n' && *s != '\r') s++;
    *p = s;
    return __builtin_nan("");
  }
  int64_t int_part = 0;
  while (s < end && isdigit(static_cast<unsigned char>(*s))) {
    int_part = int_part * 10 + (*s - '0');
    s++;
  }
  double value = static_cast<double>(int_part);
  if (s < end && *s == '.') {
    s++;
    double frac = 0.0, scale = 1.0;
    while (s < end && isdigit(static_cast<unsigned char>(*s))) {
      frac = frac * 10.0 + (*s - '0');
      scale *= 10.0;
      s++;
    }
    value += frac / scale;
  }
  if (s < end && (*s == 'e' || *s == 'E')) {  // rare: scientific notation
    char* after = nullptr;
    value = strtod(*p, &after);
    s = after;
  }
  *p = s;
  return neg ? -value : value;
}

void count_chunk(Chunk* chunk) {
  int64_t rows = 0;
  for (const char* s = chunk->begin; s < chunk->end; s++) {
    if (*s == '\n') rows++;
  }
  // Final line without trailing newline.
  if (chunk->end > chunk->begin && chunk->end[-1] != '\n') rows++;
  chunk->rows = rows;
}

void parse_chunk(const Chunk* chunk, int n_cols, double* out) {
  const char* s = chunk->begin;
  const char* end = chunk->end;
  double* row_out = out + chunk->start_row * n_cols;
  while (s < end) {
    for (int c = 0; c < n_cols; c++) {
      row_out[c] = parse_value(&s, end);
      if (s < end && *s == ',') s++;
    }
    while (s < end && *s != '\n') s++;  // tolerate extra columns
    if (s < end) s++;                   // skip newline
    row_out += n_cols;
  }
}

}  // namespace

extern "C" {

// Returns the number of data rows, or -1 on error. header_skipped reports
// whether a header line was detected (first line has any alphabetic char).
int64_t fastcsv_count_rows(const char* path, int* header_skipped) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return st.st_size == 0 ? 0 : -1;
  }
  const char* data = static_cast<const char*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return -1;

  const char* end = data + st.st_size;
  const char* body = data;
  *header_skipped = 0;
  for (const char* s = data; s < end && *s != '\n'; s++) {
    if (isalpha(static_cast<unsigned char>(*s))) {
      *header_skipped = 1;
      while (body < end && *body != '\n') body++;
      if (body < end) body++;
      break;
    }
  }
  int64_t rows = 0;
  for (const char* s = body; s < end; s++) {
    if (*s == '\n') rows++;
  }
  if (end > body && end[-1] != '\n') rows++;
  munmap(const_cast<char*>(data), st.st_size);
  return rows;
}

// Parses up to max_rows x n_cols values into out (row-major doubles).
// Returns rows parsed, or -1 on error.
int64_t fastcsv_parse(const char* path, int n_cols, double* out,
                      int64_t max_rows, int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return st.st_size == 0 ? 0 : -1;
  }
  const char* data = static_cast<const char*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return -1;
  const char* end = data + st.st_size;

  // Skip a header line when the first line contains letters.
  const char* body = data;
  for (const char* s = data; s < end && *s != '\n'; s++) {
    if (isalpha(static_cast<unsigned char>(*s))) {
      while (body < end && *body != '\n') body++;
      if (body < end) body++;
      break;
    }
  }

  if (n_threads < 1) n_threads = 1;
  std::vector<Chunk> chunks;
  int64_t total = end - body;
  int64_t target = total / n_threads + 1;
  const char* cur = body;
  for (int t = 0; t < n_threads && cur < end; t++) {
    const char* cend = (t == n_threads - 1) ? end : cur + target;
    if (cend > end) cend = end;
    while (cend < end && cend[-1] != '\n') cend++;  // align to line boundary
    chunks.push_back({cur, cend});
    cur = cend;
  }

  {
    std::vector<std::thread> threads;
    for (auto& c : chunks) threads.emplace_back(count_chunk, &c);
    for (auto& t : threads) t.join();
  }
  int64_t rows = 0;
  for (auto& c : chunks) {
    c.start_row = rows;
    rows += c.rows;
  }
  if (rows > max_rows) {
    munmap(const_cast<char*>(data), st.st_size);
    return -2;  // caller buffer too small
  }
  {
    std::vector<std::thread> threads;
    for (auto& c : chunks)
      threads.emplace_back(parse_chunk, &c, n_cols, out);
    for (auto& t : threads) t.join();
  }
  munmap(const_cast<char*>(data), st.st_size);
  return rows;
}

}  // extern "C"
