// Native text parser for lightgbm_tpu_torch.
//
// A copy of the JAX package's native/fast_parser.cpp (reference
// src/io/parser.cpp, include/LightGBM/utils/text_reader.h): row-major
// tokenization of CSV/TSV/LibSVM into a dense float64 matrix at memory
// bandwidth instead of Python string speed. Loaded via ctypes by
// lightgbm_tpu_torch/io/native.py, which builds it with g++ through
// utils/cuda_build.py; the Python parser (io/parser.py) stays the
// semantic oracle. The JAX copy's bulk value->bin mapping is left out:
// the port bins on the device (io/dataset.py bin_columns).
//
// Build: g++ -O3 -shared -fPIC -pthread -o fast_parser.so fast_parser.cpp
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <cctype>
#include <vector>
#include <string>
#include <locale.h>

namespace {

struct Lines {
  std::vector<const char*> begin;
  std::vector<const char*> end;
  std::string storage;
};

// read the file and index data lines (skip blanks and '#' comments,
// optionally the header line)
bool load_lines(const char* path, int skip_header, Lines* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->storage.resize(sz);
  if (sz > 0 && std::fread(&out->storage[0], 1, sz, f) != (size_t)sz) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);
  const char* p = out->storage.data();
  const char* endp = p + sz;
  bool header_skipped = skip_header == 0;
  while (p < endp) {
    const char* eol = (const char*)memchr(p, '\n', endp - p);
    if (!eol) eol = endp;
    const char* e = eol;
    while (e > p && (e[-1] == '\r' || e[-1] == ' ')) --e;
    const char* b = p;
    while (b < e && (*b == ' ' || *b == '\t')) ++b;
    if (b < e && *b != '#') {
      if (!header_skipped) {
        header_skipped = true;
      } else {
        out->begin.push_back(p);
        out->end.push_back(e);
      }
    } else if (b < e) {
      // comment line: never a header
    } else if (!header_skipped && b < e) {
      header_skipped = true;
    }
    p = eol + 1;
  }
  return true;
}

inline bool is_na_token(const char* b, const char* e) {
  size_t n = e - b;
  if (n == 0) return true;
  auto eq = [&](const char* s) {
    if (std::strlen(s) != n) return false;
    for (size_t i = 0; i < n; ++i)
      if (std::tolower(b[i]) != s[i]) return false;
    return true;
  };
  return eq("na") || eq("nan") || eq("null") || eq("none") || eq("?");
}

// locale-independent strtod: a host app setting LC_NUMERIC must not
// change how training data parses (the reference's Atof is likewise
// locale-free)
inline double c_strtod(const char* b, char** endp) {
  static locale_t c_loc = newlocale(LC_NUMERIC_MASK, "C", (locale_t)0);
  return strtod_l(b, endp, c_loc);
}

inline double tok_to_double(const char* b, const char* e) {
  if (is_na_token(b, e)) return NAN;
  return c_strtod(b, nullptr);
}

int count_cols(const char* b, const char* e, char delim) {
  int cols = 1;
  for (const char* p = b; p < e; ++p)
    if (*p == delim) ++cols;
  return cols;
}

// one delimited row [p, e) into values (cols feature columns) and its
// label; false for a ragged row (other than cols + label columns)
bool fill_delimited_row(const char* p, const char* e, char delim,
                        int32_t label_idx, double* values, float* label,
                        int32_t cols) {
  int32_t expect_cols = cols + (label_idx >= 0 ? 1 : 0);
  int32_t col = 0, feat = 0;
  while (p <= e) {
    const char* t = p;
    while (p < e && *p != delim) ++p;
    if (col == label_idx) {
      if (label) *label = (float)tok_to_double(t, p);
    } else if (feat < cols) {
      values[feat] = tok_to_double(t, p);
      ++feat;
    }
    ++col;
    if (p >= e) break;
    ++p;  // skip delimiter
  }
  return col == expect_cols;
}

}  // namespace

extern "C" {

// First pass: rows, columns, detected format (0 tsv, 1 csv, 2 libsvm).
// For libsvm, out_cols is max feature index + 1 over the whole file
// (caller may widen it with the label handling).
int lgbm_tpu_parse_count(const char* path, int skip_header,
                         int64_t* out_rows, int32_t* out_cols,
                         int32_t* out_format) {
  Lines ln;
  if (!load_lines(path, skip_header, &ln)) return 1;
  *out_rows = (int64_t)ln.begin.size();
  if (ln.begin.empty()) { *out_cols = 0; *out_format = 0; return 0; }
  const char* b = ln.begin[0];
  const char* e = ln.end[0];
  int colon = 0, tab = 0, comma = 0;
  for (const char* p = b; p < e; ++p) {
    colon += *p == ':';
    tab += *p == '\t';
    comma += *p == ',';
  }
  if (colon > 0) {
    *out_format = 2;
    int32_t maxidx = -1;
    for (size_t i = 0; i < ln.begin.size(); ++i) {
      for (const char* p = ln.begin[i]; p < ln.end[i]; ++p) {
        if (*p == ':') {
          const char* q = p;
          while (q > ln.begin[i] && q[-1] >= '0' && q[-1] <= '9') --q;
          int32_t idx = (int32_t)std::strtol(q, nullptr, 10);
          if (idx > maxidx) maxidx = idx;
        }
      }
    }
    *out_cols = maxidx + 1;
  } else if (tab > 0) {
    *out_format = 0;
    *out_cols = count_cols(b, e, '\t');
  } else if (comma > 0) {
    *out_format = 1;
    *out_cols = count_cols(b, e, ',');
  } else {
    *out_format = 0;
    *out_cols = 1;
  }
  return 0;
}

// Second pass: fill values [rows, cols] row-major and labels [rows].
// label_idx < 0 = no label column. cols counts FEATURE columns only.
int lgbm_tpu_parse_fill(const char* path, int skip_header,
                        int32_t label_idx, int32_t format,
                        double* values, float* labels,
                        int64_t rows, int32_t cols) {
  Lines ln;
  if (!load_lines(path, skip_header, &ln)) return 1;
  if ((int64_t)ln.begin.size() != rows) return 2;
  char delim = format == 1 ? ',' : '\t';
  if (format == 2) {
    std::memset(values, 0, sizeof(double) * rows * cols);
    for (int64_t i = 0; i < rows; ++i) {
      const char* p = ln.begin[i];
      const char* e = ln.end[i];
      bool first = true;
      while (p < e) {
        while (p < e && (*p == ' ' || *p == '\t')) ++p;
        const char* t = p;
        while (p < e && *p != ' ' && *p != '\t') ++p;
        if (t == p) break;
        const char* c = (const char*)memchr(t, ':', p - t);
        if (!c) {
          if (first && label_idx >= 0) labels[i] = (float)tok_to_double(t, p);
        } else {
          long idx = std::strtol(t, nullptr, 10);
          if (idx >= 0 && idx < cols)
            values[i * cols + idx] = c_strtod(c + 1, nullptr);
        }
        first = false;
      }
    }
    return 0;
  }
  for (int64_t i = 0; i < rows; ++i) {
    // ragged rows (more or fewer columns than the first line): refuse
    // so the caller falls back to the python parser's pad-and-warn
    if (!fill_delimited_row(ln.begin[i], ln.end[i], delim, label_idx,
                            values + i * cols, labels ? labels + i : nullptr,
                            cols))
      return 3;
  }
  return 0;
}

// A block of delimited data lines, joined by '\n' (the two-round
// loader's blocks: header, comments and blanks already dropped), into
// values [rows, cols] and labels [rows] as lgbm_tpu_parse_fill fills
// them. 2: not `rows` lines; 3: a ragged row.
int lgbm_tpu_parse_block(const char* buf, int64_t len, char delim,
                         int32_t label_idx, double* values, float* labels,
                         int64_t rows, int32_t cols) {
  const char* p = buf;
  const char* endp = buf + len;
  for (int64_t i = 0; i < rows; ++i) {
    if (p > endp) return 2;
    const char* eol = (const char*)memchr(p, '\n', endp - p);
    if (!eol) eol = endp;
    const char* e = eol;
    while (e > p && (e[-1] == '\r' || e[-1] == ' ')) --e;
    if (!fill_delimited_row(p, e, delim, label_idx, values + i * cols,
                            labels ? labels + i : nullptr, cols))
      return 3;
    p = eol + 1;
  }
  return p >= endp ? 0 : 2;
}

}  // extern "C"
