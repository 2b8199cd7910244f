// Fast libsvm chunk parser (C ABI, bound via ctypes).
//
// Native-path equivalent of the reference's dmlc::data::LibSVMParser
// (used via src/reader/reader.h:31-32): parse a text chunk
// "label idx:val idx:val ..." per line into CSR arrays. The Python parser
// (difacto_tpu_torch/data/parsers.py:parse_libsvm) is the semantic reference
// and the fallback; this exists because feeding the card from text on the
// host is interpreter-bound.
//
// Contract (single pass, caller allocates worst-case buffers):
//   labels[max_rows], offset[max_rows+1], index[max_nnz], value[max_nnz]
//   max_rows >= number of '\n' + 1, max_nnz >= number of ':' characters.
// Returns 0 on success, -1 on malformed input (missing ':', bad number).
// *out_has_value = 0 when every value == 1.0 (binary elision,
// src/reader/batch_reader.cc:71-73 drops such arrays).

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// strtof/strtoull honor LC_NUMERIC; parse with a fixed "C" locale so a
// comma-decimal host locale can't make well-formed files unparseable
locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

}  // namespace

extern "C" int difacto_parse_libsvm(
    const char* data, int64_t len,
    float* labels, int64_t* offset, uint64_t* index, float* value,
    int64_t* out_rows, int64_t* out_nnz, int* out_has_value) {
  const char* p = data;
  const char* end = data + len;
  int64_t rows = 0, nnz = 0;
  int has_value = 0;
  offset[0] = 0;

  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }  // empty line

    // label
    char* next = nullptr;
    float lab = strtof_l(p, &next, c_locale());
    if (next == p) return -1;
    p = next;
    labels[rows] = lab;

    // features until newline
    for (;;) {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n') { if (p < end) ++p; break; }
      if (*p == '-') return -1;  // strtoull would silently wrap negatives
      errno = 0;
      uint64_t idx = strtoull_l(p, &next, 10, c_locale());
      if (next == p) return -1;
      if (errno == ERANGE) return -1;  // id > uint64 max must not clamp
      float val = 1.0f;
      if (next < end && *next == ':') {
        p = next + 1;
        // the value must start right after ':' — strtof skips whitespace
        // (incl. '\n') and would otherwise swallow the next line's label
        if (p >= end || isspace((unsigned char)*p)) return -1;
        val = strtof_l(p, &next, c_locale());
        if (next == p) return -1;
        p = next;
      } else if (next >= end || isspace((unsigned char)*next)) {
        // implicit-value token "idx": value 1.0, same as "idx:1" — a
        // chunk may mix implicit and explicit tokens freely (the value
        // array stays consistent regardless of which form came first)
        p = next;
      } else {
        return -1;  // trailing garbage glued to the index
      }
      index[nnz] = idx;
      value[nnz] = val;
      if (val != 1.0f) has_value = 1;
      ++nnz;
    }
    ++rows;
    offset[rows] = nnz;
  }

  *out_rows = rows;
  *out_nnz = nnz;
  *out_has_value = has_value;
  return 0;
}
