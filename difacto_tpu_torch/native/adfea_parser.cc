// Fast adfea chunk parser (C ABI, bound via ctypes).
//
// Native-path equivalent of the reference's AdfeaParser
// (src/reader/adfea_parser.h:20-91): the format is a whitespace-separated
// token stream "lineid count label idx:gid idx:gid ...". Tokens WITHOUT a
// ':' cycle through (lineid, count, label) — the third starts a new row
// whose label is 1.0 iff it begins with '1'; tokens WITH a ':' append
// feature id EncodeFeaGrpID(idx, gid % 4096, 12) to the current row. The
// Python parser (difacto_tpu_torch/data/parsers.py:parse_adfea) is the semantic
// reference and the fallback.
//
// Contract (single pass, caller allocates worst-case buffers):
//   labels[max_rows], offset[max_rows+1], index[max_nnz]
//   max_rows >= number of non-':' tokens / 3 + 1,
//   max_nnz  >= number of ':' characters.
// Values are always binary (no value array). Returns 0 on success, -1 on
// malformed input (non-numeric idx/gid).

#include <cctype>
#include <cstdint>
#include <cstdlib>

namespace {

inline const char* skip_sep(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

}  // namespace

extern "C" int difacto_parse_adfea(
    const char* data, int64_t len,
    float* labels, int64_t* offset, uint64_t* index,
    int64_t* out_rows, int64_t* out_nnz) {
  const char* p = data;
  const char* end = data + len;
  int64_t rows = 0, nnz = 0;
  int head_pos = 0;  // cycles 0:lineid 1:count 2:label
  offset[0] = 0;

  while (p < end) {
    p = skip_sep(p, end);
    if (p >= end) break;
    const char* tok = p;
    const char* colon = nullptr;
    while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') {
      if (*p == ':') colon = p;
      ++p;
    }
    if (colon) {
      char* next = nullptr;
      uint64_t idx = strtoull(tok, &next, 10);
      if (next != colon) return -1;
      uint64_t gid = strtoull(colon + 1, &next, 10);
      if (next != p) return -1;
      index[nnz++] = (idx << 12) | (gid % 4096);
      if (rows > 0) offset[rows] = nnz;
    } else {
      if (head_pos == 2) {
        head_pos = 0;
        labels[rows] = (*tok == '1') ? 1.0f : 0.0f;
        ++rows;
        offset[rows] = nnz;
      } else {
        ++head_pos;
      }
    }
  }
  *out_rows = rows;
  *out_nnz = nnz;
  return 0;
}
