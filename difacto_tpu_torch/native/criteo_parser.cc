// Fast Criteo CTR chunk parser (C ABI, bound via ctypes).
//
// Native equivalent of the reference's CriteoParser
// (src/reader/criteo_parser.h:25-115): tab-separated
// "<label> <13 int fields> <26 categorical fields>", each non-empty field
// hashed to 64 bits with its column id packed in the low 12 bits
// (EncodeFeaGrpID, include/difacto/base.h:60-63). The reference hashes
// with CityHash64; we use MurmurHash64A (public-domain algorithm,
// implemented from its specification) — any stable uniform 64-bit hash
// preserves the semantics, and the Python fallback
// (difacto_tpu_torch/data/parsers.py) implements the identical function.
//
// Returns 0 on success; rows with fewer fields are padded as empty
// (missing fields contribute no feature), matching the Python parser.

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t murmur64a(const char* key, int len, uint64_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (static_cast<uint64_t>(len) * m);
  const int nblocks = len / 8;
  for (int i = 0; i < nblocks; ++i) {
    uint64_t k;
    memcpy(&k, key + i * 8, 8);
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  const unsigned char* tail =
      reinterpret_cast<const unsigned char*>(key + nblocks * 8);
  switch (len & 7) {
    case 7: h ^= static_cast<uint64_t>(tail[6]) << 48; [[fallthrough]];
    case 6: h ^= static_cast<uint64_t>(tail[5]) << 40; [[fallthrough]];
    case 5: h ^= static_cast<uint64_t>(tail[4]) << 32; [[fallthrough]];
    case 4: h ^= static_cast<uint64_t>(tail[3]) << 24; [[fallthrough]];
    case 3: h ^= static_cast<uint64_t>(tail[2]) << 16; [[fallthrough]];
    case 2: h ^= static_cast<uint64_t>(tail[1]) << 8;  [[fallthrough]];
    case 1: h ^= static_cast<uint64_t>(tail[0]); h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

constexpr int kNumFields = 39;   // 13 ints + 26 categoricals
constexpr int kGrpBits = 12;

}  // namespace

extern "C" uint64_t difacto_murmur64a(const char* key, int64_t len,
                                      uint64_t seed) {
  return murmur64a(key, static_cast<int>(len), seed);
}

extern "C" int difacto_parse_criteo(
    const char* data, int64_t len, int is_train,
    float* labels, int64_t* offset, uint64_t* index,
    int64_t max_rows, int64_t max_nnz,
    int64_t* out_rows, int64_t* out_nnz) {
  const char* p = data;
  const char* end = data + len;
  int64_t rows = 0, nnz = 0;
  offset[0] = 0;

  while (p < end) {
    const char* eol = static_cast<const char*>(
        memchr(p, '\n', end - p));
    if (eol == nullptr) eol = end;
    // skip empty lines, including CRLF blanks ("\r\n"), like the Python
    // fallback's strip
    if (eol == p || (eol == p + 1 && *p == '\r')) { p = eol + 1; continue; }
    if (rows >= max_rows) return -2;  // caller under-sized the buffers

    int field = 0;  // 0 = label (when is_train), then features
    int first_feature_field = is_train ? 1 : 0;
    const char* fs = p;  // field start
    float label = 0.0f;
    for (const char* q = p; ; ++q) {
      if (q == eol || *q == '\t') {
        int flen = static_cast<int>(q - fs);
        if (flen > 0 && fs[flen - 1] == '\r') --flen;
        int fidx = field - first_feature_field;  // feature column id
        if (field < first_feature_field) {
          // label field
          label = 0.0f;
          if (flen > 0) {
            // criteo labels are "0"/"1"; parse leading int, sign aware
            bool neg = fs[0] == '-';
            int64_t v = 0;
            for (int i = neg ? 1 : 0; i < flen; ++i) {
              if (fs[i] < '0' || fs[i] > '9') break;
              v = v * 10 + (fs[i] - '0');
            }
            label = static_cast<float>(neg ? -v : v);
          }
        } else if (fidx < kNumFields && flen > 0) {
          if (nnz >= max_nnz) return -2;  // under-sized buffer
          uint64_t h = murmur64a(fs, flen, 0);
          index[nnz++] = (h << kGrpBits)
              | static_cast<uint64_t>(fidx);
        }
        ++field;
        fs = q + 1;
        if (q == eol) break;
      }
    }
    labels[rows] = label;
    ++rows;
    offset[rows] = nnz;
    p = eol + 1;
  }

  *out_rows = rows;
  *out_nnz = nnz;
  return 0;
}
