// st_mmap — zero-copy safetensors reader (mmap + minimal header parser).
//
// The port's copy of native/st_mmap.cpp, built with g++ at first use by
// core/native.py into csrc/build/.  A checkpoint's payload is mapped, not
// read: torch tensors alias the mapping (torch.frombuffer), so a load costs
// one header parse plus demand paging (MADV_WILLNEED readahead), and the copy
// to the card reads the page cache.  The mapping is private (copy-on-write):
// a tensor may be written in place without touching the file, as with the
// pure-Python reader's ACCESS_COPY mapping (core/weights.py).
//
// C ABI (consumed from Python via ctypes — see core/native.py):
//   st_open(path) -> handle | NULL
//   st_error() -> last error string
//   st_count(h) -> number of tensors
//   st_name(h, i) -> tensor name
//   st_dtype(h, i) -> dtype string ("F32", "BF16", "U8", ...)
//   st_ndim(h, i), st_shape(h, i, out[ST_MAX_DIMS])
//   st_data(h, i, &nbytes) -> pointer into the mapping
//   st_close(h)
//
// The header is the 8-byte LE length + JSON object mandated by the
// safetensors format; we parse just what the format can contain (strings,
// ints, arrays, nested objects) with a small recursive-descent parser.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

#define ST_MAX_DIMS 8

namespace {

thread_local std::string g_error;

struct TensorInfo {
  std::string name;
  std::string dtype;
  std::vector<int64_t> shape;
  uint64_t begin = 0;
  uint64_t end = 0;
};

struct StFile {
  int fd = -1;
  uint8_t *map = nullptr;
  size_t map_len = 0;
  uint64_t data_base = 0;  // offset of the tensor-data region
  std::vector<TensorInfo> tensors;
};

// --- minimal JSON scanner (just enough for safetensors headers) ---
struct Parser {
  const char *p;
  const char *end;
  bool ok = true;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }
  bool expect(char c) {
    skip_ws();
    if (p < end && *p == c) { p++; return true; }
    ok = false;
    return false;
  }
  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }
  std::string parse_string() {
    skip_ws();
    std::string out;
    if (p >= end || *p != '"') { ok = false; return out; }
    p++;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) { p++; out.push_back(*p++); }
      else out.push_back(*p++);
    }
    if (p < end) p++;  // closing quote
    else ok = false;
    return out;
  }
  int64_t parse_int() {
    skip_ws();
    int64_t v = 0;
    bool neg = false;
    if (p < end && *p == '-') { neg = true; p++; }
    if (p >= end || *p < '0' || *p > '9') { ok = false; return 0; }
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    return neg ? -v : v;
  }
  // Skip any JSON value (used for __metadata__).
  void skip_value() {
    skip_ws();
    if (p >= end) { ok = false; return; }
    char c = *p;
    if (c == '"') { parse_string(); return; }
    if (c == '{') {
      p++;
      skip_ws();
      if (peek('}')) { p++; return; }
      while (ok) {
        parse_string();
        expect(':');
        skip_value();
        skip_ws();
        if (peek(',')) { p++; continue; }
        expect('}');
        break;
      }
      return;
    }
    if (c == '[') {
      p++;
      skip_ws();
      if (peek(']')) { p++; return; }
      while (ok) {
        skip_value();
        skip_ws();
        if (peek(',')) { p++; continue; }
        expect(']');
        break;
      }
      return;
    }
    // number / true / false / null
    while (p < end && *p != ',' && *p != '}' && *p != ']') p++;
  }
};

bool parse_header(StFile *f, const char *json, size_t len) {
  Parser ps{json, json + len};
  if (!ps.expect('{')) { g_error = "header: not an object"; return false; }
  ps.skip_ws();
  if (ps.peek('}')) return true;
  while (ps.ok) {
    std::string key = ps.parse_string();
    ps.expect(':');
    if (key == "__metadata__") {
      ps.skip_value();
    } else {
      TensorInfo t;
      t.name = key;
      if (!ps.expect('{')) break;
      while (ps.ok) {
        std::string field = ps.parse_string();
        ps.expect(':');
        if (field == "dtype") {
          t.dtype = ps.parse_string();
        } else if (field == "shape") {
          ps.expect('[');
          ps.skip_ws();
          if (!ps.peek(']')) {
            while (ps.ok) {
              t.shape.push_back(ps.parse_int());
              ps.skip_ws();
              if (ps.peek(',')) { ps.p++; continue; }
              break;
            }
          }
          ps.expect(']');
        } else if (field == "data_offsets") {
          ps.expect('[');
          t.begin = (uint64_t)ps.parse_int();
          ps.expect(',');
          t.end = (uint64_t)ps.parse_int();
          ps.expect(']');
        } else {
          ps.skip_value();
        }
        ps.skip_ws();
        if (ps.peek(',')) { ps.p++; continue; }
        ps.expect('}');
        break;
      }
      f->tensors.push_back(std::move(t));
    }
    ps.skip_ws();
    if (ps.peek(',')) { ps.p++; continue; }
    ps.expect('}');
    break;
  }
  if (!ps.ok) g_error = "header: parse error";
  return ps.ok;
}

}  // namespace

extern "C" {

const char *st_error() { return g_error.c_str(); }

void *st_open(const char *path) {
  g_error.clear();
  StFile *f = new StFile();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { g_error = "open failed"; delete f; return nullptr; }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size < 8) {
    g_error = "stat failed / file too small";
    close(f->fd);
    delete f;
    return nullptr;
  }
  f->map_len = (size_t)st.st_size;
  f->map = (uint8_t *)mmap(nullptr, f->map_len, PROT_READ | PROT_WRITE, MAP_PRIVATE, f->fd, 0);
  if (f->map == MAP_FAILED) {
    g_error = "mmap failed";
    close(f->fd);
    delete f;
    return nullptr;
  }
  madvise(f->map, f->map_len, MADV_WILLNEED);
  uint64_t header_len;
  memcpy(&header_len, f->map, 8);
  if (8 + header_len > f->map_len) {
    g_error = "header length out of range";
    munmap(f->map, f->map_len);
    close(f->fd);
    delete f;
    return nullptr;
  }
  f->data_base = 8 + header_len;
  if (!parse_header(f, (const char *)f->map + 8, header_len)) {
    munmap(f->map, f->map_len);
    close(f->fd);
    delete f;
    return nullptr;
  }
  // Bounds-check every tensor against the mapping.
  for (const auto &t : f->tensors) {
    if (t.end < t.begin || f->data_base + t.end > f->map_len || t.shape.size() > ST_MAX_DIMS) {
      g_error = "tensor '" + t.name + "': offsets out of range or more than 8 dims";
      munmap(f->map, f->map_len);
      close(f->fd);
      delete f;
      return nullptr;
    }
  }
  return f;
}

int64_t st_count(void *h) { return (int64_t)((StFile *)h)->tensors.size(); }

const char *st_name(void *h, int64_t i) {
  return ((StFile *)h)->tensors[i].name.c_str();
}

const char *st_dtype(void *h, int64_t i) {
  return ((StFile *)h)->tensors[i].dtype.c_str();
}

int64_t st_ndim(void *h, int64_t i) {
  return (int64_t)((StFile *)h)->tensors[i].shape.size();
}

void st_shape(void *h, int64_t i, int64_t *out) {
  const auto &s = ((StFile *)h)->tensors[i].shape;
  for (size_t d = 0; d < s.size(); d++) out[d] = s[d];
}

const uint8_t *st_data(void *h, int64_t i, int64_t *nbytes) {
  StFile *f = (StFile *)h;
  const auto &t = f->tensors[i];
  *nbytes = (int64_t)(t.end - t.begin);
  return f->map + f->data_base + t.begin;
}

void st_close(void *h) {
  StFile *f = (StFile *)h;
  if (f->map) munmap(f->map, f->map_len);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

}  // extern "C"
