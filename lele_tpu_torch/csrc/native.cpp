// native.cpp: the port's host-side C++ (runtime/native.py), a plain C
// interface loaded with ctypes. Built by kernels/_build.py with g++ (not
// nvcc): it touches no card.
//
//   lele_decode_wav        RIFF/WAVE bytes -> mono float32 samples + rate
//                          (PCM 8/16/24/32, IEEE float 32/64, channels
//                          averaged), as utils/wav.decode_wav_bytes
//   lele_decode_wav_files  the batch loader: each file read and decoded on a
//                          pool of threads (ctypes releases the GIL for the
//                          call)
//   lele_content_hash      FNV-1a 64 of a byte string
//   lele_scan_initializers one pass over an ONNX ModelProto's wire format:
//                          each graph initializer's name, dtype, dims and the
//                          file offset and length of its raw_data
//
// Buffers the library allocates (samples, scan records) are freed by
// lele_free. Every parse checks its lengths against the buffer: malformed
// input gives an error, never a read past the end.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t len;
  size_t pos = 0;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (pos < len) {
      uint8_t b = p[pos++];
      v |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 70) break;
    }
    ok = false;
    return 0;
  }

  // a length-delimited field's length, only if its payload fits
  uint64_t ld_len() {
    uint64_t n = varint();
    if (!ok || n > len - pos) {
      ok = false;
      return 0;
    }
    return n;
  }

  void skip(uint32_t wt) {
    switch (wt) {
      case 0: varint(); break;
      case 1: pos += 8; break;
      case 2: { uint64_t n = ld_len(); pos += n; break; }
      case 5: pos += 4; break;
      default: ok = false;
    }
    if (pos > len) ok = false;
  }
};

struct TensorMeta {
  std::string name;
  int32_t dtype = 0;
  std::vector<int64_t> dims;
  size_t data_off = 0;  // absolute offset of the raw_data payload
  size_t data_len = 0;
  bool has_raw = false;
  bool ok = true;
};

// one TensorProto body at [base, base + n) of the file
TensorMeta parse_tensor(const uint8_t* file, size_t base, size_t n) {
  TensorMeta t;
  Reader r{file + base, n};
  while (r.ok && r.pos < r.len) {
    uint64_t tag = r.varint();
    uint32_t fnum = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    if (fnum == 1 && wt == 0) {  // dims, unpacked
      t.dims.push_back((int64_t)r.varint());
    } else if (fnum == 1 && wt == 2) {  // dims, packed
      uint64_t ln = r.ld_len();
      size_t end = r.pos + ln;
      while (r.ok && r.pos < end) t.dims.push_back((int64_t)r.varint());
    } else if (fnum == 2 && wt == 0) {  // data_type
      t.dtype = (int32_t)r.varint();
    } else if (fnum == 8 && wt == 2) {  // name
      uint64_t ln = r.ld_len();
      if (!r.ok) break;
      t.name.assign((const char*)r.p + r.pos, ln);
      r.pos += ln;
    } else if (fnum == 9 && wt == 2) {  // raw_data
      uint64_t ln = r.ld_len();
      if (!r.ok) break;
      t.data_off = base + r.pos;
      t.data_len = ln;
      t.has_raw = true;
      r.pos += ln;
    } else {
      r.skip(wt);
    }
    if (r.pos > r.len) break;
  }
  t.ok = r.ok;
  return t;
}

// GraphProto -> initializer (field 5); nested subgraphs are not walked
bool scan_graph(const uint8_t* file, size_t base, size_t n, std::vector<TensorMeta>* out) {
  Reader r{file + base, n};
  while (r.ok && r.pos < r.len) {
    uint64_t tag = r.varint();
    uint32_t fnum = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    if (fnum == 5 && wt == 2) {
      uint64_t ln = r.ld_len();
      if (!r.ok) break;
      TensorMeta t = parse_tensor(file, base + r.pos, ln);
      if (!t.ok) return false;
      out->push_back(std::move(t));
      r.pos += ln;
    } else {
      r.skip(wt);
    }
  }
  return r.ok;
}

void set_err(char* err, size_t errlen, const std::string& msg) {
  if (!err || !errlen) return;
  size_t n = msg.size() < errlen - 1 ? msg.size() : errlen - 1;
  memcpy(err, msg.data(), n);
  err[n] = 0;
}

// the decoder proper: no allocation but `out`, callable from any thread
const char* decode_wav_core(const uint8_t* d, size_t n, std::vector<float>* out,
                            uint32_t* out_sr) {
  if (n < 12 || memcmp(d, "RIFF", 4) || memcmp(d + 8, "WAVE", 4)) return "not a RIFF/WAVE file";
  uint16_t fmt = 0, n_ch = 0, bits = 0;
  uint32_t sr = 0;
  bool have_fmt = false;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;
  size_t pos = 12;
  while (pos + 8 <= n) {
    uint32_t size;
    memcpy(&size, d + pos + 4, 4);
    const uint8_t* body = d + pos + 8;
    size_t avail = n - pos - 8;  // the bytes present for this chunk's body
    if (!memcmp(d + pos, "fmt ", 4)) {
      if (size < 16 || avail < 16) return "truncated fmt chunk";
      memcpy(&fmt, body, 2);
      memcpy(&n_ch, body + 2, 2);
      memcpy(&sr, body + 4, 4);
      memcpy(&bits, body + 14, 2);
      if (fmt == 0xFFFE) {  // extensible: the format code leads the SubFormat GUID
        if (size >= 26 && avail >= 26) memcpy(&fmt, body + 24, 2);
        else fmt = 1;
      }
      have_fmt = true;
    } else if (!memcmp(d + pos, "data", 4)) {
      pcm = body;
      pcm_len = size < avail ? size : avail;
    }
    size_t step = (size_t)size + (size & 1);
    if (step >= avail) break;  // the declared size runs past the buffer
    pos += 8 + step;
  }
  if (!have_fmt || !pcm) return "missing fmt/data chunk";
  bool ok = (fmt == 3 && (bits == 32 || bits == 64)) ||
            (fmt == 1 && (bits == 8 || bits == 16 || bits == 24 || bits == 32));
  if (!ok) return "unsupported WAV format or bit depth";
  if (!n_ch) return "zero channels";
  size_t bytes_per = bits / 8;
  size_t frames = pcm_len / (bytes_per * n_ch);
  out->resize(frames);
  for (size_t i = 0; i < frames; ++i) {
    float acc = 0.0f;  // in f32, in channel order, as numpy's f32 mean
    for (uint16_t c = 0; c < n_ch; ++c) {
      const uint8_t* s = pcm + (i * n_ch + c) * bytes_per;
      float v = 0.0f;
      if (fmt == 3 && bits == 32) {
        float f;
        memcpy(&f, s, 4);
        v = f;
      } else if (fmt == 3) {
        double f;
        memcpy(&f, s, 8);
        v = (float)f;  // each sample cast to f32 first, as the Python parser
      } else if (bits == 16) {
        int16_t x;
        memcpy(&x, s, 2);
        v = (float)x / 32768.0f;
      } else if (bits == 32) {
        int32_t x;
        memcpy(&x, s, 4);
        v = (float)x / 2147483648.0f;
      } else if (bits == 24) {
        int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
        if (x >= (1 << 23)) x -= (1 << 24);
        v = (float)x / 8388608.0f;
      } else {
        v = ((float)s[0] - 128.0f) / 128.0f;
      }
      acc = c == 0 ? v : acc + v;
    }
    (*out)[i] = n_ch == 1 ? acc : acc / (float)n_ch;
  }
  *out_sr = sr;
  return nullptr;
}

bool read_file(const std::string& path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long sz = ok ? ftell(f) : -1;
  ok = ok && sz >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize((size_t)sz);
    ok = sz == 0 || fread(buf->data(), 1, (size_t)sz, f) == (size_t)sz;
  }
  fclose(f);
  return ok;
}

float* copy_out(const std::vector<float>& v) {
  float* p = (float*)malloc(v.size() ? v.size() * sizeof(float) : 1);
  if (p && !v.empty()) memcpy(p, v.data(), v.size() * sizeof(float));
  return p;
}

void put(std::vector<uint8_t>* out, const void* p, size_t n) {
  const uint8_t* b = (const uint8_t*)p;
  out->insert(out->end(), b, b + n);
}

}  // namespace

extern "C" {

void lele_free(void* p) { free(p); }

// one WAV: 0 and *out (lele_free it), *n_out samples, *sr; else 1 and err
int lele_decode_wav(const uint8_t* d, size_t n, float** out, size_t* n_out, uint32_t* sr,
                    char* err, size_t errlen) {
  std::vector<float> pcm;
  const char* e = decode_wav_core(d, n, &pcm, sr);
  if (e) {
    set_err(err, errlen, e);
    return 1;
  }
  *out = copy_out(pcm);
  *n_out = pcm.size();
  return *out ? 0 : 2;
}

// n files on min(n_threads, n) threads: -1 and outs / lens / srs (each
// outs[i] to lele_free); else the index of the first file that failed (in
// the list's order), with its error and path in err, and every outs[i]
// null
long long lele_decode_wav_files(const char** paths, long long n, int n_threads, float** outs,
                                size_t* lens, uint32_t* srs, char* err, size_t errlen) {
  struct Slot {
    std::vector<float> pcm;
    std::string err;
  };
  std::vector<Slot> slots((size_t)n);
  size_t threads = n_threads > 0 ? (size_t)n_threads : 1;
  if (threads > (size_t)n) threads = (size_t)n;
  std::vector<std::thread> pool;
  for (size_t t = 0; t < threads; ++t) {
    pool.emplace_back([&, t]() {
      std::vector<uint8_t> buf;
      for (size_t i = t; i < (size_t)n; i += threads) {
        Slot& s = slots[i];
        if (!read_file(paths[i], &buf)) {
          s.err = std::string("cannot read ") + paths[i];
          continue;
        }
        const char* e = decode_wav_core(buf.data(), buf.size(), &s.pcm, &srs[i]);
        if (e) s.err = std::string(e) + ": " + paths[i];
      }
    });
  }
  for (auto& th : pool) th.join();
  for (long long i = 0; i < n; ++i) {
    outs[i] = nullptr;
    if (!slots[(size_t)i].err.empty()) {
      set_err(err, errlen, slots[(size_t)i].err);
      return i;
    }
  }
  for (long long i = 0; i < n; ++i) {
    outs[i] = copy_out(slots[(size_t)i].pcm);
    lens[i] = slots[(size_t)i].pcm.size();
  }
  return -1;
}

uint64_t lele_content_hash(const uint8_t* d, size_t n) {
  uint64_t h = 1469598103934665603ULL;  // FNV-1a 64
  for (size_t i = 0; i < n; ++i) {
    h ^= d[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// the initializers of every ModelProto.graph: the record count and *out
// (lele_free it, *out_len bytes) of records
//   u32 name length, name, i32 dtype, u32 ndims, i64 dims[ndims],
//   i64 raw_data offset (-1 without raw_data), i64 raw_data length;
// -1 for malformed input (a length past the end, a bad wire type)
long long lele_scan_initializers(const uint8_t* file, size_t len, uint8_t** out,
                                 size_t* out_len) {
  std::vector<TensorMeta> metas;
  Reader r{file, len};
  bool graphs_ok = true;
  while (r.ok && r.pos < r.len) {
    uint64_t tag = r.varint();
    uint32_t fnum = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    if (fnum == 7 && wt == 2) {  // ModelProto.graph
      uint64_t ln = r.ld_len();
      if (!r.ok) break;
      graphs_ok = scan_graph(file, r.pos, ln, &metas) && graphs_ok;
      r.pos += ln;
    } else {
      r.skip(wt);
    }
  }
  for (const TensorMeta& t : metas)
    if (t.has_raw && (t.data_off > len || t.data_len > len - t.data_off)) graphs_ok = false;
  if (!r.ok || !graphs_ok) return -1;
  std::vector<uint8_t> rec;
  for (const TensorMeta& t : metas) {
    uint32_t nl = (uint32_t)t.name.size(), nd = (uint32_t)t.dims.size();
    int64_t off = t.has_raw ? (int64_t)t.data_off : -1, ln = (int64_t)t.data_len;
    put(&rec, &nl, 4);
    put(&rec, t.name.data(), nl);
    put(&rec, &t.dtype, 4);
    put(&rec, &nd, 4);
    put(&rec, t.dims.data(), nd * 8);
    put(&rec, &off, 8);
    put(&rec, &ln, 8);
  }
  *out = (uint8_t*)malloc(rec.size() ? rec.size() : 1);
  if (!*out) return -1;
  if (!rec.empty()) memcpy(*out, rec.data(), rec.size());
  *out_len = rec.size();
  return (long long)metas.size();
}

}  // extern "C"
