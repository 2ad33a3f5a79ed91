// .npy / .npz (stored zip) reader + .npy writer.
//
// The params file written by static/io.py save_inference_model is a
// numpy .npz: an uncompressed ZIP whose members are <var name>.npy. The
// native predictor reads it directly (reference analogue: the C++
// LoadPersistables path, paddle/fluid/inference/api/api_impl.cc). Only
// ZIP_STORED members are supported — np.savez never compresses.
#pragma once
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace npy {

enum class DType { F32, F64, I32, I64, U8, BOOL, I8 };

inline size_t dtype_size(DType t) {
  switch (t) {
    case DType::F32: case DType::I32: return 4;
    case DType::F64: case DType::I64: return 8;
    case DType::U8: case DType::BOOL: case DType::I8: return 1;
  }
  return 0;
}

struct Array {
  DType dtype = DType::F32;
  std::vector<int64_t> shape;
  std::vector<char> data;

  int64_t numel() const {
    int64_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
  float* f32() { return reinterpret_cast<float*>(data.data()); }
  const float* f32() const { return reinterpret_cast<const float*>(data.data()); }
  int32_t* i32() { return reinterpret_cast<int32_t*>(data.data()); }
  int64_t* i64() { return reinterpret_cast<int64_t*>(data.data()); }
  const int64_t* i64() const { return reinterpret_cast<const int64_t*>(data.data()); }
};

inline DType parse_descr(const std::string& descr) {
  // little-endian or byte-order-less descriptors only (TPU hosts are LE)
  if (descr == "<f4" || descr == "=f4" || descr == "f4") return DType::F32;
  if (descr == "<f8" || descr == "=f8" || descr == "f8") return DType::F64;
  if (descr == "<i4" || descr == "=i4" || descr == "i4") return DType::I32;
  if (descr == "<i8" || descr == "=i8" || descr == "i8") return DType::I64;
  if (descr == "|u1" || descr == "u1") return DType::U8;
  if (descr == "|b1" || descr == "b1") return DType::BOOL;
  if (descr == "|i1" || descr == "i1") return DType::I8;
  throw std::runtime_error("npy: unsupported descr '" + descr + "'");
}

inline const char* descr_of(DType t) {
  switch (t) {
    case DType::F32: return "<f4";
    case DType::F64: return "<f8";
    case DType::I32: return "<i4";
    case DType::I64: return "<i8";
    case DType::U8: return "|u1";
    case DType::BOOL: return "|b1";
    case DType::I8: return "|i1";
  }
  return "<f4";
}

// Parse one .npy blob (already in memory).
inline Array parse_npy(const char* buf, size_t len) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0)
    throw std::runtime_error("npy: bad magic");
  uint8_t major = (uint8_t)buf[6];
  size_t hlen, hoff;
  if (major == 1) {
    uint16_t h;
    memcpy(&h, buf + 8, 2);
    hlen = h; hoff = 10;
  } else {  // version 2/3: 4-byte header length
    uint32_t h;
    memcpy(&h, buf + 8, 4);
    hlen = h; hoff = 12;
  }
  if (hoff + hlen > len) throw std::runtime_error("npy: truncated header");
  std::string header(buf + hoff, hlen);

  auto find_val = [&](const std::string& key) -> std::string {
    size_t k = header.find("'" + key + "'");
    if (k == std::string::npos)
      throw std::runtime_error("npy: header missing " + key);
    size_t c = header.find(':', k);
    size_t start = header.find_first_not_of(" ", c + 1);
    return header.substr(start);
  };

  Array a;
  {
    std::string v = find_val("descr");
    size_t q1 = v.find('\''), q2 = v.find('\'', q1 + 1);
    a.dtype = parse_descr(v.substr(q1 + 1, q2 - q1 - 1));
  }
  {
    std::string v = find_val("fortran_order");
    if (v.rfind("True", 0) == 0)
      throw std::runtime_error("npy: fortran_order unsupported");
  }
  {
    std::string v = find_val("shape");
    size_t p1 = v.find('('), p2 = v.find(')');
    std::string tup = v.substr(p1 + 1, p2 - p1 - 1);
    size_t pos = 0;
    while (pos < tup.size()) {
      size_t comma = tup.find(',', pos);
      std::string tok = tup.substr(pos, comma == std::string::npos
                                            ? std::string::npos : comma - pos);
      // trim
      size_t s = tok.find_first_not_of(" ");
      if (s != std::string::npos) {
        size_t e = tok.find_last_not_of(" ");
        tok = tok.substr(s, e - s + 1);
        if (!tok.empty()) a.shape.push_back(std::stoll(tok));
      }
      if (comma == std::string::npos) break;
      pos = comma + 1;
    }
  }
  size_t nbytes = (size_t)a.numel() * dtype_size(a.dtype);
  if (hoff + hlen + nbytes > len) throw std::runtime_error("npy: truncated data");
  a.data.assign(buf + hoff + hlen, buf + hoff + hlen + nbytes);
  return a;
}

inline Array load_npy(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("npy: cannot open " + path);
  std::vector<char> buf((std::istreambuf_iterator<char>(f)),
                        std::istreambuf_iterator<char>());
  return parse_npy(buf.data(), buf.size());
}

inline std::string npy_bytes(const Array& a);

inline void save_npy(const std::string& path, const Array& a) {
  std::ofstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("npy: cannot write " + path);
  std::string blob = npy_bytes(a);
  f.write(blob.data(), blob.size());
}

// Serialize one array to an in-memory .npy blob (for npz members).
inline std::string npy_bytes(const Array& a) {
  std::string shape = "(";
  for (size_t i = 0; i < a.shape.size(); ++i)
    shape += std::to_string(a.shape[i]) + (a.shape.size() == 1 ? "," :
             (i + 1 < a.shape.size() ? ", " : ""));
  shape += ")";
  std::string header = std::string("{'descr': '") + descr_of(a.dtype) +
      "', 'fortran_order': False, 'shape': " + shape + ", }";
  size_t total = 10 + header.size() + 1;
  size_t pad = (64 - total % 64) % 64;
  header += std::string(pad, ' ');
  header += '\n';
  std::string out;
  out.append("\x93NUMPY\x01\x00", 8);
  uint16_t hlen = (uint16_t)header.size();
  out.append(reinterpret_cast<const char*>(&hlen), 2);
  out += header;
  out.append(a.data.data(), a.data.size());
  return out;
}

// CRC-32 (zip polynomial), table-driven.
inline uint32_t crc32_of(const char* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = table[(crc ^ (uint8_t)data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// Write a numpy-compatible uncompressed .npz (ZIP_STORED members named
// <key>.npy) — the persistables format load_persistables reads back, so
// pt_train can hand trained params to the Python stack.
inline void save_npz(const std::string& path,
                     const std::map<std::string, Array>& arrays) {
  std::ofstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("npz: cannot write " + path);
  struct Entry { std::string name; uint32_t crc, size, offset; };
  std::vector<Entry> entries;
  uint32_t off = 0;
  for (auto& [key, arr] : arrays) {
    std::string name = key + ".npy";
    std::string blob = npy_bytes(arr);
    uint32_t crc = crc32_of(blob.data(), blob.size());
    uint32_t sz = (uint32_t)blob.size();
    // local file header
    const char sig[] = "PK\x03\x04";
    uint16_t version = 20, flags = 0, method = 0, mt = 0, md = 0x21;
    uint16_t nlen = (uint16_t)name.size(), elen = 0;
    f.write(sig, 4);
    f.write(reinterpret_cast<const char*>(&version), 2);
    f.write(reinterpret_cast<const char*>(&flags), 2);
    f.write(reinterpret_cast<const char*>(&method), 2);
    f.write(reinterpret_cast<const char*>(&mt), 2);
    f.write(reinterpret_cast<const char*>(&md), 2);
    f.write(reinterpret_cast<const char*>(&crc), 4);
    f.write(reinterpret_cast<const char*>(&sz), 4);
    f.write(reinterpret_cast<const char*>(&sz), 4);
    f.write(reinterpret_cast<const char*>(&nlen), 2);
    f.write(reinterpret_cast<const char*>(&elen), 2);
    f.write(name.data(), nlen);
    f.write(blob.data(), blob.size());
    entries.push_back({name, crc, sz, off});
    off += 30 + nlen + sz;
  }
  uint32_t cd_start = off, cd_size = 0;
  for (auto& e : entries) {
    const char sig[] = "PK\x01\x02";
    uint16_t vmade = 20, vneed = 20, flags = 0, method = 0, mt = 0,
             md = 0x21, nlen = (uint16_t)e.name.size(), z16 = 0;
    uint32_t z32 = 0;
    f.write(sig, 4);
    f.write(reinterpret_cast<const char*>(&vmade), 2);
    f.write(reinterpret_cast<const char*>(&vneed), 2);
    f.write(reinterpret_cast<const char*>(&flags), 2);
    f.write(reinterpret_cast<const char*>(&method), 2);
    f.write(reinterpret_cast<const char*>(&mt), 2);
    f.write(reinterpret_cast<const char*>(&md), 2);
    f.write(reinterpret_cast<const char*>(&e.crc), 4);
    f.write(reinterpret_cast<const char*>(&e.size), 4);
    f.write(reinterpret_cast<const char*>(&e.size), 4);
    f.write(reinterpret_cast<const char*>(&nlen), 2);
    f.write(reinterpret_cast<const char*>(&z16), 2);  // extra len
    f.write(reinterpret_cast<const char*>(&z16), 2);  // comment len
    f.write(reinterpret_cast<const char*>(&z16), 2);  // disk #
    f.write(reinterpret_cast<const char*>(&z16), 2);  // int attrs
    f.write(reinterpret_cast<const char*>(&z32), 4);  // ext attrs
    f.write(reinterpret_cast<const char*>(&e.offset), 4);
    f.write(e.name.data(), nlen);
    cd_size += 46 + nlen;
  }
  const char eocd[] = "PK\x05\x06";
  uint16_t z16 = 0, n = (uint16_t)entries.size();
  f.write(eocd, 4);
  f.write(reinterpret_cast<const char*>(&z16), 2);
  f.write(reinterpret_cast<const char*>(&z16), 2);
  f.write(reinterpret_cast<const char*>(&n), 2);
  f.write(reinterpret_cast<const char*>(&n), 2);
  f.write(reinterpret_cast<const char*>(&cd_size), 4);
  f.write(reinterpret_cast<const char*>(&cd_start), 4);
  f.write(reinterpret_cast<const char*>(&z16), 2);
}

// Read an uncompressed .npz: walk local file headers sequentially.
inline std::map<std::string, Array> load_npz(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("npz: cannot open " + path);
  std::vector<char> buf((std::istreambuf_iterator<char>(f)),
                        std::istreambuf_iterator<char>());
  std::map<std::string, Array> out;
  // a valid archive starts with a local-file header or (empty zip) the
  // end-of-central-directory record — anything else is not a zip
  if (buf.size() >= 4) {
    uint32_t sig0;
    memcpy(&sig0, buf.data(), 4);
    if (sig0 != 0x04034b50 && sig0 != 0x06054b50)
      throw std::runtime_error("npz: " + path + " is not a zip archive");
  } else {
    throw std::runtime_error("npz: " + path + " is truncated");
  }
  size_t p = 0;
  while (p + 30 <= buf.size()) {
    uint32_t sig;
    memcpy(&sig, buf.data() + p, 4);
    if (sig != 0x04034b50) break;  // end of local headers
    uint16_t method, namelen, extralen;
    uint32_t csize32, usize32;
    memcpy(&method, buf.data() + p + 8, 2);
    memcpy(&csize32, buf.data() + p + 18, 4);
    memcpy(&usize32, buf.data() + p + 22, 4);
    memcpy(&namelen, buf.data() + p + 26, 2);
    memcpy(&extralen, buf.data() + p + 28, 2);
    std::string name(buf.data() + p + 30, namelen);
    uint64_t csize = csize32, usize = usize32;
    // np.savez writes ZIP64 members: 0xFFFFFFFF sizes live in the
    // extra field (header id 0x0001: usize u64, then csize u64)
    if (csize32 == 0xFFFFFFFFu || usize32 == 0xFFFFFFFFu) {
      size_t e = p + 30 + namelen, eend = e + extralen;
      while (e + 4 <= eend) {
        uint16_t id, sz;
        memcpy(&id, buf.data() + e, 2);
        memcpy(&sz, buf.data() + e + 2, 2);
        if (id == 0x0001) {
          size_t q = e + 4;
          if (usize32 == 0xFFFFFFFFu && q + 8 <= eend) {
            memcpy(&usize, buf.data() + q, 8);
            q += 8;
          }
          if (csize32 == 0xFFFFFFFFu && q + 8 <= eend)
            memcpy(&csize, buf.data() + q, 8);
          break;
        }
        e += 4 + sz;
      }
      if (csize == 0xFFFFFFFFu)
        throw std::runtime_error("npz: zip64 sizes missing for " + name);
    }
    size_t dataoff = p + 30 + namelen + extralen;
    if (method != 0)
      throw std::runtime_error("npz: member '" + name +
                               "' is compressed (unsupported)");
    if (dataoff + csize > buf.size())
      throw std::runtime_error("npz: truncated member " + name);
    // strip the ".npy" suffix for the key (np.savez convention)
    std::string key = name.size() > 4 &&
        name.compare(name.size() - 4, 4, ".npy") == 0
        ? name.substr(0, name.size() - 4) : name;
    out[key] = parse_npy(buf.data() + dataoff, csize);
    p = dataoff + csize;
  }
  // an empty archive is valid: parameterless programs (pure-op heads
  // like yolo_box decode) save an npz with no members
  return out;
}

}  // namespace npy
