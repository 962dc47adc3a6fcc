// Bulk .npz sample loader (the port's copy of the JAX package's
// native/npz_loader.cpp, which also reports which archives it read).
//
// A split is materialised once at startup into stacked arrays; this loader
// makes that bulk load fast: it parses uncompressed .npz (zip of .npy
// members) directly and copies each sample's array into its slot of a
// preallocated output buffer, fanning the files out over a thread pool.
//
// Supported: classic (non-zip64) archives, stored (uncompressed) members,
// C-order '<f4' arrays and '<i4'/'<i8' scalars: what numpy.savez writes for
// the port's sample files. For any other archive the entry points leave the
// slot alone and clear its ok flag; the caller reads that archive in Python.
//
// Build (focal_tpu_torch/native/__init__.py does it on first use):
//   g++ -O3 -shared -fPIC -std=c++17 -o libnpz_loader.so npz_loader.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  std::vector<unsigned char> data;
  bool ok = false;
};

Buffer read_file(const char* path) {
  Buffer buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.data.resize(static_cast<size_t>(size));
  buf.ok = std::fread(buf.data.data(), 1, buf.data.size(), f) == buf.data.size();
  std::fclose(f);
  return buf;
}

uint16_t rd16(const unsigned char* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// Locate a stored member's payload inside a classic zip. Returns nullptr on
// any structural surprise (zip64, compression, member missing).
const unsigned char* find_member(const Buffer& buf, const std::string& want,
                                 size_t* payload_size) {
  const unsigned char* d = buf.data.data();
  const size_t n = buf.data.size();
  if (n < 22) return nullptr;

  // end-of-central-directory: scan backwards for PK\x05\x06
  size_t eocd = n - 22;
  while (true) {
    if (rd32(d + eocd) == 0x06054b50) break;
    if (eocd == 0) return nullptr;
    --eocd;
  }
  uint16_t n_entries = rd16(d + eocd + 10);
  uint32_t cd_offset = rd32(d + eocd + 16);
  if (cd_offset == 0xFFFFFFFFu) return nullptr;  // zip64

  size_t pos = cd_offset;
  for (uint16_t i = 0; i < n_entries; ++i) {
    if (pos + 46 > n || rd32(d + pos) != 0x02014b50) return nullptr;
    uint16_t method = rd16(d + pos + 10);
    uint32_t comp_size = rd32(d + pos + 20);
    uint16_t name_len = rd16(d + pos + 28);
    uint16_t extra_len = rd16(d + pos + 30);
    uint16_t comment_len = rd16(d + pos + 32);
    uint32_t local_off = rd32(d + pos + 42);
    std::string name(reinterpret_cast<const char*>(d + pos + 46), name_len);
    if (name == want) {
      if (method != 0) return nullptr;  // compressed
      if (local_off + 30 > n || rd32(d + local_off) != 0x04034b50) return nullptr;
      uint16_t lname = rd16(d + local_off + 26);
      uint16_t lextra = rd16(d + local_off + 28);
      size_t data_off = local_off + 30 + lname + lextra;
      if (data_off + comp_size > n) return nullptr;
      *payload_size = comp_size;
      return d + data_off;
    }
    pos += 46 + name_len + extra_len + comment_len;
  }
  return nullptr;
}

// Parse a .npy payload; returns pointer to raw element data and fills dtype
// string + element count. Requires C-order.
const unsigned char* parse_npy(const unsigned char* p, size_t size,
                               std::string* descr, size_t* data_bytes) {
  if (size < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) return nullptr;
  uint8_t major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = rd16(p + 8);
    header_off = 10;
  } else {
    header_len = rd32(p + 8);
    header_off = 12;
  }
  if (header_off + header_len > size) return nullptr;
  std::string header(reinterpret_cast<const char*>(p + header_off), header_len);
  if (header.find("'fortran_order': True") != std::string::npos) return nullptr;
  size_t dpos = header.find("'descr':");
  if (dpos == std::string::npos) return nullptr;
  size_t q1 = header.find('\'', dpos + 8);
  size_t q2 = header.find('\'', q1 + 1);
  *descr = header.substr(q1 + 1, q2 - q1 - 1);
  *data_bytes = size - header_off - header_len;
  return p + header_off + header_len;
}

}  // namespace

extern "C" {

// Load `key` (without .npy suffix) from each of n_paths archives into
// out[i * sample_elems ...] as float32, ok[i] 1 where archive i was read and
// 0 where not (its slot untouched). Returns the number of failed files.
int load_npz_batch_f32(const char** paths, long long n_paths, const char* key,
                       float* out, long long sample_elems, unsigned char* ok_out,
                       int n_threads) {
  std::string member = std::string(key) + ".npy";
  std::atomic<long long> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    while (true) {
      long long i = next.fetch_add(1);
      if (i >= n_paths) return;
      Buffer buf = read_file(paths[i]);
      bool ok = false;
      if (buf.ok) {
        size_t payload = 0;
        const unsigned char* m = find_member(buf, member, &payload);
        if (m) {
          std::string descr;
          size_t bytes = 0;
          const unsigned char* data = parse_npy(m, payload, &descr, &bytes);
          if (data && descr == "<f4" &&
              bytes == static_cast<size_t>(sample_elems) * 4) {
            std::memcpy(out + i * sample_elems, data, bytes);
            ok = true;
          }
        }
      }
      ok_out[i] = ok;
      if (!ok) failures.fetch_add(1);
    }
  };

  int t = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> threads;
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

// Load an integer scalar `key` from each archive into out[i], ok[i] as
// above. Accepts '<i4' and '<i8'. Returns the number of failures; failed
// slots get INT64_MIN.
int load_npz_scalar_i64(const char** paths, long long n_paths, const char* key,
                        long long* out, unsigned char* ok_out, int n_threads) {
  std::string member = std::string(key) + ".npy";
  std::atomic<long long> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    while (true) {
      long long i = next.fetch_add(1);
      if (i >= n_paths) return;
      Buffer buf = read_file(paths[i]);
      bool ok = false;
      if (buf.ok) {
        size_t payload = 0;
        const unsigned char* m = find_member(buf, member, &payload);
        if (m) {
          std::string descr;
          size_t bytes = 0;
          const unsigned char* data = parse_npy(m, payload, &descr, &bytes);
          if (data && descr == "<i4" && bytes >= 4) {
            int32_t v;
            std::memcpy(&v, data, 4);
            out[i] = v;
            ok = true;
          } else if (data && descr == "<i8" && bytes >= 8) {
            std::memcpy(out + i, data, 8);
            ok = true;
          }
        }
      }
      ok_out[i] = ok;
      if (!ok) {
        out[i] = INT64_MIN;
        failures.fetch_add(1);
      }
    }
  };

  int t = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> threads;
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
