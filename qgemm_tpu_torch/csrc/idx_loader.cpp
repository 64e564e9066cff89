// Native idx-format dataset loader for qgemm_tpu.
//
// TPU-native analogue of the reference's C++ MNIST loader
// (src/utils/dataset_mnist.hh: magic checks :20-21, /255 normalization :56,
// big-endian dimension swap :76-83), built as a shared library consumed from
// Python via ctypes (qgemm_tpu/data/native.py). mmap + multithreaded
// normalization so host-side input processing never shadows device steps.
//
// Exported C ABI:
//   qg_idx_images_info(path, *n, *rows, *cols) -> 0/err
//   qg_idx_load_images(path, float* out)       -> 0/err  (normalized /255)
//   qg_idx_labels_info(path, *n)               -> 0/err
//   qg_idx_load_labels(path, int32* out)       -> 0/err
//   qg_shuffle_indices(int64* out, n, seed)     (Fisher-Yates, splitmix64)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int32_t kImageMagic = 2051;
constexpr int32_t kLabelMagic = 2049;

enum ErrCode : int {
  kOk = 0,
  kOpenFail = 1,
  kBadMagic = 2,
  kTruncated = 3,
};

int32_t be32(const uint8_t* p) {
  return (int32_t)((uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 |
                   (uint32_t)p[2] << 8 | (uint32_t)p[3]);
}

struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); fd = -1; return false; }
    size = (size_t)st.st_size;
    data = (const uint8_t*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (data == MAP_FAILED) { data = nullptr; ::close(fd); fd = -1; return false; }
    return true;
  }
  ~MappedFile() {
    if (data) munmap((void*)data, size);
    if (fd >= 0) ::close(fd);
  }
};

uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

int qg_idx_images_info(const char* path, int64_t* n, int64_t* rows, int64_t* cols) {
  MappedFile f;
  if (!f.open(path)) return kOpenFail;
  if (f.size < 16 || be32(f.data) != kImageMagic) return kBadMagic;
  *n = be32(f.data + 4);
  *rows = be32(f.data + 8);
  *cols = be32(f.data + 12);
  if (f.size < 16 + (size_t)(*n) * (*rows) * (*cols)) return kTruncated;
  return kOk;
}

int qg_idx_load_images(const char* path, float* out) {
  MappedFile f;
  if (!f.open(path)) return kOpenFail;
  if (f.size < 16 || be32(f.data) != kImageMagic) return kBadMagic;
  const int64_t n = be32(f.data + 4);
  const int64_t rows = be32(f.data + 8);
  const int64_t cols = be32(f.data + 12);
  const int64_t total = n * rows * cols;
  if (f.size < 16 + (size_t)total) return kTruncated;
  const uint8_t* src = f.data + 16;

  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t kMinChunk = 1 << 20;
  int64_t n_threads = hw ? hw : 1;
  if (total / kMinChunk < n_threads) n_threads = total / kMinChunk + 1;

  // 256-entry LUT computed with true division: bit-identical to numpy's
  // buf/255.0 (multiplying by the reciprocal differs in the last ulp).
  float lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = (float)i / 255.0f;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out[i] = lut[src[i]];
  };
  if (n_threads <= 1) {
    work(0, total);
  } else {
    std::vector<std::thread> ts;
    int64_t chunk = (total + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t lo = t * chunk;
      int64_t hi = lo + chunk < total ? lo + chunk : total;
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return kOk;
}

int qg_idx_labels_info(const char* path, int64_t* n) {
  MappedFile f;
  if (!f.open(path)) return kOpenFail;
  if (f.size < 8 || be32(f.data) != kLabelMagic) return kBadMagic;
  *n = be32(f.data + 4);
  if (f.size < 8 + (size_t)(*n)) return kTruncated;
  return kOk;
}

int qg_idx_load_labels(const char* path, int32_t* out) {
  MappedFile f;
  if (!f.open(path)) return kOpenFail;
  if (f.size < 8 || be32(f.data) != kLabelMagic) return kBadMagic;
  const int64_t n = be32(f.data + 4);
  if (f.size < 8 + (size_t)n) return kTruncated;
  const uint8_t* src = f.data + 8;
  for (int64_t i = 0; i < n; ++i) out[i] = (int32_t)src[i];
  return kOk;
}

void qg_shuffle_indices(int64_t* out, int64_t n, uint64_t seed) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t s = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(splitmix64(s) % (uint64_t)(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

}  // extern "C"
