// Threaded interleaved-int16 -> float32 binary capture loader.
//
// Native equivalent of the reference's threaded file readers
// (/root/reference/usrpRoutines.py:88 multiBinReadThreaded and the
// FolderReader prefetch executor): the host-side data path that keeps the
// chips fed. Files are striped across a std::thread pool; each thread reads
// its files with plain fread and converts int16 I/Q pairs to float32 in place
// in the caller-provided output buffer (which numpy then views as complex64 —
// zero extra copies on the python side).
//
// Exposed as a C ABI for ctypes. Build: see native/Makefile.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>

namespace {

// Convert a block of interleaved int16 to float32.
inline void convert_i16_to_f32(const int16_t* __restrict in,
                               float* __restrict out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    out[i] = static_cast<float>(in[i]);
  }
}

// Read one file's worth of samples. Returns 0 on success.
int load_one(const char* path, long num_samps, long offset_bytes, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  if (offset_bytes > 0 && std::fseek(f, offset_bytes, SEEK_SET) != 0) {
    std::fclose(f);
    return -2;
  }
  const size_t total = static_cast<size_t>(num_samps) * 2;  // I and Q
  constexpr size_t CHUNK = 1 << 21;
  std::vector<int16_t> buf(CHUNK);
  size_t done = 0;
  while (done < total) {
    size_t want = total - done < CHUNK ? total - done : CHUNK;
    size_t got = std::fread(buf.data(), sizeof(int16_t), want, f);
    if (got == 0) break;
    convert_i16_to_f32(buf.data(), out + done, got);
    done += got;
  }
  std::fclose(f);
  if (done < total) {
    // zero-fill short reads so callers see deterministic data
    std::memset(out + done, 0, (total - done) * sizeof(float));
    return -3;
  }
  return 0;
}

}  // namespace

extern "C" {

// Load num_files captures of num_samps complex samples each into `out`
// (which must hold num_files * num_samps * 2 floats). Files are striped
// across num_threads workers. Returns 0 if every file loaded fully, else the
// first nonzero per-file status.
int load_int16_files(const char** paths, int num_files, long num_samps,
                     long offset_bytes, float* out, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  if (num_threads > num_files) num_threads = num_files;
  std::atomic<int> status{0};
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  const size_t stride = static_cast<size_t>(num_samps) * 2;
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int i = t; i < num_files; i += num_threads) {
        int rc = load_one(paths[i], num_samps, offset_bytes, out + i * stride);
        if (rc != 0) {
          int expected = 0;
          status.compare_exchange_strong(expected, rc);
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return status.load();
}

// Single-file variant.
int load_int16_file(const char* path, long num_samps, long offset_bytes,
                    float* out) {
  return load_one(path, num_samps, offset_bytes, out);
}

}  // extern "C"
