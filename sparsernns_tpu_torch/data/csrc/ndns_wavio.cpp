// Native NDNS audio loader: multithreaded PCM WAV decoding into
// preallocated float32 batch buffers.
//
// The host side of the WAV-corpus input path: a C++ thread pool behind a
// C ABI, bound with ctypes by sparsernns_tpu_torch/data/native.py, which
// builds it with g++ at first use. Decoded samples land directly in the
// numpy batch buffer that feeds the device transfer.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits_per_sample = 0;
  long data_offset = -1;
  uint32_t data_bytes = 0;
};

bool read_header(FILE* f, WavInfo* info) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0) return false;
  if (fread(&riff_size, 4, 1, f) != 1) return false;
  if (fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4) != 0) return false;

  // Walk chunks until both fmt and data are found.
  char id[4];
  uint32_t size;
  while (fread(id, 1, 4, f) == 4 && fread(&size, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      unsigned char buf[16];
      if (size < 16 || fread(buf, 1, 16, f) != 16) return false;
      info->format = buf[0] | (buf[1] << 8);
      info->channels = buf[2] | (buf[3] << 8);
      memcpy(&info->sample_rate, buf + 4, 4);
      info->bits_per_sample = buf[14] | (buf[15] << 8);
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      return info->format != 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return false;
}

// Decode one file into out[clip_len], front-truncated / zero-padded.
// Returns decoded sample count (pre-pad), or a negative error code.
int decode_one(const char* path, float* out, int clip_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!read_header(f, &info) || info.data_offset < 0) {
    fclose(f);
    return -2;
  }
  if (info.format != 1 /*PCM*/ || info.bits_per_sample != 16) {
    fclose(f);
    return -3;
  }
  const int ch = info.channels > 0 ? info.channels : 1;
  const uint32_t total_frames = info.data_bytes / (2 * ch);
  const uint32_t want = total_frames < (uint32_t)clip_len
                            ? total_frames
                            : (uint32_t)clip_len;
  fseek(f, info.data_offset, SEEK_SET);

  std::vector<int16_t> buf(want * ch);
  const size_t got = fread(buf.data(), 2 * ch, want, f);
  fclose(f);

  const float inv = 1.0f / 32768.0f;
  for (size_t i = 0; i < got; ++i) {
    if (ch == 1) {
      out[i] = buf[i] * inv;
    } else {  // downmix
      int32_t acc = 0;
      for (int c = 0; c < ch; ++c) acc += buf[i * ch + c];
      out[i] = (acc / ch) * inv;
    }
  }
  for (size_t i = got; i < (size_t)clip_len; ++i) out[i] = 0.0f;
  return (int)got;
}

}  // namespace

extern "C" {

// Decode one WAV file. Returns decoded sample count or negative error.
int ndns_decode_wav(const char* path, float* out, int clip_len) {
  return decode_one(path, out, clip_len);
}

// Decode n files concurrently into out[n * clip_len] with a thread pool.
// results[i] receives the per-file return code. Returns 0, or the count
// of failed files.
int ndns_decode_batch(const char** paths, int n, float* out, int clip_len,
                      int n_threads, int* results) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;

  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const int rc = decode_one(paths[i], out + (size_t)i * clip_len,
                                clip_len);
      if (results) results[i] = rc;
      if (rc < 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
