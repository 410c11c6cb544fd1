// Native data-plane helpers for the ingestion runtime.
//
// The reference pipeline's L1 stage is dominated by host-side stream
// decode (zlib-ushort depth frames inside .sens files, SURVEY.md §2 #3).
// This library provides single-shot and multithreaded batched zlib
// inflate, called from Python via ctypes (no pybind11 in the image).
//
// Build: ingest/native/build.sh  ->  libmsm_native.so (links -lz -lpthread)

#include <zlib.h>

#include <atomic>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Inflate one zlib stream. Returns 0 on success, negative zlib error code
// otherwise. *out_len receives the decompressed size.
int msm_inflate(const unsigned char* src, size_t src_len, unsigned char* dst,
                size_t dst_cap, size_t* out_len) {
  uLongf dest_len = static_cast<uLongf>(dst_cap);
  int rc = uncompress(dst, &dest_len, src, static_cast<uLong>(src_len));
  if (rc != Z_OK) return rc;
  *out_len = static_cast<size_t>(dest_len);
  return 0;
}

// Inflate `n` independent zlib streams concurrently with `n_threads`
// workers. Each stream i reads src+src_offsets[i] (src_lens[i] bytes) and
// writes dst+dst_offsets[i] (capacity dst_caps[i]); out_lens[i] receives
// the decompressed size. Returns the number of failed streams (0 = all
// succeeded); failures leave out_lens[i] == (size_t)-1.
int msm_inflate_batch(const unsigned char* src, const size_t* src_offsets,
                      const size_t* src_lens, unsigned char* dst,
                      const size_t* dst_offsets, const size_t* dst_caps,
                      size_t* out_lens, size_t n, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<size_t> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n) break;
      uLongf dest_len = static_cast<uLongf>(dst_caps[i]);
      int rc = uncompress(dst + dst_offsets[i], &dest_len,
                          src + src_offsets[i],
                          static_cast<uLong>(src_lens[i]));
      if (rc != Z_OK) {
        out_lens[i] = static_cast<size_t>(-1);
        failures.fetch_add(1);
      } else {
        out_lens[i] = static_cast<size_t>(dest_len);
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
