// Native host-side data engine: threaded tokenize/pad and batch collation
// (the port's copy of trlx_tpu/native/hostdata.cpp).
//
// The device path is the port's CUDA kernels; this is the HOST side of
// the data path, what the reference gets from torch DataLoader worker
// pools (C++) and HF's Rust tokenizers (SURVEY §2.9). Pure C++17 +
// std::thread, no Python.h: bound via ctypes from trlx_tpu_torch.native,
// with the pure-Python implementations retained as fallback when no
// compiler is available.
//
// Exposed (all extern "C", int32 row-major buffers allocated by caller):
//   td_byte_tokenize_pad  — UTF-8 byte tokenization of n strings with
//                           left- or right-padding/truncation to max_len
//   td_pad_collate        — right-pad collation of variable-length int32
//                           rows (+ float rewards) into batch arrays, the
//                           offline-store loader hot loop
// Both parallelize over rows with a small thread pool.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over up to `threads` workers.
template <typename F>
void parallel_rows(int64_t n, int threads, F fn) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = std::min<int64_t>(std::max(1, threads > 0 ? threads : hw), n);
  if (t <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  int64_t chunk = (n + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    int64_t lo = w * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// texts: n pointers to UTF-8 buffers with byte lengths text_lens[i].
// out_ids/out_mask: [n, max_len] int32, caller-allocated.
// pad_left != 0 => left padding (the decode-prompt layout).
void td_byte_tokenize_pad(const char** texts, const int64_t* text_lens,
                          int64_t n, int64_t max_len, int32_t pad_id,
                          int pad_left, int threads, int32_t* out_ids,
                          int32_t* out_mask) {
  parallel_rows(n, threads, [=](int64_t i) {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(texts[i]);
    int64_t len = std::min<int64_t>(text_lens[i], max_len);
    int32_t* ids = out_ids + i * max_len;
    int32_t* mask = out_mask + i * max_len;
    int64_t off = pad_left ? (max_len - len) : 0;
    for (int64_t j = 0; j < max_len; ++j) {
      ids[j] = pad_id;
      mask[j] = 0;
    }
    for (int64_t j = 0; j < len; ++j) {
      ids[off + j] = static_cast<int32_t>(s[j]);
      mask[off + j] = 1;
    }
  });
}

// rows: n pointers to int32 id rows of lengths row_lens[i];
// masks: n pointers to int32 mask rows (same lengths; may be null =>
//   all-ones); rewards: n pointers to float rows of lengths row_lens[i]-1
//   (may be null). Outputs right-padded [n, max_len] (+ [n, max_len-1]).
void td_pad_collate(const int32_t** rows, const int32_t** masks,
                    const float** rewards, const int64_t* row_lens,
                    int64_t n, int64_t max_len, int32_t pad_id, int threads,
                    int32_t* out_ids, int32_t* out_mask, float* out_rewards) {
  parallel_rows(n, threads, [=](int64_t i) {
    int64_t len = std::min<int64_t>(row_lens[i], max_len);
    int32_t* ids = out_ids + i * max_len;
    int32_t* mask = out_mask + i * max_len;
    for (int64_t j = 0; j < max_len; ++j) {
      ids[j] = pad_id;
      mask[j] = 0;
    }
    std::memcpy(ids, rows[i], len * sizeof(int32_t));
    if (masks != nullptr && masks[i] != nullptr) {
      std::memcpy(mask, masks[i], len * sizeof(int32_t));
    } else {
      for (int64_t j = 0; j < len; ++j) mask[j] = 1;
    }
    if (out_rewards != nullptr) {
      float* rw = out_rewards + i * (max_len - 1);
      for (int64_t j = 0; j < max_len - 1; ++j) rw[j] = 0.0f;
      if (rewards != nullptr && rewards[i] != nullptr && len > 1) {
        std::memcpy(rw, rewards[i], (len - 1) * sizeof(float));
      }
    }
  });
}

}  // extern "C"
