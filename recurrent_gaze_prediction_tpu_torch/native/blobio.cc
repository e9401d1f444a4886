// blobio: native C3D binary-blob codec + threaded batch reader (the port's
// copy of the JAX package's native/blobio.cc).
//
// The C3D Caffe tools define the on-disk blob format (5 x int32 header
// [num, channels, length, height, width] + row-major float32 payload; the
// reference's extract_C3D_features.py:13-76 reads it in Python). This
// library provides:
//   * blobio_read / blobio_write  — single-blob codec
//   * blobio_read_batch           — N blob files decoded in parallel
//     (pthreads) into one caller-owned contiguous buffer, the hot path
//     when aggregating per-window features into model-ready arrays.
//
// Built with g++ at first use by native/__init__.py (ctypes), which falls
// back to the NumPy codec (data/codec.py) when no library can be built.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <pthread.h>

extern "C" {

// Error codes
enum BlobIoStatus {
  BLOBIO_OK = 0,
  BLOBIO_EOPEN = 1,
  BLOBIO_EHEADER = 2,
  BLOBIO_EPAYLOAD = 3,
  BLOBIO_ESHAPE = 4,
  BLOBIO_ETHREAD = 5,
};

// Read only the 5-int32 header. shape_out must hold 5 int32.
int blobio_read_header(const char* path, int32_t* shape_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return BLOBIO_EOPEN;
  size_t got = std::fread(shape_out, sizeof(int32_t), 5, f);
  std::fclose(f);
  return got == 5 ? BLOBIO_OK : BLOBIO_EHEADER;
}

// Read a full blob. data_out must hold prod(shape) floats; shape_out 5
// int32. If expected_count > 0 the payload size is validated against it.
int blobio_read(const char* path, int32_t* shape_out, float* data_out,
                int64_t expected_count) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return BLOBIO_EOPEN;
  if (std::fread(shape_out, sizeof(int32_t), 5, f) != 5) {
    std::fclose(f);
    return BLOBIO_EHEADER;
  }
  int64_t count = 1;
  for (int i = 0; i < 5; ++i) count *= shape_out[i];
  if (expected_count > 0 && count != expected_count) {
    std::fclose(f);
    return BLOBIO_ESHAPE;
  }
  size_t got = std::fread(data_out, sizeof(float), (size_t)count, f);
  std::fclose(f);
  return got == (size_t)count ? BLOBIO_OK : BLOBIO_EPAYLOAD;
}

int blobio_write(const char* path, const int32_t* shape, const float* data) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return BLOBIO_EOPEN;
  int64_t count = 1;
  for (int i = 0; i < 5; ++i) count *= shape[i];
  size_t ok = std::fwrite(shape, sizeof(int32_t), 5, f) == 5 &&
              std::fwrite(data, sizeof(float), (size_t)count, f) ==
                  (size_t)count;
  std::fclose(f);
  return ok ? BLOBIO_OK : BLOBIO_EPAYLOAD;
}

namespace {

struct BatchTask {
  const char* const* paths;
  float* out;            // [n_files * blob_count] contiguous
  int32_t* statuses;     // [n_files]
  int64_t blob_count;    // floats per blob (validated)
  int n_files;
  int n_threads;
  int thread_idx;
};

void* batch_worker(void* arg) {
  BatchTask* t = static_cast<BatchTask*>(arg);
  int32_t shape[5];
  for (int i = t->thread_idx; i < t->n_files; i += t->n_threads) {
    t->statuses[i] = blobio_read(t->paths[i], shape,
                                 t->out + (int64_t)i * t->blob_count,
                                 t->blob_count);
  }
  return nullptr;
}

}  // namespace

// Decode n_files blobs (each with exactly blob_count floats) into `out`
// using n_threads workers. statuses[i] gets the per-file status code.
// Returns the number of failed files.
int blobio_read_batch(const char* const* paths, int n_files,
                      int64_t blob_count, float* out, int32_t* statuses,
                      int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files > 0 ? n_files : 1;

  pthread_t threads[64];
  BatchTask tasks[64];
  if (n_threads > 64) n_threads = 64;

  bool spawned[64];
  for (int ti = 0; ti < n_threads; ++ti) {
    tasks[ti] = BatchTask{paths, out, statuses, blob_count,
                          n_files, n_threads, ti};
    spawned[ti] = pthread_create(&threads[ti], nullptr, batch_worker,
                                 &tasks[ti]) == 0;
    if (!spawned[ti]) {
      // thread creation failed (EAGAIN under resource limits): the
      // stripe this worker owned must be marked failed, not left as the
      // caller's pre-zeroed BLOBIO_OK over uninitialized output — and
      // joining an uninitialized pthread_t is UB
      for (int i = ti; i < n_files; i += n_threads)
        statuses[i] = BLOBIO_ETHREAD;
    }
  }
  for (int ti = 0; ti < n_threads; ++ti)
    if (spawned[ti]) pthread_join(threads[ti], nullptr);

  int failures = 0;
  for (int i = 0; i < n_files; ++i)
    if (statuses[i] != BLOBIO_OK) ++failures;
  return failures;
}

}  // extern "C"
