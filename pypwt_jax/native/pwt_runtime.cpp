// pypwt_jax native runtime: planner, raw IO, prefetching frame loader,
// and pyramid checkpointing.
//
// The reference implements its orchestration layer in C++/CUDA
// (pdwt/src/wt.cu: plan construction and buffer management; io.cpp: raw
// .dat IO; demo.cpp: CLI).  Here the *compute* path belongs to XLA, but
// the host runtime around it stays native:
//
//   * plan/shape calculus  — the div2 halving rule (utils.cu:23-27), the
//     max-level clamp ilog2(N/(hlen-1)) (wt.cu:155-165), per-level shape
//     chains (pypwt.pyx:238-258) and the memory-footprint model
//     (wt.cu:527-538);
//   * coefficient-pyramid flat layout — offsets of [A, H1,V1,D1, ...]
//     inside one contiguous buffer (the functional analog of the device
//     buffer array built by common.cu:400-445), used for checkpointing;
//   * raw float32 .dat IO (io.cpp:10-27) with actual error handling;
//   * a multi-threaded, double-buffered frame-stack loader feeding the
//     host staging buffers that jax.device_put consumes — the data-loader
//     the reference never needed (single image) but a tomography pipeline
//     does;
//   * checkpoint/resume of a whole coefficient pyramid (SURVEY.md §5
//     lists this as absent upstream; nearest analog is the raw .dat dump
//     in the demo).
//
// Plain C ABI; bound from Python with ctypes (pypwt_jax/runtime.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define PWT_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// Plan / shape calculus
// ---------------------------------------------------------------------------

PWT_API int32_t pwt_div2(int32_t n) {
  // odd sizes round up: N <- (N+1)/2 (utils.cu:23-27)
  return (n + 1) / 2;
}

PWT_API int32_t pwt_ilog2(int32_t n) {
  int32_t p = 0;
  while (n > 1) {
    n /= 2;
    ++p;
  }
  return p;
}

PWT_API int32_t pwt_max_levels(int32_t nr, int32_t nc, int32_t hlen,
                               int32_t ndim) {
  // level clamp: ilog2(N/(hlen-1)) with N the min extent (wt.cu:155-165);
  // must agree with pypwt_jax.core.shapes.max_level.
  int32_t n = (ndim == 2) ? (nr < nc ? nr : nc) : nc;
  if (hlen <= 1) return pwt_ilog2(n);
  if (n < hlen - 1) return 0;
  return pwt_ilog2(n / (hlen - 1));
}

PWT_API int32_t pwt_clamp_levels(int32_t levels, int32_t nr, int32_t nc,
                                 int32_t hlen, int32_t ndim) {
  int32_t m = pwt_max_levels(nr, nc, hlen, ndim);
  if (m < 1) m = 1;
  return levels > m ? m : (levels < 1 ? 1 : levels);
}

// Per-level coefficient shapes.  out_rows/out_cols have levels+1 entries:
// entry i (1-based levels) is the shape of detail level i; entry 0 is
// unused padding kept so that index==level; the approximation A uses the
// last entry.  SWT keeps every level full-size.
PWT_API void pwt_level_shapes(int32_t nr, int32_t nc, int32_t levels,
                              int32_t do_swt, int32_t* out_rows,
                              int32_t* out_cols) {
  int32_t r = nr, c = nc;
  out_rows[0] = nr;
  out_cols[0] = nc;
  for (int32_t i = 1; i <= levels; ++i) {
    if (!do_swt) {
      r = pwt_div2(r);
      c = pwt_div2(c);
    }
    out_rows[i] = r;
    out_cols[i] = c;
  }
}

// Total float32 element count of the pyramid [A, (H,V,D) x levels] (2D)
// or [A, D x levels] (1D); nr==batch for batched-1D.
PWT_API int64_t pwt_coeff_count(int32_t nr, int32_t nc, int32_t levels,
                                int32_t do_swt, int32_t ndim) {
  std::vector<int32_t> rows(levels + 1), cols(levels + 1);
  pwt_level_shapes(nr, nc, levels, do_swt, rows.data(), cols.data());
  int64_t total = (int64_t)rows[levels] * cols[levels];  // A
  int32_t nsub = (ndim == 2) ? 3 : 1;
  for (int32_t i = 1; i <= levels; ++i)
    total += (int64_t)nsub * rows[i] * cols[i];
  return total;
}

// Offsets (in elements) of each plane inside the flat pyramid buffer,
// ordered [A, H1,V1,D1, ..., Hn,Vn,Dn] (2D) / [A, D1..Dn] (1D) — the
// coeff_only() indexing contract (wt.cu:478-502).
PWT_API int32_t pwt_pyramid_offsets(int32_t nr, int32_t nc, int32_t levels,
                                    int32_t do_swt, int32_t ndim,
                                    int64_t* out_offsets) {
  std::vector<int32_t> rows(levels + 1), cols(levels + 1);
  pwt_level_shapes(nr, nc, levels, do_swt, rows.data(), cols.data());
  int32_t nsub = (ndim == 2) ? 3 : 1;
  int32_t nplanes = 1 + nsub * levels;
  int64_t off = 0;
  out_offsets[0] = 0;
  off += (int64_t)rows[levels] * cols[levels];
  int32_t k = 1;
  for (int32_t i = 1; i <= levels; ++i) {
    for (int32_t s = 0; s < nsub; ++s) {
      out_offsets[k++] = off;
      off += (int64_t)rows[i] * cols[i];
    }
  }
  return nplanes;
}

// Estimated working-set in float32 elements (wt.cu:527-538 model, adapted
// to the functional core: image + coefficients, no persistent temps).
PWT_API int64_t pwt_memory_footprint(int32_t nr, int32_t nc, int32_t levels,
                                     int32_t do_swt, int32_t ndim) {
  return (int64_t)nr * nc +
         pwt_coeff_count(nr, nc, levels, do_swt, ndim);
}

// ---------------------------------------------------------------------------
// Raw float32 .dat IO (io.cpp:10-27, with error handling)
// ---------------------------------------------------------------------------

PWT_API int64_t pwt_file_size(const char* fname) {
  FILE* f = std::fopen(fname, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  int64_t n = std::ftell(f);
  std::fclose(f);
  return n;
}

PWT_API int32_t pwt_read_f32(const char* fname, float* dst, int64_t count,
                             int64_t offset_elems) {
  FILE* f = std::fopen(fname, "rb");
  if (!f) return -1;
  if (std::fseek(f, (long)(offset_elems * sizeof(float)), SEEK_SET)) {
    std::fclose(f);
    return -2;
  }
  size_t got = std::fread(dst, sizeof(float), (size_t)count, f);
  std::fclose(f);
  return got == (size_t)count ? 0 : -3;
}

PWT_API int32_t pwt_write_f32(const char* fname, const float* src,
                              int64_t count) {
  FILE* f = std::fopen(fname, "wb");
  if (!f) return -1;
  size_t put = std::fwrite(src, sizeof(float), (size_t)count, f);
  std::fclose(f);
  return put == (size_t)count ? 0 : -2;
}

// ---------------------------------------------------------------------------
// Prefetching frame-stack loader
// ---------------------------------------------------------------------------
//
// Reads fixed-size float32 frames from one or many .dat files on a
// background thread into a ring of host buffers, so disk IO overlaps the
// host->device transfer and the device compute of the previous frame.

namespace {

struct Loader {
  std::vector<std::string> files;
  int64_t frame_elems = 0;
  int64_t frames_per_file = 0;
  int64_t total_frames = 0;

  int depth = 0;
  std::vector<std::vector<float>> ring;
  std::vector<int64_t> slot_frame;  // which frame a slot holds (-1 empty)

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_produced, cv_consumed;
  int64_t next_produced = 0;  // frames fully read into the ring
  int64_t next_consumed = 0;  // frames handed to the consumer
  bool failed = false;
  bool stop = false;

  void run() {
    for (int64_t i = 0; i < total_frames && !stop; ++i) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_consumed.wait(lk, [&] {
          return stop || next_produced - next_consumed < depth;
        });
        if (stop) return;
      }
      int64_t fidx = i / frames_per_file;
      int64_t foff = (i % frames_per_file) * frame_elems;
      float* dst = ring[i % depth].data();
      int rc = pwt_read_f32(files[fidx].c_str(), dst, frame_elems, foff);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (rc != 0) {
          failed = true;  // do NOT advance: the consumer sees the failure
        } else {
          slot_frame[i % depth] = i;
          next_produced = i + 1;
        }
      }
      cv_produced.notify_one();
      if (rc != 0) return;
    }
  }
};

}  // namespace

PWT_API void* pwt_loader_open(const char** paths, int32_t n_paths,
                              int64_t frame_elems, int64_t frames_per_file,
                              int32_t depth) {
  if (n_paths <= 0 || frame_elems <= 0 || frames_per_file <= 0 || depth < 1)
    return nullptr;
  Loader* L = new Loader();
  for (int32_t i = 0; i < n_paths; ++i) L->files.emplace_back(paths[i]);
  L->frame_elems = frame_elems;
  L->frames_per_file = frames_per_file;
  L->total_frames = (int64_t)n_paths * frames_per_file;
  L->depth = depth;
  L->ring.assign(depth, std::vector<float>(frame_elems));
  L->slot_frame.assign(depth, -1);
  L->worker = std::thread([L] { L->run(); });
  return L;
}

PWT_API int64_t pwt_loader_total_frames(void* h) {
  return h ? ((Loader*)h)->total_frames : 0;
}

// Copy the next frame into dst.  Returns the frame index, -1 at end of
// stream, -2 on read failure.
PWT_API int64_t pwt_loader_next(void* h, float* dst) {
  Loader* L = (Loader*)h;
  if (!L) return -2;
  int64_t i;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->next_consumed >= L->total_frames) return -1;
    i = L->next_consumed;
    L->cv_produced.wait(lk, [&] {
      return L->failed || L->next_produced > i;
    });
    if (L->failed && L->next_produced <= i) return -2;
  }
  std::memcpy(dst, L->ring[i % L->depth].data(),
              (size_t)L->frame_elems * sizeof(float));
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->next_consumed = i + 1;
  }
  L->cv_consumed.notify_one();
  return i;
}

PWT_API void pwt_loader_close(void* h) {
  Loader* L = (Loader*)h;
  if (!L) return;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_consumed.notify_all();
  L->cv_produced.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

// ---------------------------------------------------------------------------
// Pyramid checkpoint / resume
// ---------------------------------------------------------------------------
//
// File layout: header { magic 'PWTC', version, ndim, nr, nc, levels,
// flags, wname[32] } then nplanes x { rows, cols, f32 data }.

struct PwtCkptHeader {
  char magic[4];
  int32_t version;
  int32_t ndim;
  int32_t nr, nc;
  int32_t levels;
  int32_t flags;  // bit0: swt, bit1: batched-1d
  char wname[32];
};

PWT_API int32_t pwt_ckpt_save(const char* fname, int32_t ndim, int32_t nr,
                              int32_t nc, int32_t levels, int32_t flags,
                              const char* wname, int32_t nplanes,
                              const int32_t* rows, const int32_t* cols,
                              const float** planes) {
  FILE* f = std::fopen(fname, "wb");
  if (!f) return -1;
  PwtCkptHeader h;
  std::memcpy(h.magic, "PWTC", 4);
  h.version = 1;
  h.ndim = ndim;
  h.nr = nr;
  h.nc = nc;
  h.levels = levels;
  h.flags = flags;
  std::memset(h.wname, 0, sizeof(h.wname));
  std::strncpy(h.wname, wname, sizeof(h.wname) - 1);
  if (std::fwrite(&h, sizeof(h), 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  for (int32_t p = 0; p < nplanes; ++p) {
    int32_t rc[2] = {rows[p], cols[p]};
    if (std::fwrite(rc, sizeof(int32_t), 2, f) != 2) {
      std::fclose(f);
      return -2;
    }
    size_t n = (size_t)rows[p] * cols[p];
    if (std::fwrite(planes[p], sizeof(float), n, f) != n) {
      std::fclose(f);
      return -2;
    }
  }
  std::fclose(f);
  return 0;
}

// Reads the header; returns 0 on success.
PWT_API int32_t pwt_ckpt_info(const char* fname, int32_t* ndim, int32_t* nr,
                              int32_t* nc, int32_t* levels, int32_t* flags,
                              char* wname /* >=32 bytes */) {
  FILE* f = std::fopen(fname, "rb");
  if (!f) return -1;
  PwtCkptHeader h;
  if (std::fread(&h, sizeof(h), 1, f) != 1 ||
      std::memcmp(h.magic, "PWTC", 4) != 0 || h.version != 1) {
    std::fclose(f);
    return -2;
  }
  *ndim = h.ndim;
  *nr = h.nr;
  *nc = h.nc;
  *levels = h.levels;
  *flags = h.flags;
  std::memcpy(wname, h.wname, 32);
  std::fclose(f);
  return 0;
}

// Loads plane p's shape and data (dst may be null to query the shape).
PWT_API int32_t pwt_ckpt_load_plane(const char* fname, int32_t plane,
                                    int32_t* rows, int32_t* cols,
                                    float* dst) {
  FILE* f = std::fopen(fname, "rb");
  if (!f) return -1;
  if (std::fseek(f, sizeof(PwtCkptHeader), SEEK_SET)) {
    std::fclose(f);
    return -2;
  }
  for (int32_t p = 0;; ++p) {
    int32_t rc[2];
    if (std::fread(rc, sizeof(int32_t), 2, f) != 2) {
      std::fclose(f);
      return -3;  // plane out of range
    }
    size_t n = (size_t)rc[0] * rc[1];
    if (p == plane) {
      *rows = rc[0];
      *cols = rc[1];
      int32_t ret = 0;
      if (dst && std::fread(dst, sizeof(float), n, f) != n) ret = -4;
      std::fclose(f);
      return ret;
    }
    if (std::fseek(f, (long)(n * sizeof(float)), SEEK_CUR)) {
      std::fclose(f);
      return -3;
    }
  }
}

PWT_API const char* pwt_runtime_version() { return "1.0.0"; }
