// Native runtime: sequence data loading + point-cloud ops.
//
// The reference's runtime around the compute path is C++ (System/Tracking
// own the IO and the LiDAR handling).  Here the host-side hot IO is native
// too: a KITTI velodyne .bin reader, voxel-grid downsampling, box cropping,
// and a double-buffered background prefetcher that overlaps disk reads of
// frame t+1 with device compute on frame t (the role the LocalMapping /
// Tracking thread split played for IO in the reference).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// KITTI velodyne: float32 x,y,z,reflectance records
// ---------------------------------------------------------------------------
// Returns number of points written (xyz only, stride 3), or -1 on error.
long read_velodyne(const char* path, float* out, long max_pts) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fseek(f, 0, SEEK_SET);
  long n = bytes / (4 * sizeof(float));
  if (n > max_pts) n = max_pts;
  std::vector<float> buf(static_cast<size_t>(n) * 4);
  size_t got = fread(buf.data(), sizeof(float), static_cast<size_t>(n) * 4, f);
  fclose(f);
  n = static_cast<long>(got / 4);
  for (long i = 0; i < n; i++) {
    out[i * 3 + 0] = buf[i * 4 + 0];
    out[i * 3 + 1] = buf[i * 4 + 1];
    out[i * 3 + 2] = buf[i * 4 + 2];
  }
  return n;
}

// ---------------------------------------------------------------------------
// Voxel-grid downsample: keep the first point per voxel.  Returns count.
// ---------------------------------------------------------------------------
long voxel_downsample(const float* pts, long n, float voxel, float* out,
                      long max_out) {
  std::unordered_map<uint64_t, bool> seen;
  seen.reserve(static_cast<size_t>(n));
  long m = 0;
  const float inv = 1.0f / voxel;
  for (long i = 0; i < n && m < max_out; i++) {
    int64_t vx = static_cast<int64_t>(pts[i * 3 + 0] * inv) + (1 << 20);
    int64_t vy = static_cast<int64_t>(pts[i * 3 + 1] * inv) + (1 << 20);
    int64_t vz = static_cast<int64_t>(pts[i * 3 + 2] * inv) + (1 << 20);
    uint64_t key = (static_cast<uint64_t>(vx) << 42) ^
                   (static_cast<uint64_t>(vy) << 21) ^
                   static_cast<uint64_t>(vz);
    auto it = seen.find(key);
    if (it == seen.end()) {
      seen.emplace(key, true);
      out[m * 3 + 0] = pts[i * 3 + 0];
      out[m * 3 + 1] = pts[i * 3 + 1];
      out[m * 3 + 2] = pts[i * 3 + 2];
      m++;
    }
  }
  return m;
}

// ---------------------------------------------------------------------------
// Axis-aligned box crop in a local frame: out gets points p with
// |R^T (p - t)| <= half (component-wise).  Returns count.
// ---------------------------------------------------------------------------
long box_crop(const float* pts, long n, const float* R_row_major,
              const float* t, const float* half, float* out, long max_out) {
  long m = 0;
  for (long i = 0; i < n && m < max_out; i++) {
    float d[3] = {pts[i * 3] - t[0], pts[i * 3 + 1] - t[1],
                  pts[i * 3 + 2] - t[2]};
    float l[3];
    for (int r = 0; r < 3; r++)  // local = R^T d
      l[r] = R_row_major[0 * 3 + r] * d[0] + R_row_major[1 * 3 + r] * d[1] +
             R_row_major[2 * 3 + r] * d[2];
    if (l[0] >= -half[0] && l[0] <= half[0] && l[1] >= -half[1] &&
        l[1] <= half[1] && l[2] >= -half[2] && l[2] <= half[2]) {
      memcpy(out + m * 3, pts + i * 3, 3 * sizeof(float));
      m++;
    }
  }
  return m;
}

// ---------------------------------------------------------------------------
// Double-buffered file prefetcher: a background thread reads file i+1 while
// the caller consumes file i.
//
// Slot s holds file `loaded[s]`.  A thread that reads into a slot first
// claims it (`loading[s]` = the file's index) under the mutex, reads into a
// vector of its own outside the lock, and publishes buffer, size and index
// under the lock.  So no slot is written while another thread touches it,
// and `get` waits for a claim in flight on its slot instead of loading
// beside it.
// ---------------------------------------------------------------------------
struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<uint8_t> buf[2];
  long sizes[2] = {0, 0};
  int loaded[2] = {-1, -1};
  int loading[2] = {-1, -1};
  size_t next_to_load = 0;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};

  // Reads file idx into `out`; returns its size, or -1 when it cannot be
  // opened.  Touches no shared state.
  long read_file(size_t idx, std::vector<uint8_t>& out) const {
    FILE* f = fopen(paths[idx].c_str(), "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long bytes = ftell(f);
    fseek(f, 0, SEEK_SET);
    out.resize(static_cast<size_t>(bytes));
    long got = static_cast<long>(fread(out.data(), 1,
                                       static_cast<size_t>(bytes), f));
    fclose(f);
    return got;
  }

  // Loads file idx into its slot, which the caller has claimed.  Called and
  // returns with `lk` held; the read itself runs unlocked.
  void load_claimed(std::unique_lock<std::mutex>& lk, size_t idx) {
    int slot = static_cast<int>(idx % 2);
    lk.unlock();
    std::vector<uint8_t> data;
    long sz = read_file(idx, data);
    lk.lock();
    buf[slot].swap(data);
    sizes[slot] = sz;
    loaded[slot] = static_cast<int>(idx);
    loading[slot] = -1;
    cv.notify_all();
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      cv.wait(lk, [&] {
        if (stop.load()) return true;
        if (next_to_load >= paths.size()) return false;
        int slot = static_cast<int>(next_to_load % 2);
        return loaded[slot] != static_cast<int>(next_to_load) &&
               loading[slot] == -1;
      });
      if (stop.load()) return;
      size_t idx = next_to_load;
      loading[idx % 2] = static_cast<int>(idx);
      load_claimed(lk, idx);
    }
  }
};

void* prefetcher_create(const char** paths, long n_paths) {
  auto* p = new Prefetcher();
  for (long i = 0; i < n_paths; i++) p->paths.emplace_back(paths[i]);
  p->worker = std::thread([p] { p->run(); });
  p->cv.notify_all();
  return p;
}

// Blocks until file `idx` is in memory; returns its size and copies up to
// max_bytes into out.  Kicks off the background load of idx+1.
long prefetcher_get(void* handle, long idx, uint8_t* out, long max_bytes) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (idx < 0 || static_cast<size_t>(idx) >= p->paths.size()) return -1;
  int slot = static_cast<int>(idx % 2);
  std::unique_lock<std::mutex> lk(p->mu);
  while (p->loaded[slot] != static_cast<int>(idx)) {
    if (p->loading[slot] != -1) {
      // a load into this slot is in flight (of idx or of another file)
      p->cv.wait(lk);
    } else {
      // not prefetched (random access): load synchronously
      p->loading[slot] = static_cast<int>(idx);
      p->load_claimed(lk, static_cast<size_t>(idx));
    }
  }
  long sz = p->sizes[slot];
  if (sz > 0) memcpy(out, p->buf[slot].data(),
                     static_cast<size_t>(sz < max_bytes ? sz : max_bytes));
  // schedule the next file
  p->next_to_load = static_cast<size_t>(idx + 1);
  p->cv.notify_all();
  return sz;
}

long prefetcher_size(void* handle, long idx) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (idx < 0 || static_cast<size_t>(idx) >= p->paths.size()) return -1;
  FILE* f = fopen(p->paths[static_cast<size_t>(idx)].c_str(), "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fclose(f);
  return bytes;
}

void prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
  }
  p->cv.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
