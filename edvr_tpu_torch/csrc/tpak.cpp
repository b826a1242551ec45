// tpak: packed raw-frame dataset reader, the host code of the training input
// pipeline (the port's copy of edvr_tpu/native/tpak.cpp; the file format is
// the same byte for byte). Built by g++ at first use into
// edvr_tpu_torch/_build/ (edvr_tpu_torch/native/tpak.py) and bound with
// ctypes; it runs on the host, not on the card.
//
// Replaces the reference's LMDB + worker-process decode path
// (basicsr/utils/file_client.py + torch DataLoader) on the training hot
// path: frames are stored as raw uint8 in one mmap-ed file, and the hot
// operation — assembling a batch of temporal-window crops — is a
// multithreaded strided copy with zero decode work.
//
// File layout (little endian):
//   magic "TPAK0001" (8 bytes)
//   u64 num_clips
//   per clip: u32 name_len, name bytes, u64 num_frames,
//             u32 h, u32 w, u32 c, u64 data_offset
//   frame data region: clip-major, frame-major raw uint8 HWC
//
// C API (ctypes-friendly):
//   void* tpak_open(const char* path);
//   void  tpak_close(void* handle);
//   i64   tpak_num_clips(void*);
//   i64   tpak_clip_frames(void*, i64 clip);
//   void  tpak_clip_shape(void*, i64 clip, i64* h, i64* w, i64* c);
//   int   tpak_read_windows(void* handle,
//             const i64* clip_idx, const i64* start_frame,
//             const i64* interval, const i64* y0, const i64* x0,
//             i64 crop_h, i64 crop_w, i64 num_frames, i64 batch,
//             unsigned char* out, int n_threads);
//       out shape: (batch, num_frames, crop_h, crop_w, c)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Clip {
  std::string name;
  int64_t num_frames;
  int64_t h, w, c;
  int64_t data_offset;  // byte offset of frame 0
};

struct Tpak {
  int fd = -1;
  const unsigned char* base = nullptr;
  size_t size = 0;
  std::vector<Clip> clips;
};

struct CopyTask {
  const Tpak* pak;
  const int64_t* clip_idx;
  const int64_t* start_frame;
  const int64_t* interval;
  const int64_t* y0;
  const int64_t* x0;
  int64_t crop_h, crop_w, num_frames, batch;
  unsigned char* out;
  // work partition
  int64_t item_begin, item_end;  // over batch * num_frames
  int status = 0;
};

void* copy_worker(void* arg) {
  CopyTask* t = static_cast<CopyTask*>(arg);
  const Tpak& pak = *t->pak;
  const int64_t ch = t->crop_h, cw = t->crop_w;
  for (int64_t item = t->item_begin; item < t->item_end; ++item) {
    const int64_t b = item / t->num_frames;
    const int64_t f = item % t->num_frames;
    const Clip& clip = pak.clips[t->clip_idx[b]];
    const int64_t c = clip.c;
    int64_t frame = t->start_frame[b] + f * t->interval[b];
    if (frame < 0) frame = 0;
    if (frame >= clip.num_frames) frame = clip.num_frames - 1;
    const unsigned char* src = pak.base + clip.data_offset +
        frame * clip.h * clip.w * c;
    const int64_t yy = t->y0[b], xx = t->x0[b];
    if (yy < 0 || xx < 0 || yy + ch > clip.h || xx + cw > clip.w) {
      t->status = -2;  // crop out of range
      return nullptr;
    }
    unsigned char* dst = t->out + item * ch * cw * c;
    const int64_t row_bytes = cw * c;
    for (int64_t r = 0; r < ch; ++r) {
      std::memcpy(dst + r * row_bytes,
                  src + ((yy + r) * clip.w + xx) * c, row_bytes);
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

void* tpak_open(const char* path) {
  Tpak* pak = new Tpak();
  pak->fd = open(path, O_RDONLY);
  if (pak->fd < 0) { delete pak; return nullptr; }
  struct stat st;
  if (fstat(pak->fd, &st) != 0) { close(pak->fd); delete pak; return nullptr; }
  pak->size = static_cast<size_t>(st.st_size);
  void* mem = mmap(nullptr, pak->size, PROT_READ, MAP_PRIVATE, pak->fd, 0);
  if (mem == MAP_FAILED) { close(pak->fd); delete pak; return nullptr; }
  pak->base = static_cast<const unsigned char*>(mem);

  const unsigned char* p = pak->base;
  if (pak->size < 16 || std::memcmp(p, "TPAK0001", 8) != 0) {
    munmap(mem, pak->size); close(pak->fd); delete pak; return nullptr;
  }
  p += 8;
  uint64_t num_clips;
  std::memcpy(&num_clips, p, 8); p += 8;
  pak->clips.resize(num_clips);
  for (uint64_t i = 0; i < num_clips; ++i) {
    uint32_t name_len;
    std::memcpy(&name_len, p, 4); p += 4;
    Clip& c = pak->clips[i];
    c.name.assign(reinterpret_cast<const char*>(p), name_len); p += name_len;
    uint64_t nf, off; uint32_t h, w, cc;
    std::memcpy(&nf, p, 8); p += 8;
    std::memcpy(&h, p, 4); p += 4;
    std::memcpy(&w, p, 4); p += 4;
    std::memcpy(&cc, p, 4); p += 4;
    std::memcpy(&off, p, 8); p += 8;
    c.num_frames = static_cast<int64_t>(nf);
    c.h = h; c.w = w; c.c = cc;
    c.data_offset = static_cast<int64_t>(off);
  }
  return pak;
}

void tpak_close(void* handle) {
  Tpak* pak = static_cast<Tpak*>(handle);
  if (!pak) return;
  if (pak->base) munmap(const_cast<unsigned char*>(pak->base), pak->size);
  if (pak->fd >= 0) close(pak->fd);
  delete pak;
}

int64_t tpak_num_clips(void* handle) {
  return static_cast<Tpak*>(handle)->clips.size();
}

int64_t tpak_clip_frames(void* handle, int64_t clip) {
  return static_cast<Tpak*>(handle)->clips[clip].num_frames;
}

void tpak_clip_shape(void* handle, int64_t clip, int64_t* h, int64_t* w,
                     int64_t* c) {
  const Clip& cl = static_cast<Tpak*>(handle)->clips[clip];
  *h = cl.h; *w = cl.w; *c = cl.c;
}

int tpak_clip_name(void* handle, int64_t clip, char* out, int64_t cap) {
  const Clip& cl = static_cast<Tpak*>(handle)->clips[clip];
  if (static_cast<int64_t>(cl.name.size()) + 1 > cap) return -1;
  std::memcpy(out, cl.name.c_str(), cl.name.size() + 1);
  return 0;
}

int tpak_read_windows(void* handle, const int64_t* clip_idx,
                      const int64_t* start_frame, const int64_t* interval,
                      const int64_t* y0, const int64_t* x0, int64_t crop_h,
                      int64_t crop_w, int64_t num_frames, int64_t batch,
                      unsigned char* out, int n_threads) {
  Tpak* pak = static_cast<Tpak*>(handle);
  const int64_t total = batch * num_frames;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > total) n_threads = static_cast<int>(total);

  std::vector<CopyTask> tasks(n_threads);
  std::vector<pthread_t> threads(n_threads);
  const int64_t per = (total + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    tasks[i] = CopyTask{pak, clip_idx, start_frame, interval, y0, x0,
                        crop_h, crop_w, num_frames, batch, out,
                        i * per, std::min<int64_t>((i + 1) * per, total), 0};
    if (i == n_threads - 1) {
      copy_worker(&tasks[i]);
      threads[i] = 0;
    } else if (pthread_create(&threads[i], nullptr, copy_worker,
                              &tasks[i]) != 0) {
      tasks[i].status = -3;
      threads[i] = 0;
    }
  }
  int status = 0;
  for (int i = 0; i < n_threads; ++i) {
    if (threads[i]) pthread_join(threads[i], nullptr);
    if (tasks[i].status != 0) status = tasks[i].status;
  }
  return status;
}

}  // extern "C"
