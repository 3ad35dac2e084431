// topfusion native frame loader.
//
// A multi-threaded, prefetching depth-frame pipeline: worker threads decode
// 16-bit grayscale PNGs (the TUM/ICL depth format) into a bounded ring of
// ready frames while the device computes, so host IO never stalls the fusion
// loop.  This is the native-runtime analogue of the reference's blocking
// OpenNI capture thread (reference: tfusion/src/capture.cpp:205-245
// OpenNISource::grab, which blocks on WaitAndUpdateAll every frame).
//
// The PNG subset decoded here: 8/16-bit, grayscale or RGB(A), non-interlaced
// (what TUM/ICL/imageio produce).  Inflate comes from zlib; filters are
// implemented per the PNG spec.  Exposed as a small C ABI for ctypes.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC ... -lz -lpthread).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ------------------------------------------------------------------ PNG
struct Image {
  uint32_t width = 0, height = 0;
  uint32_t channels = 0;   // 1 = gray, 2 = gray+alpha, 3 = rgb, 4 = rgba
  uint32_t bit_depth = 0;  // 8 or 16
  std::vector<uint16_t> pixels;  // always widened to u16, channel-interleaved
  bool ok = false;
  std::string error;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  std::vector<uint8_t> buf(1 << 20);
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = static_cast<uInt>(buf.size());
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf.data(), buf.data() + (buf.size() - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

Image decode_png(const std::string& path) {
  Image img;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    img.error = "cannot open " + path;
    return img;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(sz);
  if (fread(data.data(), 1, sz, f) != size_t(sz)) {
    fclose(f);
    img.error = "short read";
    return img;
  }
  fclose(f);

  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (sz < 8 || memcmp(data.data(), sig, 8) != 0) {
    img.error = "not a PNG";
    return img;
  }

  uint32_t color_type = 0;
  std::vector<uint8_t> idat;
  size_t off = 8;
  while (off + 8 <= data.size()) {
    uint32_t len = be32(&data[off]);
    if (off + 12 + len > data.size()) break;
    const char* type = reinterpret_cast<const char*>(&data[off + 4]);
    const uint8_t* payload = &data[off + 8];
    if (memcmp(type, "IHDR", 4) == 0) {
      img.width = be32(payload);
      img.height = be32(payload + 4);
      img.bit_depth = payload[8];
      color_type = payload[9];
      if (payload[12] != 0) {
        img.error = "interlaced PNG unsupported";
        return img;
      }
      switch (color_type) {
        case 0: img.channels = 1; break;
        case 2: img.channels = 3; break;
        case 4: img.channels = 2; break;
        case 6: img.channels = 4; break;
        default:
          img.error = "palette PNG unsupported";
          return img;
      }
      if (img.bit_depth != 8 && img.bit_depth != 16) {
        img.error = "bit depth unsupported";
        return img;
      }
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (img.width == 0 || idat.empty()) {
    img.error = "malformed PNG";
    return img;
  }

  std::vector<uint8_t> raw;
  if (!inflate_all(idat, raw)) {
    img.error = "inflate failed";
    return img;
  }

  const size_t bpp = img.channels * img.bit_depth / 8;  // bytes per pixel
  const size_t stride = img.width * bpp;
  if (raw.size() < img.height * (stride + 1)) {
    img.error = "truncated image data";
    return img;
  }

  // Undo per-scanline filters in place into `recon`.
  std::vector<uint8_t> recon(img.height * stride);
  for (uint32_t y = 0; y < img.height; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &recon[y * stride];
    const uint8_t* up = y ? &recon[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= bpp ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default:
          img.error = "bad filter";
          return img;
      }
      dst[x] = uint8_t(v);
    }
  }

  // Widen to u16 (PNG 16-bit is big-endian).
  img.pixels.resize(size_t(img.width) * img.height * img.channels);
  if (img.bit_depth == 16) {
    for (size_t i = 0; i < img.pixels.size(); ++i)
      img.pixels[i] = (uint16_t(recon[2 * i]) << 8) | recon[2 * i + 1];
  } else {
    for (size_t i = 0; i < img.pixels.size(); ++i)
      img.pixels[i] = recon[i];
  }
  img.ok = true;
  return img;
}

}  // namespace

// The ring keeps decoded frames ordered by index; workers grab the next
// undecoded index, decode, and publish.  next() blocks until its index is
// published.  Simple and deterministic (frames always delivered in order).
struct TfLoader {
  std::vector<std::string> paths;
  double scale;
  int prefetch;
  std::atomic<size_t> next_decode{0};
  size_t next_out = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::vector<uint16_t>> slots;   // decoded frames by index
  std::vector<uint8_t> done;
  std::vector<std::string> errors;
  uint32_t width = 0, height = 0;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      size_t i = next_decode.fetch_add(1);
      if (i >= paths.size()) return;
      {
        // Backpressure: don't run more than `prefetch` frames ahead.
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || i < next_out + size_t(prefetch);
        });
        if (stop.load()) return;
      }
      Image img = decode_png(paths[i]);
      std::unique_lock<std::mutex> lk(mu);
      if (img.ok) {
        if (width == 0) {
          width = img.width;
          height = img.height;
        }
        std::vector<uint16_t> frame(size_t(img.width) * img.height);
        // First channel only (depth PNGs are grayscale).
        for (size_t p = 0; p < frame.size(); ++p) {
          double v = img.pixels[p * img.channels] * scale;
          frame[p] = uint16_t(v < 0 ? 0 : (v > 65535 ? 65535 : v + 0.5));
        }
        slots[i] = std::move(frame);
      } else {
        errors[i] = img.error;
      }
      done[i] = 1;
      cv.notify_all();
    }
  }
};

extern "C" {

TfLoader* tf_loader_open(const char** paths, int n_paths, double scale,
                         int n_threads, int prefetch) {
  auto* L = new TfLoader();
  L->paths.assign(paths, paths + n_paths);
  L->scale = scale;
  L->prefetch = prefetch < 2 ? 2 : prefetch;
  L->slots.resize(n_paths);
  L->done.assign(n_paths, 0);
  L->errors.resize(n_paths);
  int nt = n_threads < 1 ? 1 : n_threads;
  for (int t = 0; t < nt; ++t)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocks until frame `next_out` is decoded; copies into out (w*h u16).
// Returns 1 on success, 0 on end-of-sequence, -1 on decode error.
int tf_loader_next(TfLoader* L, uint16_t* out, int out_capacity,
                   uint32_t* w, uint32_t* h) {
  if (L->next_out >= L->paths.size()) return 0;
  size_t i = L->next_out;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv.wait(lk, [&] { return L->done[i] != 0; });
  if (!L->errors[i].empty()) {
    L->next_out++;
    L->cv.notify_all();
    return -1;
  }
  auto& frame = L->slots[i];
  *w = L->width;
  *h = L->height;
  if (int(frame.size()) > out_capacity) return -2;
  memcpy(out, frame.data(), frame.size() * sizeof(uint16_t));
  frame.clear();
  frame.shrink_to_fit();
  L->next_out++;
  L->cv.notify_all();
  return 1;
}

const char* tf_loader_error(TfLoader* L) {
  size_t i = L->next_out == 0 ? 0 : L->next_out - 1;
  return L->errors[i].c_str();
}

void tf_loader_close(TfLoader* L) {
  L->stop.store(true);
  L->cv.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// One-shot decode (no threads) — also the unit-test surface.
int tf_decode_png(const char* path, uint16_t* out, int out_capacity,
                  uint32_t* w, uint32_t* h, uint32_t* channels) {
  Image img = decode_png(path);
  if (!img.ok) return -1;
  *w = img.width;
  *h = img.height;
  *channels = img.channels;
  if (int(img.pixels.size()) > out_capacity) return -2;
  memcpy(out, img.pixels.data(), img.pixels.size() * sizeof(uint16_t));
  return 1;
}

}  // extern "C"
