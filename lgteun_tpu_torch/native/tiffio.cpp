// Native TIFF codec and parallel batch loader of the port's input
// pipeline (the port's copy of lgteun_tpu/native/tiffio.cpp).
//
// The reference reads and writes rasters with tifffile / GDAL through
// Python (reference dataset/utils.py:29-86). This keeps a small native
// path: baseline little-endian uncompressed TIFF decode and encode (the
// only flavour the pipeline writes) and a pthread batch decoder that
// turns a list of equally shaped tiles into one float32 array, scaled on
// the way in. Python binds it with ctypes (lgteun_tpu_torch/native/
// __init__.py); the Python codec (lgteun_tpu_torch/data/tiff.py) stays
// the fallback and the format's authority.
//
// Build (done at first use, into build/lgteun_tpu_torch/):
//   g++ -O3 -shared -fPIC -pthread tiffio.cpp -o libtiffio.so

#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <pthread.h>

namespace {

struct TiffMeta {
  uint32_t width = 0, height = 0;
  uint16_t samples = 1, bits = 16, compression = 1, planar = 1,
           sample_format = 1;
  // up to 64 strips supported
  uint32_t strip_offsets[64] = {};
  uint32_t strip_counts[64] = {};
  int n_strips = 0;
  int n_counts = 0;
};

uint16_t rd16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }
uint32_t rd32(const uint8_t* p) {
  return (uint32_t)(p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24));
}

// Parse the first IFD of a little-endian baseline TIFF held in `buf`.
bool parse(const uint8_t* buf, size_t len, TiffMeta* m) {
  if (len < 8 || buf[0] != 'I' || buf[1] != 'I' || rd16(buf + 2) != 42)
    return false;
  uint32_t ifd = rd32(buf + 4);
  if (ifd + 2 > len) return false;
  uint16_t n = rd16(buf + ifd);
  for (uint16_t i = 0; i < n; i++) {
    const uint8_t* e = buf + ifd + 2 + 12 * i;
    if ((size_t)(e - buf) + 12 > len) return false;
    uint16_t tag = rd16(e), type = rd16(e + 2);
    uint32_t count = rd32(e + 4);
    const uint8_t* val = e + 8;
    // Out-of-line values live at an offset the file controls; every
    // read must stay inside [buf, buf+len) or a crafted TIFF turns
    // into an OOB read.
    bool bad = false;
    auto value_at = [&](uint32_t idx) -> uint32_t {
      uint64_t size = (type == 3) ? 2 : 4;
      const uint8_t* base = val;
      if (size * count > 4) {
        uint32_t off = rd32(val);
        if ((uint64_t)off + size * count > len) {
          bad = true;
          return 0;
        }
        base = buf + off;
      }
      const uint8_t* p = base + size * idx;
      return (type == 3) ? rd16(p) : rd32(p);
    };
    switch (tag) {
      case 256: m->width = value_at(0); break;
      case 257: m->height = value_at(0); break;
      case 258: m->bits = (uint16_t)value_at(0); break;
      case 259: m->compression = (uint16_t)value_at(0); break;
      case 277: m->samples = (uint16_t)value_at(0); break;
      case 284: m->planar = (uint16_t)value_at(0); break;
      case 339: m->sample_format = (uint16_t)value_at(0); break;
      case 273: {
        m->n_strips = count > 64 ? -1 : (int)count;
        if (m->n_strips > 0)
          for (uint32_t k = 0; k < count; k++)
            m->strip_offsets[k] = value_at(k);
        break;
      }
      case 279: {
        if (count <= 64) {
          m->n_counts = (int)count;
          for (uint32_t k = 0; k < count; k++)
            m->strip_counts[k] = value_at(k);
        }
        break;
      }
      default: break;
    }
    if (bad) return false;
  }
  return m->compression == 1 && m->planar == 1 && m->n_strips > 0 &&
         m->n_counts == m->n_strips && (m->bits == 8 || m->bits == 16) &&
         m->sample_format == 1;
}

bool read_file(const char* path, uint8_t** out, size_t* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len < 8) {
    fclose(f);
    return false;
  }
  uint8_t* buf = (uint8_t*)malloc((size_t)len);
  if (!buf) {
    fclose(f);
    return false;
  }
  size_t got = fread(buf, 1, (size_t)len, f);
  fclose(f);
  if ((long)got != len) {
    free(buf);
    return false;
  }
  *out = buf;
  *out_len = (size_t)len;
  return true;
}

}  // namespace

extern "C" {

// Decode into a caller-allocated uint16 buffer of `capacity` elements,
// reading the file once; fills h, w, c. Fails (rc 5) if the file's
// h*w*c exceeds capacity, so no file can overflow the buffer.
int lg_tiff_read_u16_dims(const char* path, uint16_t* out, int64_t capacity,
                          int* h, int* w, int* c) {
  uint8_t* buf;
  size_t len;
  if (!read_file(path, &buf, &len)) return 1;
  TiffMeta m;
  if (!parse(buf, len, &m)) {
    free(buf);
    return 2;
  }
  *h = (int)m.height;
  *w = (int)m.width;
  *c = (int)m.samples;
  size_t total = (size_t)m.height * m.width * m.samples;
  if (capacity < 0 || total > (size_t)capacity) {
    free(buf);
    return 5;
  }
  size_t written = 0;
  for (int s = 0; s < m.n_strips && written < total; s++) {
    const uint8_t* src = buf + m.strip_offsets[s];
    size_t bytes = m.strip_counts[s];
    if (m.strip_offsets[s] + bytes > len) {
      free(buf);
      return 3;
    }
    if (m.bits == 16) {
      // Clamp to the remaining output: strip_counts is file-controlled
      // and may exceed h*w*c (heap overflow otherwise).
      size_t vals = bytes / 2;
      if (vals > total - written) vals = total - written;
      memcpy(out + written, src, vals * 2);  // little-endian host assumed
      written += vals;
    } else {  // 8-bit: widen
      for (size_t i = 0; i < bytes && written < total; i++)
        out[written++] = src[i];
    }
  }
  free(buf);
  return written == total ? 0 : 4;
}

// Single-strip little-endian uint16 writer (mirrors data/tiff.py).
int lg_tiff_write_u16(const char* path, const uint16_t* data, int h, int w,
                      int c) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  size_t payload = (size_t)h * w * c * 2;
  uint32_t data_offset = 8;
  uint32_t extra_offset = (uint32_t)(data_offset + payload);
  int write_bits_array = c > 2;
  uint32_t bits_offset = extra_offset;
  uint32_t ifd_offset = extra_offset + (write_bits_array ? ((2 * c + 1) & ~1) : 0);

  uint8_t header[8] = {'I', 'I', 42, 0};
  memcpy(header + 4, &ifd_offset, 4);
  fwrite(header, 1, 8, f);
  fwrite(data, 1, payload, f);
  if (write_bits_array) {
    for (int i = 0; i < c; i++) {
      uint16_t v = 16;
      fwrite(&v, 2, 1, f);
    }
    if ((2 * c) & 1) fputc(0, f);
  }

  struct Entry {
    uint16_t tag, type;
    uint32_t count, value;
  };
  Entry entries[] = {
      {256, 4, 1, (uint32_t)w},
      {257, 4, 1, (uint32_t)h},
      {258, 3, (uint32_t)c,
       write_bits_array ? bits_offset : (uint32_t)16},
      {259, 3, 1, 1},
      {262, 3, 1, 1},
      {273, 4, 1, data_offset},
      {277, 3, 1, (uint32_t)c},
      {278, 4, 1, (uint32_t)h},
      {279, 4, 1, (uint32_t)payload},
      {284, 3, 1, 1},
      {339, 3, 1, 1},
  };
  uint16_t n = sizeof(entries) / sizeof(Entry);
  fwrite(&n, 2, 1, f);
  for (auto& e : entries) {
    fwrite(&e.tag, 2, 1, f);
    fwrite(&e.type, 2, 1, f);
    fwrite(&e.count, 4, 1, f);
    fwrite(&e.value, 4, 1, f);
  }
  uint32_t zero = 0;
  fwrite(&zero, 4, 1, f);
  fclose(f);
  return 0;
}

// ---------------- parallel batch decode ----------------

struct BatchJob {
  const char** paths;
  float* out;       // [n, h*w*c] float32
  int n, elems;
  float scale;      // 1/normaliser (0 -> no normalisation)
  int next;         // work index
  pthread_mutex_t mu;
  int error;
};

void* batch_worker(void* arg) {
  BatchJob* job = (BatchJob*)arg;
  uint16_t* tmp = (uint16_t*)malloc((size_t)job->elems * 2);
  for (;;) {
    pthread_mutex_lock(&job->mu);
    int i = job->next++;
    pthread_mutex_unlock(&job->mu);
    if (i >= job->n) break;
    // Each file's decoded size must match the caller's tile shape; a
    // larger one is refused before it is written (capacity elems).
    int fh, fw, fc;
    if (lg_tiff_read_u16_dims(job->paths[i], tmp, job->elems, &fh, &fw,
                              &fc) != 0 ||
        (size_t)fh * fw * fc != (size_t)job->elems) {
      job->error = i + 1;
      break;
    }
    float* dst = job->out + (size_t)i * job->elems;
    float s = job->scale != 0.0f ? job->scale : 1.0f;
    for (int k = 0; k < job->elems; k++) dst[k] = tmp[k] * s;
  }
  free(tmp);
  return nullptr;
}

// Decode n equally-shaped tiles into out[n, h*w*c] (float32, scaled by
// `scale`, e.g. 1/2047.5) using `threads` workers. -> 0 on success.
int lg_tiff_read_batch(const char** paths, int n, float* out, int elems,
                       float scale, int threads) {
  if (threads < 1) threads = 1;
  if (threads > 16) threads = 16;
  BatchJob job{paths, out, n, elems, scale, 0, PTHREAD_MUTEX_INITIALIZER, 0};
  pthread_t tids[16];
  for (int t = 0; t < threads; t++)
    pthread_create(&tids[t], nullptr, batch_worker, &job);
  for (int t = 0; t < threads; t++) pthread_join(tids[t], nullptr);
  return job.error;
}

}  // extern "C"
