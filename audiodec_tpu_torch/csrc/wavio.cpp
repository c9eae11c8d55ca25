// Native WAV (RIFF) reader and writer of the port's data pipeline (a copy
// of the JAX package's csrc/wavio.cpp).
//
// PCM 16/24/32-bit and IEEE float32, mono or multi-channel, and the
// WAVE_FORMAT_EXTENSIBLE header; writes PCM16.  A C interface, loaded
// with ctypes by audiodec_tpu_torch/data/wav.py, which builds it at first
// use (ops/kernels/_build.py: g++ -O3 -shared -fPIC into
// build/audiodec_tpu_torch/libwavio.so).  The reads give the samples of
// data/wav.py's numpy reader bit for bit; the writer rounds in double, as
// that module's numpy writer does, so that the two write the same bytes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct RiffChunk {
  char id[4];
  uint32_t size;
};

struct FmtInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float, 0xFFFE = extensible
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
};

// Scans the RIFF chunk list; fills fmt and locates the data payload.
// Returns 0 on success.
int parse_header(FILE* f, FmtInfo* fmt, long* data_offset,
                 uint32_t* data_size) {
  char riff[12];
  if (fread(riff, 1, 12, f) != 12) return -1;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0)
    return -2;
  bool have_fmt = false, have_data = false;
  RiffChunk ck;
  while (fread(&ck, 1, 8, f) == 8) {
    if (memcmp(ck.id, "fmt ", 4) == 0) {
      unsigned char buf[40];
      uint32_t n = ck.size < sizeof(buf) ? ck.size : (uint32_t)sizeof(buf);
      if (fread(buf, 1, n, f) != n) return -3;
      if (ck.size > n && fseek(f, ck.size - n, SEEK_CUR) != 0) return -3;
      fmt->format = (uint16_t)(buf[0] | buf[1] << 8);
      fmt->channels = (uint16_t)(buf[2] | buf[3] << 8);
      fmt->sample_rate =
          (uint32_t)(buf[4] | buf[5] << 8 | buf[6] << 16 | (uint32_t)buf[7] << 24);
      fmt->bits = (uint16_t)(buf[14] | buf[15] << 8);
      if (fmt->format == 0xFFFE && ck.size >= 26) {
        // WAVE_FORMAT_EXTENSIBLE: actual format is the sub-format GUID's
        // first two bytes
        fmt->format = (uint16_t)(buf[24] | buf[25] << 8);
      }
      have_fmt = true;
    } else if (memcmp(ck.id, "data", 4) == 0) {
      *data_offset = ftell(f);
      *data_size = ck.size;
      have_data = true;
      if (fseek(f, (ck.size + 1) & ~1u, SEEK_CUR) != 0) break;
    } else {
      if (fseek(f, (ck.size + 1) & ~1u, SEEK_CUR) != 0) return -4;
    }
    if (have_fmt && have_data) break;
  }
  return (have_fmt && have_data) ? 0 : -5;
}

}  // namespace

extern "C" {

// Returns 0 on success; outputs sample_rate, channels, frames.
int wav_info(const char* path, int* sample_rate, int* channels,
             int64_t* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  FmtInfo fmt;
  long off;
  uint32_t size;
  int rc = parse_header(f, &fmt, &off, &size);
  fclose(f);
  if (rc != 0) return rc;
  if (fmt.channels == 0 || fmt.bits == 0) return -6;
  *sample_rate = (int)fmt.sample_rate;
  *channels = (int)fmt.channels;
  *frames = (int64_t)size / (fmt.bits / 8) / fmt.channels;
  return 0;
}

// Reads interleaved float32 samples in [-1, 1].  `out` must hold
// frames*channels floats (use wav_info first).  Returns frames read, <0 error.
int64_t wav_read_f32(const char* path, float* out, int64_t max_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  FmtInfo fmt;
  long off;
  uint32_t size;
  int rc = parse_header(f, &fmt, &off, &size);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  const int bytes = fmt.bits / 8;
  int64_t frames = (int64_t)size / bytes / fmt.channels;
  if (frames > max_frames) frames = max_frames;
  int64_t n = frames * fmt.channels;
  fseek(f, off, SEEK_SET);

  std::vector<unsigned char> raw((size_t)(n * bytes));
  if ((int64_t)fread(raw.data(), bytes, (size_t)n, f) != n) {
    fclose(f);
    return -7;
  }
  fclose(f);

  const unsigned char* p = raw.data();
  if (fmt.format == 3 && fmt.bits == 32) {
    memcpy(out, p, (size_t)n * 4);
  } else if (fmt.format == 1 && fmt.bits == 16) {
    const float s = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; i++) {
      int16_t v = (int16_t)(p[2 * i] | p[2 * i + 1] << 8);
      out[i] = v * s;
    }
  } else if (fmt.format == 1 && fmt.bits == 24) {
    const float s = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < n; i++) {
      int32_t v = p[3 * i] | p[3 * i + 1] << 8 | p[3 * i + 2] << 16;
      if (v & 0x800000) v |= ~0xFFFFFF;  // sign extend
      out[i] = v * s;
    }
  } else if (fmt.format == 1 && fmt.bits == 32) {
    const float s = 1.0f / 2147483648.0f;
    for (int64_t i = 0; i < n; i++) {
      int32_t v;
      memcpy(&v, p + 4 * i, 4);
      out[i] = v * s;
    }
  } else {
    return -8;  // unsupported format
  }
  return frames;
}

// Writes interleaved float32 data as PCM16 (the reference's output format,
// ref: bin/test.py sf.write(..., "PCM_16")).  Returns 0 on success.
int wav_write_pcm16(const char* path, const float* data, int64_t frames,
                    int channels, int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int64_t n = frames * channels;
  uint32_t data_size = (uint32_t)(n * 2);
  uint32_t block_align = (uint32_t)channels * 2;
  uint32_t byte_rate = (uint32_t)sample_rate * block_align;

  unsigned char hdr[44];
  memcpy(hdr, "RIFF", 4);
  uint32_t riff_size = 36 + data_size;
  memcpy(hdr + 4, &riff_size, 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  memcpy(hdr + 16, &fmt_size, 4);
  uint16_t fmt_tag = 1, nch = (uint16_t)channels, bits = 16,
           balign = (uint16_t)block_align;
  memcpy(hdr + 20, &fmt_tag, 2);
  memcpy(hdr + 22, &nch, 2);
  memcpy(hdr + 24, &sample_rate, 4);
  memcpy(hdr + 28, &byte_rate, 4);
  memcpy(hdr + 32, &balign, 2);
  memcpy(hdr + 34, &bits, 2);
  memcpy(hdr + 36, "data", 4);
  memcpy(hdr + 40, &data_size, 4);
  fwrite(hdr, 1, 44, f);

  // scale by 32768 with clamping so decode (/32768) is symmetric,
  // max error 0.5 LSB (libsndfile convention); the scaled sample is exact
  // in float, the half added in double (numpy's float64 `where`), so no
  // sum just below a half rounds up
  std::vector<int16_t> buf((size_t)n);
  for (int64_t i = 0; i < n; i++) {
    double v = (double)(data[i] * 32768.0f);
    double r = v + (v >= 0 ? 0.5 : -0.5);
    if (r > 32767.0) r = 32767.0;
    if (r < -32768.0) r = -32768.0;
    int32_t q = (int32_t)r;
    buf[(size_t)i] = (int16_t)q;
  }
  fwrite(buf.data(), 2, (size_t)n, f);
  fclose(f);
  return 0;
}

}  // extern "C"
