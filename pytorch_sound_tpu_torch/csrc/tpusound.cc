// tpusound: the native audio runtime of pytorch_sound_tpu_torch, host code.
//
// A copy of the JAX package's csrc/tpusound.cc, the same code: only the
// comments differ, so the two libraries give the same bits. In-process WAV
// decode and resampling, called through ctypes by
// pytorch_sound_tpu_torch/native.py:
//   - RIFF/WAVE decode (PCM 8/16/24/32, IEEE float32/64) to float32 mono
//   - Kaiser-windowed polyphase rational resampler
//   - RMS normalization, mu-law encode/decode (MULAW_BINS quantization)
//   - a pthread worker pool for GIL-free batch decode+resample
//
// Built with g++ (not nvcc: the kernel build takes only .cu / .cuh) at first
// use into csrc/build/ by native.load_library().

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decoding
// ---------------------------------------------------------------------------

static int read_chunk_header(FILE* f, char id[4], uint32_t* size) {
  if (fread(id, 1, 4, f) != 4) return -1;
  if (fread(size, 4, 1, f) != 1) return -1;
  return 0;
}

// Header-only info query. Returns 0 on success.
int ts_wav_info(const char* path, int* sample_rate, int64_t* n_frames,
                int* channels, int* bits) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char riff[12];
  if (fread(riff, 1, 12, f) != 12 || memcmp(riff, "RIFF", 4) ||
      memcmp(riff + 8, "WAVE", 4)) {
    fclose(f);
    return -2;
  }
  int block_align = 1;
  *sample_rate = *channels = *bits = 0;
  *n_frames = 0;
  char id[4];
  uint32_t size;
  while (read_chunk_header(f, id, &size) == 0) {
    if (!memcmp(id, "fmt ", 4)) {
      uint8_t fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) break;
      *channels = fmt[2] | (fmt[3] << 8);
      *sample_rate = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) | (fmt[7] << 24);
      block_align = fmt[12] | (fmt[13] << 8);
      *bits = fmt[14] | (fmt[15] << 8);
      if (size > 16) fseek(f, size - 16 + (size & 1), SEEK_CUR);
    } else if (!memcmp(id, "data", 4)) {
      *n_frames = block_align ? (int64_t)size / block_align : 0;
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  return (*sample_rate > 0) ? 0 : -3;
}

// Decode to float32, mono-mixed. `out` must hold >= n_frames floats
// (query with ts_wav_info first). Returns number of samples written, <0 on error.
int64_t ts_read_wav(const char* path, float* out, int64_t max_samples,
                    int* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char riff[12];
  if (fread(riff, 1, 12, f) != 12 || memcmp(riff, "RIFF", 4) ||
      memcmp(riff + 8, "WAVE", 4)) {
    fclose(f);
    return -2;
  }
  int channels = 1, bits = 16, fmt_tag = 1, block_align = 2;
  char id[4];
  uint32_t size;
  int64_t written = -3;
  while (read_chunk_header(f, id, &size) == 0) {
    if (!memcmp(id, "fmt ", 4)) {
      std::vector<uint8_t> fmt(size);
      if (fread(fmt.data(), 1, size, f) != size) break;
      fmt_tag = fmt[0] | (fmt[1] << 8);
      channels = fmt[2] | (fmt[3] << 8);
      *sample_rate = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) | (fmt[7] << 24);
      block_align = fmt[12] | (fmt[13] << 8);
      bits = fmt[14] | (fmt[15] << 8);
      if (fmt_tag == 0xFFFE && size >= 40)  // WAVE_FORMAT_EXTENSIBLE
        fmt_tag = fmt[24] | (fmt[25] << 8);
      if (size & 1) fseek(f, 1, SEEK_CUR);
    } else if (!memcmp(id, "data", 4)) {
      int64_t n_frames = block_align ? (int64_t)size / block_align : 0;
      if (n_frames > max_samples) n_frames = max_samples;
      std::vector<uint8_t> raw((size_t)n_frames * block_align);
      size_t got = fread(raw.data(), 1, raw.size(), f);
      n_frames = (int64_t)(got / block_align);
      const double inv_ch = 1.0 / channels;
      for (int64_t i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < channels; ++c) {
          const uint8_t* p = raw.data() + i * block_align + c * (bits / 8);
          double v = 0.0;
          if (fmt_tag == 3) {  // IEEE float
            if (bits == 32) {
              float fv;
              memcpy(&fv, p, 4);
              v = fv;
            } else {
              double dv;
              memcpy(&dv, p, 8);
              v = dv;
            }
          } else {  // PCM
            if (bits == 16) {
              int16_t s;
              memcpy(&s, p, 2);
              v = s / 32768.0;
            } else if (bits == 32) {
              int32_t s;
              memcpy(&s, p, 4);
              v = s / 2147483648.0;
            } else if (bits == 24) {
              int32_t s = p[0] | (p[1] << 8) | (p[2] << 16);
              if (s & 0x800000) s -= 0x1000000;
              v = s / 8388608.0;
            } else if (bits == 8) {
              v = ((int)p[0] - 128) / 128.0;
            }
          }
          acc += v;
        }
        out[i] = (float)(acc * inv_ch);
      }
      written = n_frames;
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  return written;
}

// Write mono float32 samples as an IEEE-float WAV.
int ts_write_wav(const char* path, const float* samples, int64_t n,
                 int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_size = (uint32_t)(n * 4);
  uint32_t riff_size = 36 + data_size;
  uint16_t fmt_tag = 3, channels = 1, bits = 32;
  uint32_t byte_rate = sample_rate * 4;
  uint16_t block_align = 4;
  uint32_t fmt_size = 16;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt_tag, 2, 1, f);
  fwrite(&channels, 2, 1, f);
  fwrite(&sample_rate, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block_align, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_size, 4, 1, f);
  fwrite(samples, 4, (size_t)n, f);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Polyphase rational resampler (Kaiser-windowed sinc prototype)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // power-series modified Bessel I0 (converges fast for window design)
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

// Output length for ts_resample.
int64_t ts_resample_out_len(int64_t n_in, int up, int down) {
  return (n_in * up + down - 1) / down;
}

// Rational resample by up/down with a Kaiser(beta=8.6) polyphase sinc bank:
// the prototype is decomposed into `up` phases of contiguous taps so the
// inner loop is a straight dot product (no division/modulo per tap).
// `out` must hold ts_resample_out_len(n_in, up, down) floats.
int64_t ts_resample(const float* in, int64_t n_in, float* out, int up,
                    int down) {
  if (up == down) {
    memcpy(out, in, (size_t)n_in * 4);
    return n_in;
  }
  const int taps_per_phase = 24;
  const double beta = 8.6;
  const int half = (taps_per_phase / 2) * up;
  const double cutoff = 1.0 / (up > down ? up : down);  // rel. to up-rate nyquist
  const double i0b = bessel_i0(beta);

  // polyphase bank. Output m sits at up-rate index up_idx = m*down =
  // q*up + r; source s = q - h_src + j taps the prototype at offset
  // t = up_idx - s*up = r + (h_src - j)*up. Precompute bank[r][j] = proto(t).
  const int h_src = taps_per_phase / 2;
  std::vector<float> bank((size_t)up * taps_per_phase);
  for (int r = 0; r < up; ++r) {
    for (int j = 0; j < taps_per_phase; ++j) {
      double t = (double)r + (double)(h_src - j) * up;  // prototype offset
      double sinc = (t == 0.0) ? cutoff : sin(M_PI * cutoff * t) / (M_PI * t);
      double frac = t / (half + 1.0);
      double w = bessel_i0(beta * sqrt(fmax(0.0, 1.0 - frac * frac))) / i0b;
      bank[(size_t)r * taps_per_phase + j] = (float)(sinc * w * up);
    }
  }

  int64_t n_out = ts_resample_out_len(n_in, up, down);
  for (int64_t m = 0; m < n_out; ++m) {
    int64_t up_idx = m * down;              // position in the up-rate stream
    int64_t src0 = up_idx / up - h_src;     // first source sample tapped
    int phase = (int)(up_idx % up);
    const float* h = &bank[(size_t)phase * taps_per_phase];
    double acc = 0.0;
    if (src0 >= 0 && src0 + taps_per_phase <= n_in) {
      const float* s = in + src0;
      for (int j = 0; j < taps_per_phase; ++j) acc += (double)h[j] * s[j];
    } else {
      for (int j = 0; j < taps_per_phase; ++j) {
        int64_t s = src0 + j;
        if (s >= 0 && s < n_in) acc += (double)h[j] * in[s];
      }
    }
    out[m] = (float)acc;
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Normalization + mu-law
// ---------------------------------------------------------------------------

void ts_rms_normalize(float* x, int64_t n, float target_db) {
  double sq = 0.0;
  for (int64_t i = 0; i < n; ++i) sq += (double)x[i] * x[i];
  double rms = sqrt(sq / (n > 0 ? n : 1));
  if (rms < 1e-10) return;
  double gain = pow(10.0, target_db / 20.0) / rms;
  for (int64_t i = 0; i < n; ++i) x[i] = (float)(x[i] * gain);
}

// mu-law companding to `bins` levels (settings.MULAW_BINS = 256).
void ts_mulaw_encode(const float* x, int64_t n, int bins, int32_t* out) {
  double mu = bins - 1;
  for (int64_t i = 0; i < n; ++i) {
    double v = x[i] < -1 ? -1 : (x[i] > 1 ? 1 : x[i]);
    double y = copysign(log1p(mu * fabs(v)) / log1p(mu), v);
    out[i] = (int32_t)((y + 1.0) / 2.0 * mu + 0.5);
  }
}

void ts_mulaw_decode(const int32_t* q, int64_t n, int bins, float* out) {
  double mu = bins - 1;
  for (int64_t i = 0; i < n; ++i) {
    double y = 2.0 * q[i] / mu - 1.0;
    out[i] = (float)(copysign((pow(1.0 + mu, fabs(y)) - 1.0) / mu, y));
  }
}

// ---------------------------------------------------------------------------
// Batch pipeline: decode -> resample -> normalize, parallel across files.
// Outputs are written into caller-provided per-file buffers. lens[i] receives
// the produced sample count (or <0 on error). GIL-free (pure pthread).
// ---------------------------------------------------------------------------

int ts_batch_load(const char** paths, int n_files, int target_sr,
                  float norm_db, int do_norm, float** outs,
                  const int64_t* out_caps, int64_t* lens, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  std::vector<int> next_idx(1, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n_files; i += n_threads) {
      int sr = 0, ch = 0, bits = 0;
      int64_t frames = 0;
      if (ts_wav_info(paths[i], &sr, &frames, &ch, &bits) != 0) {
        lens[i] = -1;
        continue;
      }
      std::vector<float> buf((size_t)frames);
      int64_t got = ts_read_wav(paths[i], buf.data(), frames, &sr);
      if (got < 0) {
        lens[i] = -2;
        continue;
      }
      float* dst = outs[i];
      int64_t produced;
      if (sr != target_sr && target_sr > 0) {
        int64_t g = std::gcd((int64_t)sr, (int64_t)target_sr);
        int up = (int)(target_sr / g), down = (int)(sr / g);
        int64_t need = ts_resample_out_len(got, up, down);
        if (need > out_caps[i]) {
          lens[i] = -3;
          continue;
        }
        produced = ts_resample(buf.data(), got, dst, up, down);
      } else {
        produced = got < out_caps[i] ? got : out_caps[i];
        memcpy(dst, buf.data(), (size_t)produced * 4);
      }
      if (do_norm) ts_rms_normalize(dst, produced, norm_db);
      lens[i] = produced;
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Target-rate wire-format batch decode: decode -> resample to target_sr ->
// reflect-tail -> quantize, each file in a worker thread, rows written into
// one contiguous zero-padded matrix. mode 0 = int16 rows; mode 1 =
// mu-law-256 uint8 rows (matches ts_mulaw_encode). tail_ext > 0 mirrors up
// to that many trailing samples into the zero tail (the mel half-window
// context; see scripts/preprocess.py extract_features). lens[i] = produced
// sample count at the target rate (<0 on error).
// ---------------------------------------------------------------------------

int ts_batch_load_wire(const char** paths, int n_files, int target_sr,
                       void* out, int64_t pad_len, int mode, int tail_ext,
                       int64_t* lens, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  auto work = [&](int tid) {
    std::vector<float> row((size_t)pad_len);
    for (int i = tid; i < n_files; i += n_threads) {
      int16_t* row16 = (int16_t*)out + (size_t)i * pad_len;
      uint8_t* row8 = (uint8_t*)out + (size_t)i * pad_len;
      auto zero_row = [&]() {
        if (mode == 1) {
          // mu-law code for 0.0 is 128 after rounding; keep the padded
          // tail at the SAME code the device decodes to exactly 0 region
          memset(row8, 128, (size_t)pad_len);
        } else {
          memset(row16, 0, (size_t)pad_len * 2);
        }
      };
      int sr = 0, ch = 0, bits = 0;
      int64_t frames = 0;
      if (ts_wav_info(paths[i], &sr, &frames, &ch, &bits) != 0) {
        lens[i] = -1;
        zero_row();
        continue;
      }
      std::vector<float> buf((size_t)frames);
      int64_t got = ts_read_wav(paths[i], buf.data(), frames, &sr);
      if (got < 0) {
        lens[i] = -2;
        zero_row();
        continue;
      }
      std::fill(row.begin(), row.end(), 0.0f);
      int64_t produced;
      if (sr != target_sr && target_sr > 0) {
        int64_t g = std::gcd((int64_t)sr, (int64_t)target_sr);
        int up = (int)(target_sr / g), down = (int)(sr / g);
        int64_t need = ts_resample_out_len(got, up, down);
        if (need > pad_len) {
          // resample in full, then crop — cropping the SOURCE first would
          // put the resampler's edge transient at the crop point (the
          // python path crops after resampling)
          std::vector<float> full((size_t)need);
          ts_resample(buf.data(), got, full.data(), up, down);
          memcpy(row.data(), full.data(), (size_t)pad_len * 4);
          produced = pad_len;
        } else {
          produced = ts_resample(buf.data(), got, row.data(), up, down);
        }
      } else {
        produced = got < pad_len ? got : pad_len;
        memcpy(row.data(), buf.data(), (size_t)produced * 4);
      }
      if (tail_ext > 0) {
        int64_t e = tail_ext;
        if (e > produced - 1) e = produced - 1;
        if (e > pad_len - produced) e = pad_len - produced;
        for (int64_t j = 0; j < e; ++j)
          row[produced + j] = row[produced - 2 - j];
      }
      if (mode == 1) {
        double mu = 255.0;
        double ln1pmu = log1p(mu);
        for (int64_t j = 0; j < pad_len; ++j) {
          double v = row[j] < -1 ? -1 : (row[j] > 1 ? 1 : row[j]);
          double y = copysign(log1p(mu * fabs(v)) / ln1pmu, v);
          row8[j] = (uint8_t)((y + 1.0) / 2.0 * mu + 0.5);
        }
      } else {
        for (int64_t j = 0; j < pad_len; ++j) {
          float v = row[j] * 32768.0f;
          row16[j] = (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
        }
      }
      lens[i] = produced;
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();
  return 0;
}

// ---------------------------------------------------------------------------
// int16 wire-format batch decode: rows of a contiguous (n_files, pad_len)
// int16 matrix, zero-padded — the host->device payload for the on-device
// resample+mel pipeline (half the bytes of f32, and the device converts with
// one multiply). 16-bit PCM mono sources stream straight from the file into
// the row (no float round-trip); everything else — including rare 16-bit
// non-PCM codecs (the fast path checks the extensible-resolved wFormatTag
// and requires PCM) — goes through the f32 decoder and quantizes with
// clamping, so f32/24-bit sources are reduced to int16 on this wire (see
// native.batch_load_i16's docstring). lens[i] = true sample count
// (<0 on error); srs[i] = source sample rate.
// ---------------------------------------------------------------------------

int ts_batch_load_i16(const char** paths, int n_files, int16_t* out,
                      int64_t pad_len, int64_t* lens, int* srs,
                      int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  auto work = [&](int tid) {
    for (int i = tid; i < n_files; i += n_threads) {
      int16_t* row = out + (size_t)i * pad_len;
      int sr = 0, ch = 0, bits = 0;
      int64_t frames = 0;
      if (ts_wav_info(paths[i], &sr, &frames, &ch, &bits) != 0) {
        lens[i] = -1;
        memset(row, 0, (size_t)pad_len * 2);
        continue;
      }
      srs[i] = sr;
      int64_t n = frames < pad_len ? frames : pad_len;
      int64_t got = -1;
      if (bits == 16 && ch == 1) {
        // PCM16 mono: locate the data chunk and fread into the row directly.
        // The fmt chunk is re-read on this walk so the memcpy only fires for
        // true PCM (wFormatTag 1, extensible-resolved) — a 16-bit compressed
        // codec falls through to the general decoder instead of being
        // streamed as raw PCM garbage.
        FILE* f = fopen(paths[i], "rb");
        if (f) {
          char riff[12];
          char id[4];
          uint32_t size;
          int fmt_tag = 0;
          if (fread(riff, 1, 12, f) == 12) {
            while (read_chunk_header(f, id, &size) == 0) {
              if (!memcmp(id, "fmt ", 4)) {
                std::vector<uint8_t> fmt(size);
                if (fread(fmt.data(), 1, size, f) != size) break;
                fmt_tag = fmt[0] | (fmt[1] << 8);
                if (fmt_tag == 0xFFFE && size >= 40)  // WAVE_FORMAT_EXTENSIBLE
                  fmt_tag = fmt[24] | (fmt[25] << 8);
                if (size & 1) fseek(f, 1, SEEK_CUR);
              } else if (!memcmp(id, "data", 4)) {
                if (fmt_tag == 1)  // PCM only
                  got = (int64_t)fread(row, 2, (size_t)n, f);
                break;
              } else {
                fseek(f, size + (size & 1), SEEK_CUR);
              }
            }
          }
          fclose(f);
        }
      }
      if (got < 0) {   // general path: f32 decode + clamped quantization
        std::vector<float> buf((size_t)n);
        got = ts_read_wav(paths[i], buf.data(), n, &sr);
        if (got < 0) {
          lens[i] = -2;
          memset(row, 0, (size_t)pad_len * 2);
          continue;
        }
        for (int64_t s = 0; s < got; ++s) {
          float v = buf[s] * 32768.0f;
          if (v > 32767.0f) v = 32767.0f;
          if (v < -32768.0f) v = -32768.0f;
          row[s] = (int16_t)lrintf(v);
        }
      }
      memset(row + got, 0, (size_t)(pad_len - got) * 2);
      lens[i] = got;
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();
  return 0;
}

}  // extern "C"
