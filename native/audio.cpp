// Native audio decode for whisper_ipa: WAV parsing + resampling.
//
// The reference shells out to ffmpeg per file (mlx_whisper.audio.load_audio
// consumed at reference scripts/ipa_data_loader.py:48) — a process spawn and
// pipe copy per utterance. This decoder parses RIFF/WAVE in-process
// (PCM 8/16/24/32-bit and float32, any channel count -> mono float32) and
// resamples with a windowed-sinc polyphase filter. Exposed through ctypes
// (whisper_ipa/audio/native.py); the Python implementation remains the
// fallback.
//
// Build: make -C native

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Wav {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

bool parse_wav(const uint8_t* data, int64_t size, Wav* out) {
  if (size < 44 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0) {
    return false;
  }
  int64_t pos = 12;
  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* pcm = nullptr;
  int64_t pcm_bytes = 0;

  while (pos + 8 <= size) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk_size = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk_size >= 16) {
      format = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (format == 0xFFFE && chunk_size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        format = rd_u16(body + 24);
      }
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      pcm = body;
      pcm_bytes = std::min<int64_t>(chunk_size, size - pos - 8);
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (!pcm || channels == 0 || rate == 0) return false;

  const int bytes_per = bits / 8;
  if (bytes_per == 0) return false;
  const int64_t frames = pcm_bytes / (bytes_per * channels);
  out->samples.resize(frames);
  out->sample_rate = static_cast<int>(rate);

  const float inv_ch = 1.0f / channels;
  for (int64_t f = 0; f < frames; ++f) {
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = pcm + (f * channels + c) * bytes_per;
      float v = 0.0f;
      if (format == 3 && bits == 32) {  // IEEE float
        float tmp;
        std::memcpy(&tmp, s, 4);
        v = tmp;
      } else if (bits == 16) {
        int16_t tmp;
        std::memcpy(&tmp, s, 2);
        v = tmp / 32768.0f;
      } else if (bits == 8) {
        v = (static_cast<int>(s[0]) - 128) / 128.0f;
      } else if (bits == 24) {
        int32_t tmp = (static_cast<int32_t>(s[0]) << 8) |
                      (static_cast<int32_t>(s[1]) << 16) |
                      (static_cast<int32_t>(s[2]) << 24);
        v = (tmp >> 8) / 8388608.0f;
      } else if (bits == 32) {
        int32_t tmp;
        std::memcpy(&tmp, s, 4);
        v = tmp / 2147483648.0f;
      }
      acc += v;
    }
    out->samples[f] = acc * inv_ch;
  }
  return true;
}

// Windowed-sinc polyphase resampler (Hann window, 16 taps/phase).
std::vector<float> resample(const std::vector<float>& in, int sr_in,
                            int sr_out) {
  if (sr_in == sr_out || in.empty()) return in;
  const double ratio = static_cast<double>(sr_out) / sr_in;
  const int64_t n_out =
      static_cast<int64_t>(std::llround(in.size() * ratio));
  std::vector<float> out(n_out);

  const int HALF_TAPS = 8;
  const double cutoff = std::min(1.0, ratio) * 0.95;  // anti-alias

  for (int64_t i = 0; i < n_out; ++i) {
    const double center = i / ratio;
    const int64_t left = static_cast<int64_t>(std::floor(center)) - HALF_TAPS + 1;
    double acc = 0.0, wsum = 0.0;
    for (int64_t j = left; j < left + 2 * HALF_TAPS; ++j) {
      const double x = (center - j) * cutoff;
      double sinc = (std::abs(x) < 1e-9) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
      const double t = (j - center) / (2.0 * HALF_TAPS);
      const double win = 0.5 + 0.5 * std::cos(2.0 * M_PI * t);
      const double w = sinc * cutoff * win;
      wsum += w;
      if (j >= 0 && j < static_cast<int64_t>(in.size())) {
        acc += w * in[j];
      }
    }
    // normalize by the window sum: unity DC gain regardless of phase
    out[i] = static_cast<float>(acc / (wsum > 1e-12 ? wsum : 1.0));
  }
  return out;
}

}  // namespace

extern "C" {

// Decode WAV bytes to mono float32 at target_sr.
// Returns number of output samples, or -1 on parse failure.
// Two-call protocol: pass out=nullptr to query the length first.
int64_t wipa_decode_wav(const uint8_t* data, int64_t size, int target_sr,
                        float* out, int64_t out_capacity) {
  Wav wav;
  if (!parse_wav(data, size, &wav)) return -1;
  std::vector<float> res = resample(wav.samples, wav.sample_rate, target_sr);
  const int64_t n = static_cast<int64_t>(res.size());
  if (out != nullptr) {
    if (out_capacity < n) return -2;
    std::memcpy(out, res.data(), n * sizeof(float));
  }
  return n;
}

}  // extern "C"
