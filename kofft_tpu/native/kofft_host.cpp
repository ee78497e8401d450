// kofft-tpu native host runtime.
//
// The reference implements its host-side runtime (audio decode, PNG
// encoding, streaming OLA state) in Rust (sanity-check/src/lib.rs,
// src/stft.rs:407-520); here the equivalents are C++ behind a C ABI,
// loaded via ctypes with pure-Python fallbacks. The device compute path
// stays JAX/XLA — this library covers the host loops that would otherwise
// bottleneck ingest/render pipelines.
//
// Build: g++ -O3 -march=native -shared -fPIC kofft_host.cpp -lz -o
//        libkofft_host.so

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------
// PNG encoding (RGB8 / RGB16, filter 0, zlib level 9)
// Matches the Python encoder in kofft_tpu/utils/image.py byte-for-byte.
// ---------------------------------------------------------------------

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back(x >> 24); v.push_back(x >> 16);
    v.push_back(x >> 8);  v.push_back(x);
}

static void chunk(std::vector<uint8_t>& out, const char tag[4],
                  const uint8_t* data, size_t len) {
    put_be32(out, (uint32_t)len);
    size_t start = out.size();
    out.insert(out.end(), tag, tag + 4);
    out.insert(out.end(), data, data + len);
    uLong crc = crc32(0L, out.data() + start, (uInt)(len + 4));
    put_be32(out, (uint32_t)crc);
}

// rgb: row-major (h, w, 3); depth 8 (uint8 data) or 16 (big-endian uint16).
// Returns malloc'd buffer in *out (caller frees via kofft_free), length as
// return value; 0 on error.
int64_t kofft_png_encode(const uint8_t* rgb, int64_t w, int64_t h,
                         int depth, uint8_t** out) {
    if (w <= 0 || h <= 0 || (depth != 8 && depth != 16)) return 0;
    const size_t bpp = (depth == 8 ? 3 : 6);
    const size_t stride = (size_t)w * bpp;
    // filter-0 scanlines
    std::vector<uint8_t> scan((stride + 1) * h);
    for (int64_t y = 0; y < h; ++y) {
        scan[y * (stride + 1)] = 0;
        std::memcpy(&scan[y * (stride + 1) + 1], rgb + y * stride, stride);
    }
    uLongf bound = compressBound((uLong)scan.size());
    std::vector<uint8_t> comp(bound);
    if (compress2(comp.data(), &bound, scan.data(), (uLong)scan.size(), 9)
        != Z_OK)
        return 0;
    comp.resize(bound);

    std::vector<uint8_t> png;
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                   '\n'};
    png.insert(png.end(), sig, sig + 8);
    uint8_t ihdr[13];
    ihdr[0] = (uint8_t)(w >> 24); ihdr[1] = (uint8_t)(w >> 16);
    ihdr[2] = (uint8_t)(w >> 8);  ihdr[3] = (uint8_t)w;
    ihdr[4] = (uint8_t)(h >> 24); ihdr[5] = (uint8_t)(h >> 16);
    ihdr[6] = (uint8_t)(h >> 8);  ihdr[7] = (uint8_t)h;
    ihdr[8] = (uint8_t)depth; ihdr[9] = 2;  // RGB
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    chunk(png, "IHDR", ihdr, 13);
    chunk(png, "IDAT", comp.data(), comp.size());
    chunk(png, "IEND", nullptr, 0);

    uint8_t* buf = (uint8_t*)std::malloc(png.size());
    if (!buf) return 0;
    std::memcpy(buf, png.data(), png.size());
    *out = buf;
    return (int64_t)png.size();
}

void kofft_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------
// WAV decode: PCM i16 -> f32/32767 (reference hound semantics,
// sanity-check/src/lib.rs:99-107). Returns sample count, fills *out
// (malloc'd), *sample_rate, *channels; samples stay interleaved.
// ---------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
         | ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
    return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

int64_t kofft_wav_decode_i16(const uint8_t* data, int64_t len, float** out,
                             int32_t* sample_rate, int32_t* channels) {
    if (len < 44 || std::memcmp(data, "RIFF", 4)
        || std::memcmp(data + 8, "WAVE", 4))
        return -1;
    int64_t pos = 12;
    int32_t sr = 0, ch = 0, bits = 0;
    const uint8_t* pcm = nullptr;
    int64_t pcm_len = 0;
    while (pos + 8 <= len) {
        const uint8_t* hdr = data + pos;
        uint32_t sz = rd_u32(hdr + 4);
        const uint8_t* body = hdr + 8;
        if (!std::memcmp(hdr, "fmt ", 4) && sz >= 16
            && pos + 8 + 16 <= len) {   // body must hold the 16 read bytes
            ch = rd_u16(body + 2);
            sr = (int32_t)rd_u32(body + 4);
            bits = rd_u16(body + 14);
        } else if (!std::memcmp(hdr, "data", 4)) {
            pcm = body;
            pcm_len = sz;
            if (pcm + pcm_len > data + len) pcm_len = data + len - pcm;
        }
        pos += 8 + sz + (sz & 1);
    }
    if (!pcm || bits != 16 || ch <= 0 || sr <= 0) return -1;
    int64_t n = pcm_len / 2;
    float* buf = (float*)std::malloc(sizeof(float) * (size_t)n);
    if (!buf) return -1;
    const float scale = 1.0f / 32767.0f;
    for (int64_t i = 0; i < n; ++i) {
        int16_t v = (int16_t)((uint16_t)pcm[2 * i]
                              | ((uint16_t)pcm[2 * i + 1] << 8));
        buf[i] = (float)v * scale;
    }
    *out = buf;
    *sample_rate = sr;
    *channels = ch;
    return n;
}

// ---------------------------------------------------------------------
// Streaming overlap-add core (reference IstftStream rolling buffers,
// src/stft.rs:453-519): push windowed time-domain frames, pop normalized
// hop chunks. Host-side companion for small-frame streaming where device
// round-trips dominate.
// ---------------------------------------------------------------------

struct KofftOla {
    int64_t win, hop;
    std::vector<float> window;
    std::vector<float> buf, norm;
    int64_t count;
};

void* kofft_ola_new(int64_t win, int64_t hop, const float* window) {
    if (win <= 0 || hop <= 0 || hop > win) return nullptr;
    KofftOla* s = new KofftOla;
    s->win = win; s->hop = hop; s->count = 0;
    s->window.assign(window, window + win);
    s->buf.assign((size_t)win, 0.0f);
    s->norm.assign((size_t)win, 0.0f);
    return s;
}

// time-domain frame (already inverse-transformed, length win) ->
// writes hop normalized samples into out.
void kofft_ola_push(void* st, const float* frame, float* out) {
    KofftOla* s = (KofftOla*)st;
    const int64_t win = s->win, hop = s->hop;
    for (int64_t i = 0; i < win; ++i) {
        const float w = s->window[(size_t)i];
        s->buf[(size_t)i] += frame[i] * w;
        s->norm[(size_t)i] += w * w;
    }
    for (int64_t i = 0; i < hop; ++i) {
        const float nrm = s->norm[(size_t)i];
        out[i] = nrm > 1e-8f ? s->buf[(size_t)i] / nrm : s->buf[(size_t)i];
    }
    std::memmove(s->buf.data(), s->buf.data() + hop,
                 sizeof(float) * (size_t)(win - hop));
    std::memmove(s->norm.data(), s->norm.data() + hop,
                 sizeof(float) * (size_t)(win - hop));
    std::memset(s->buf.data() + (win - hop), 0, sizeof(float) * (size_t)hop);
    std::memset(s->norm.data() + (win - hop), 0,
                sizeof(float) * (size_t)hop);
    s->count += 1;
}

// remaining win-hop tail -> out; returns count written.
int64_t kofft_ola_flush(void* st, float* out) {
    KofftOla* s = (KofftOla*)st;
    if (s->count == 0) return 0;
    const int64_t tail = s->win - s->hop;
    for (int64_t i = 0; i < tail; ++i) {
        const float nrm = s->norm[(size_t)i];
        out[i] = nrm > 1e-8f ? s->buf[(size_t)i] / nrm : s->buf[(size_t)i];
    }
    std::fill(s->buf.begin(), s->buf.end(), 0.0f);
    std::fill(s->norm.begin(), s->norm.end(), 0.0f);
    s->count = 0;
    return tail;
}

void kofft_ola_delete(void* st) { delete (KofftOla*)st; }

}  // extern "C"
