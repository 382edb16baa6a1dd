// Native sample-format conversion for the host feed path.
//
// SDR/file sources deliver wire formats (u8 offset-binary, i16 LE, interleaved
// IQ) that must become f32/c64 before device upload. Python/NumPy does this with
// multiple temporaries; these kernels convert in one SIMD pass (g++
// auto-vectorizes the loops) writing straight into the feed ring / pinned
// buffer. ≈ the role of the reference's vir-simd converter blocks
// (blocks/basic ConverterBlocks.hpp) on the host side of this build.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++20 convert.cpp -o libgr4convert.so

#include <cstddef>
#include <cstdint>

extern "C" {

// int16 LE → float32, y = x * scale
void gr4_i16_to_f32(const std::int16_t* x, float* y, std::size_t n, float scale) {
    for (std::size_t i = 0; i < n; ++i) y[i] = (float)x[i] * scale;
}

// uint8 offset-binary (RTL-SDR style) → float32 in ~[-1, 1)
void gr4_u8_to_f32(const std::uint8_t* x, float* y, std::size_t n, float scale) {
    for (std::size_t i = 0; i < n; ++i) y[i] = ((float)x[i] - 127.5f) * scale;
}

// interleaved int16 I/Q → complex64 (float32 pairs), n = complex samples
void gr4_i16iq_to_c64(const std::int16_t* x, float* y, std::size_t n,
                      float scale) {
    for (std::size_t i = 0; i < 2 * n; ++i) y[i] = (float)x[i] * scale;
}

// interleaved uint8 I/Q (offset binary) → complex64
void gr4_u8iq_to_c64(const std::uint8_t* x, float* y, std::size_t n,
                     float scale) {
    for (std::size_t i = 0; i < 2 * n; ++i)
        y[i] = ((float)x[i] - 127.5f) * scale;
}

// float32 → int16 LE with clipping, y = clip(x * scale)
void gr4_f32_to_i16(const float* x, std::int16_t* y, std::size_t n,
                    float scale) {
    for (std::size_t i = 0; i < n; ++i) {
        float v = x[i] * scale;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        y[i] = (std::int16_t)(v >= 0.0f ? v + 0.5f : v - 0.5f);
    }
}

// deinterleave [I Q I Q …] f32 → planar I[], Q[]
void gr4_deinterleave_f32(const float* x, float* i_out, float* q_out,
                          std::size_t n) {
    for (std::size_t k = 0; k < n; ++k) {
        i_out[k] = x[2 * k];
        q_out[k] = x[2 * k + 1];
    }
}

} // extern "C"
