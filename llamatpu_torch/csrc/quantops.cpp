// The port's native GGUF codecs (a copy of native/quantops.cpp, so the port
// links nothing outside its package): GGML block dequantization, the ggml
// Q8_0 encode and depacking into (int8 values, f32 scales) arrays, on the
// host CPU with OpenMP. The same values as the numpy codecs of
// llamatpu_torch/gguf/quants.py, bit for bit (tests/test_torch_native.py).
//
// Built by llamatpu_torch/gguf/native.py with the host C++ compiler into
// build/native/ at first use (-ffp-contract=off: no product is fused into a
// following add), loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <cmath>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {  // subnormal
            exp = 127 - 15 + 1;
            while (!(mant & 0x400u)) { mant <<= 1; --exp; }
            mant &= 0x3FFu;
            bits = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 0x1Fu) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &bits, sizeof f);
    return f;
}

inline uint16_t f32_to_f16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, sizeof bits);
    uint32_t sign = (bits >> 16) & 0x8000u;
    int32_t exp = (int32_t)((bits >> 23) & 0xFFu) - 127 + 15;
    uint32_t mant = bits & 0x7FFFFFu;
    if (exp >= 0x1F) return (uint16_t)(sign | 0x7C00u);          // inf/overflow
    if (exp <= 0) {                                               // subnormal/0
        if (exp < -10) return (uint16_t)sign;
        mant |= 0x800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t half = (mant >> shift);
        // round to nearest even
        uint32_t rem = mant & ((1u << shift) - 1);
        uint32_t mid = 1u << (shift - 1);
        if (rem > mid || (rem == mid && (half & 1))) half++;
        return (uint16_t)(sign | half);
    }
    uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
    uint32_t rem = mant & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
    return (uint16_t)(sign | half);
}

}  // namespace

extern "C" {

// ---- Q8_0: 34-byte blocks (f16 scale + 32 int8) ---------------------------

void dequant_q8_0(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* blk = raw + b * 34;
        uint16_t h; std::memcpy(&h, blk, 2);
        float d = f16_to_f32(h);
        const int8_t* q = (const int8_t*)(blk + 2);
        float* o = out + b * 32;
        for (int i = 0; i < 32; ++i) o[i] = d * (float)q[i];
    }
}

void depack_q8_0(const uint8_t* raw, int64_t nblocks, int8_t* qs, float* scales) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* blk = raw + b * 34;
        uint16_t h; std::memcpy(&h, blk, 2);
        scales[b] = f16_to_f32(h);
        std::memcpy(qs + b * 32, blk + 2, 32);
    }
}

// ggml-order Q8_0 quantization: int8 from full-precision scale, f16-stored
// scale, round half away from zero (Q8_0FloatTensor.dotQ8Activation parity).
void quantize_q8_0(const float* in, int64_t nblocks, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const float* x = in + b * 32;
        float amax = 0.f;
        for (int i = 0; i < 32; ++i) { float a = std::fabs(x[i]); if (a > amax) amax = a; }
        float d = amax / 127.0f;
        float inv = d != 0.f ? 1.0f / d : 0.f;
        uint8_t* blk = out + b * 34;
        uint16_t h = f32_to_f16(d);
        std::memcpy(blk, &h, 2);
        int8_t* q = (int8_t*)(blk + 2);
        for (int i = 0; i < 32; ++i) {
            float s = x[i] * inv;
            q[i] = (int8_t)(s + std::copysign(0.5f, s));  // trunc toward zero after +/-0.5
        }
    }
}

// ---- Q4_0: 18-byte blocks (f16 scale + 16 nibble bytes) -------------------

void dequant_q4_0(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* blk = raw + b * 18;
        uint16_t h; std::memcpy(&h, blk, 2);
        float d = f16_to_f32(h);
        float* o = out + b * 32;
        for (int i = 0; i < 16; ++i) {
            uint8_t byte = blk[2 + i];
            o[i] = d * (float)((int)(byte & 0x0F) - 8);
            o[i + 16] = d * (float)((int)(byte >> 4) - 8);
        }
    }
}

void depack_q4_0(const uint8_t* raw, int64_t nblocks, int8_t* qs, float* scales) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* blk = raw + b * 18;
        uint16_t h; std::memcpy(&h, blk, 2);
        scales[b] = f16_to_f32(h);
        int8_t* q = qs + b * 32;
        for (int i = 0; i < 16; ++i) {
            uint8_t byte = blk[2 + i];
            q[i] = (int8_t)((byte & 0x0F) - 8);
            q[i + 16] = (int8_t)((byte >> 4) - 8);
        }
    }
}

// ---- K-quants: 256-element super-blocks -----------------------------------

static inline void k4_scale_min(const uint8_t* sc, int j, int* s, int* m) {
    if (j < 4) {
        *s = sc[j] & 63;
        *m = sc[j + 4] & 63;
    } else {
        *s = (sc[j + 4] & 0x0F) | ((sc[j - 4] >> 6) << 4);
        *m = (sc[j + 4] >> 4) | ((sc[j] >> 6) << 4);
    }
}

void dequant_q4_k(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* blk = raw + b * 144;
        uint16_t hd, hm;
        std::memcpy(&hd, blk, 2); std::memcpy(&hm, blk + 2, 2);
        float d = f16_to_f32(hd), dmin = f16_to_f32(hm);
        const uint8_t* sc = blk + 4;
        const uint8_t* qs = blk + 16;
        float* o = out + b * 256;
        for (int pair = 0; pair < 4; ++pair) {
            int s0, m0, s1, m1;
            k4_scale_min(sc, pair * 2, &s0, &m0);
            k4_scale_min(sc, pair * 2 + 1, &s1, &m1);
            const uint8_t* q = qs + pair * 32;
            float* lo = o + pair * 64;
            float* hi = lo + 32;
            for (int i = 0; i < 32; ++i) {
                lo[i] = d * s0 * (float)(q[i] & 0x0F) - dmin * m0;
                hi[i] = d * s1 * (float)(q[i] >> 4) - dmin * m1;
            }
        }
    }
}

void dequant_q5_k(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* blk = raw + b * 176;
        uint16_t hd, hm;
        std::memcpy(&hd, blk, 2); std::memcpy(&hm, blk + 2, 2);
        float d = f16_to_f32(hd), dmin = f16_to_f32(hm);
        const uint8_t* sc = blk + 4;
        const uint8_t* qh = blk + 16;
        const uint8_t* qs = blk + 48;
        float* o = out + b * 256;
        for (int pair = 0; pair < 4; ++pair) {
            int s0, m0, s1, m1;
            k4_scale_min(sc, pair * 2, &s0, &m0);
            k4_scale_min(sc, pair * 2 + 1, &s1, &m1);
            const uint8_t* q = qs + pair * 32;
            float* lo = o + pair * 64;
            float* hi = lo + 32;
            for (int i = 0; i < 32; ++i) {
                int l = (q[i] & 0x0F) | (((qh[i] >> (pair * 2)) & 1) << 4);
                int hgh = (q[i] >> 4) | (((qh[i] >> (pair * 2 + 1)) & 1) << 4);
                lo[i] = d * s0 * (float)l - dmin * m0;
                hi[i] = d * s1 * (float)hgh - dmin * m1;
            }
        }
    }
}

void dequant_q6_k(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* blk = raw + b * 210;
        const uint8_t* ql0 = blk;
        const uint8_t* qh0 = blk + 128;
        const int8_t* sc = (const int8_t*)(blk + 192);
        uint16_t hd; std::memcpy(&hd, blk + 208, 2);
        float d = f16_to_f32(hd);
        float* o = out + b * 256;
        for (int half = 0; half < 2; ++half) {
            const uint8_t* ql = ql0 + half * 64;
            const uint8_t* qh = qh0 + half * 32;
            const int8_t* s = sc + half * 8;
            float* oo = o + half * 128;
            for (int g = 0; g < 32; ++g) {
                int is = g / 16;
                int q0 = ((ql[g] & 0x0F) | (((qh[g] >> 0) & 3) << 4)) - 32;
                int q1 = ((ql[32 + g] & 0x0F) | (((qh[g] >> 2) & 3) << 4)) - 32;
                int q2 = ((ql[g] >> 4) | (((qh[g] >> 4) & 3) << 4)) - 32;
                int q3 = ((ql[32 + g] >> 4) | (((qh[g] >> 6) & 3) << 4)) - 32;
                oo[g] = d * (float)s[is] * (float)q0;
                oo[32 + g] = d * (float)s[is + 2] * (float)q1;
                oo[64 + g] = d * (float)s[is + 4] * (float)q2;
                oo[96 + g] = d * (float)s[is + 6] * (float)q3;
            }
        }
    }
}

int quantops_version() { return 1; }

}  // extern "C"
