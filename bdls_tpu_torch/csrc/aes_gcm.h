// AES-256-GCM on the host (NIST SP 800-38D), with AES-NI and PCLMULQDQ.
//
// The cluster mesh seals every frame after its handshake with
// AES-256-GCM (bdls_tpu_torch/comm/cluster.py:SecureChannel); the card's
// machine has no OpenSSL binding for Python, and a Python AES cannot
// carry frames of megabytes. This is host code, built with g++ by
// ops/_build.py:host_shim and bound with ctypes (comm/aead.py): 96-bit
// nonces, 16-byte tags appended to the ciphertext, as the
// `cryptography` package's AESGCM takes and gives them.
//
// - AES-256: the key schedule by AESKEYGENASSIST, four counter blocks
//   through AESENC side by side.
// - GHASH: a block at a time, in the byte-reflected domain of Gueron
//   and Kounavis ("Intel Carry-Less Multiplication Instruction and its
//   Usage for Computing the GCM Mode", rev. 2.02, algorithm 5): four
//   PCLMULQDQ products, a shift by one, a reduction modulo
//   x^128 + x^7 + x^2 + x + 1.
// - open() checks the tag, in constant time, before it writes any
//   plaintext.
//
// Callers check bdls_aes_gcm_supported() first: without the two
// instruction sets the library must not be used.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <immintrin.h>

namespace bdls_aes {

struct alignas(16) Ctx {
    __m128i rk[15];  // AES-256 round keys
    __m128i h;       // E_K(0^128), byte-reflected
};

static inline __m128i bswap(__m128i x) {
    const __m128i m = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                   12, 13, 14, 15);
    return _mm_shuffle_epi8(x, m);
}

static inline void assist_1(__m128i* t1, __m128i t2) {
    t2 = _mm_shuffle_epi32(t2, 0xff);
    __m128i t4 = _mm_slli_si128(*t1, 4);
    *t1 = _mm_xor_si128(*t1, t4);
    t4 = _mm_slli_si128(t4, 4);
    *t1 = _mm_xor_si128(*t1, t4);
    t4 = _mm_slli_si128(t4, 4);
    *t1 = _mm_xor_si128(*t1, t4);
    *t1 = _mm_xor_si128(*t1, t2);
}

static inline void assist_2(__m128i t1, __m128i* t3) {
    __m128i t2 = _mm_shuffle_epi32(_mm_aeskeygenassist_si128(t1, 0x0), 0xaa);
    __m128i t4 = _mm_slli_si128(*t3, 4);
    *t3 = _mm_xor_si128(*t3, t4);
    t4 = _mm_slli_si128(t4, 4);
    *t3 = _mm_xor_si128(*t3, t4);
    t4 = _mm_slli_si128(t4, 4);
    *t3 = _mm_xor_si128(*t3, t4);
    *t3 = _mm_xor_si128(*t3, t2);
}

#define BDLS_AES_ROUND_PAIR(i, rcon)                                    \
    assist_1(&t1, _mm_aeskeygenassist_si128(t3, rcon));                 \
    c->rk[i] = t1;                                                      \
    assist_2(t1, &t3);                                                  \
    c->rk[i + 1] = t3;

static inline __m128i encrypt_block(const Ctx* c, __m128i x) {
    x = _mm_xor_si128(x, c->rk[0]);
    for (int i = 1; i < 14; ++i) x = _mm_aesenc_si128(x, c->rk[i]);
    return _mm_aesenclast_si128(x, c->rk[14]);
}

static inline void init(Ctx* c, const uint8_t key[32]) {
    __m128i t1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(key));
    __m128i t3 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(key + 16));
    c->rk[0] = t1;
    c->rk[1] = t3;
    BDLS_AES_ROUND_PAIR(2, 0x01)
    BDLS_AES_ROUND_PAIR(4, 0x02)
    BDLS_AES_ROUND_PAIR(6, 0x04)
    BDLS_AES_ROUND_PAIR(8, 0x08)
    BDLS_AES_ROUND_PAIR(10, 0x10)
    BDLS_AES_ROUND_PAIR(12, 0x20)
    assist_1(&t1, _mm_aeskeygenassist_si128(t3, 0x40));
    c->rk[14] = t1;
    c->h = bswap(encrypt_block(c, _mm_setzero_si128()));
}

#undef BDLS_AES_ROUND_PAIR

// a·b in GF(2^128), both byte-reflected
static inline __m128i gfmul(__m128i a, __m128i b) {
    __m128i t3 = _mm_clmulepi64_si128(a, b, 0x00);
    __m128i t4 = _mm_clmulepi64_si128(a, b, 0x10);
    __m128i t5 = _mm_clmulepi64_si128(a, b, 0x01);
    __m128i t6 = _mm_clmulepi64_si128(a, b, 0x11);
    t4 = _mm_xor_si128(t4, t5);
    t5 = _mm_slli_si128(t4, 8);
    t4 = _mm_srli_si128(t4, 8);
    t3 = _mm_xor_si128(t3, t5);
    t6 = _mm_xor_si128(t6, t4);
    // the 256-bit product shifted left by one
    __m128i t7 = _mm_srli_epi32(t3, 31);
    __m128i t8 = _mm_srli_epi32(t6, 31);
    t3 = _mm_slli_epi32(t3, 1);
    t6 = _mm_slli_epi32(t6, 1);
    __m128i t9 = _mm_srli_si128(t7, 12);
    t8 = _mm_slli_si128(t8, 4);
    t7 = _mm_slli_si128(t7, 4);
    t3 = _mm_or_si128(t3, t7);
    t6 = _mm_or_si128(t6, t8);
    t6 = _mm_or_si128(t6, t9);
    // reduction
    t7 = _mm_slli_epi32(t3, 31);
    t8 = _mm_slli_epi32(t3, 30);
    t9 = _mm_slli_epi32(t3, 25);
    t7 = _mm_xor_si128(t7, t8);
    t7 = _mm_xor_si128(t7, t9);
    t8 = _mm_srli_si128(t7, 4);
    t7 = _mm_slli_si128(t7, 12);
    t3 = _mm_xor_si128(t3, t7);
    __m128i t2 = _mm_srli_epi32(t3, 1);
    t4 = _mm_srli_epi32(t3, 2);
    t5 = _mm_srli_epi32(t3, 7);
    t2 = _mm_xor_si128(t2, t4);
    t2 = _mm_xor_si128(t2, t5);
    t2 = _mm_xor_si128(t2, t8);
    t3 = _mm_xor_si128(t3, t2);
    return _mm_xor_si128(t6, t3);
}

static inline __m128i load_partial(const uint8_t* p, size_t n) {
    alignas(16) uint8_t buf[16] = {0};
    std::memcpy(buf, p, n);
    return _mm_load_si128(reinterpret_cast<const __m128i*>(buf));
}

// y <- GHASH_H(y, p[0..n)), the last block zero-padded
static inline __m128i ghash(const Ctx* c, __m128i y, const uint8_t* p,
                            size_t n) {
    size_t i = 0;
    for (; i + 16 <= n; i += 16) {
        __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + i));
        y = gfmul(_mm_xor_si128(y, bswap(x)), c->h);
    }
    if (i < n)
        y = gfmul(_mm_xor_si128(y, bswap(load_partial(p + i, n - i))), c->h);
    return y;
}

static inline __m128i counter_block(const uint8_t iv[12], uint32_t ctr) {
    alignas(16) uint8_t b[16];
    std::memcpy(b, iv, 12);
    b[12] = uint8_t(ctr >> 24);
    b[13] = uint8_t(ctr >> 16);
    b[14] = uint8_t(ctr >> 8);
    b[15] = uint8_t(ctr);
    return _mm_load_si128(reinterpret_cast<const __m128i*>(b));
}

// out[0..n) = in[0..n) xor the key stream from counter 2 (inc32)
static inline void ctr_xor(const Ctx* c, const uint8_t iv[12],
                           const uint8_t* in, uint8_t* out, size_t n) {
    uint32_t ctr = 2;
    size_t i = 0;
    for (; i + 64 <= n; i += 64, ctr += 4) {
        __m128i k0 = _mm_xor_si128(counter_block(iv, ctr), c->rk[0]);
        __m128i k1 = _mm_xor_si128(counter_block(iv, ctr + 1), c->rk[0]);
        __m128i k2 = _mm_xor_si128(counter_block(iv, ctr + 2), c->rk[0]);
        __m128i k3 = _mm_xor_si128(counter_block(iv, ctr + 3), c->rk[0]);
        for (int r = 1; r < 14; ++r) {
            k0 = _mm_aesenc_si128(k0, c->rk[r]);
            k1 = _mm_aesenc_si128(k1, c->rk[r]);
            k2 = _mm_aesenc_si128(k2, c->rk[r]);
            k3 = _mm_aesenc_si128(k3, c->rk[r]);
        }
        k0 = _mm_aesenclast_si128(k0, c->rk[14]);
        k1 = _mm_aesenclast_si128(k1, c->rk[14]);
        k2 = _mm_aesenclast_si128(k2, c->rk[14]);
        k3 = _mm_aesenclast_si128(k3, c->rk[14]);
        const __m128i* src = reinterpret_cast<const __m128i*>(in + i);
        __m128i* dst = reinterpret_cast<__m128i*>(out + i);
        _mm_storeu_si128(dst, _mm_xor_si128(_mm_loadu_si128(src), k0));
        _mm_storeu_si128(dst + 1, _mm_xor_si128(_mm_loadu_si128(src + 1), k1));
        _mm_storeu_si128(dst + 2, _mm_xor_si128(_mm_loadu_si128(src + 2), k2));
        _mm_storeu_si128(dst + 3, _mm_xor_si128(_mm_loadu_si128(src + 3), k3));
    }
    for (; i < n; i += 16, ++ctr) {
        alignas(16) uint8_t ks[16];
        _mm_store_si128(reinterpret_cast<__m128i*>(ks),
                        encrypt_block(c, counter_block(iv, ctr)));
        size_t m = n - i < 16 ? n - i : 16;
        for (size_t j = 0; j < m; ++j) out[i + j] = in[i + j] ^ ks[j];
    }
}

// the tag over aad and the ciphertext ct[0..n)
static inline void tag(const Ctx* c, const uint8_t iv[12], const uint8_t* aad,
                       size_t aad_len, const uint8_t* ct, size_t n,
                       uint8_t out[16]) {
    __m128i y = ghash(c, _mm_setzero_si128(), aad, aad_len);
    y = ghash(c, y, ct, n);
    alignas(16) uint8_t lens[16];
    uint64_t abits = uint64_t(aad_len) * 8, cbits = uint64_t(n) * 8;
    for (int j = 0; j < 8; ++j) {
        lens[j] = uint8_t(abits >> (56 - 8 * j));
        lens[8 + j] = uint8_t(cbits >> (56 - 8 * j));
    }
    y = gfmul(_mm_xor_si128(
                  y, bswap(_mm_load_si128(reinterpret_cast<__m128i*>(lens)))),
              c->h);
    __m128i t = _mm_xor_si128(bswap(y), encrypt_block(c, counter_block(iv, 1)));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out), t);
}

}  // namespace bdls_aes
