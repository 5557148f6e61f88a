// AES-128 in CBC mode with PKCS7 padding, for the at-rest encryption of
// fire_tpu_torch.gallery.crypto (Fernet's cipher, built for the host CPU).
//
// Replaces what `cryptography`'s Fernet does with OpenSSL in the JAX
// package (fire_tpu/gallery/crypto.py); the key derivation, the HMAC and
// the base64 around it come from Python's standard library.  This runs on
// the host, not on the card: CBC encryption is one serial chain per token
// and the largest token, the gallery snapshot, is one 204 MB chain, so it
// is bound by the latency of one block cipher call after another.  Two
// implementations, chosen when the library is compiled (never at run
// time):
//   * AES-NI (`__AES__` defined, as `-march=native` does on an x86 CPU
//     that has it): one aesenc per round; decryption, which CBC lets run
//     in parallel, keeps four blocks in flight;
//   * 32-bit T-tables everywhere else, or when FIRE_AES_TTABLE is defined.
// fire_aes_backend() says which one was built.
//
// Build: c++ -O3 -shared -fPIC -march=native -std=c++17 -o libaes.so aes128_cbc.cpp

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__AES__) && !defined(FIRE_AES_TTABLE)
#define FIRE_AES_NI 1
#include <immintrin.h>
#else
#define FIRE_AES_NI 0
#endif

namespace {

const uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

inline uint8_t xtime(uint8_t x) { return static_cast<uint8_t>((x << 1) ^ ((x >> 7) * 0x1b)); }

inline uint8_t gmul(uint8_t a, uint8_t b) {
  uint8_t p = 0;
  for (int i = 0; i < 8; ++i) {
    if (b & 1) p ^= a;
    a = xtime(a);
    b >>= 1;
  }
  return p;
}

inline uint32_t ror8(uint32_t w) { return (w >> 8) | (w << 24); }

inline uint32_t load_be(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline void store_be(uint8_t* p, uint32_t w) {
  p[0] = uint8_t(w >> 24);
  p[1] = uint8_t(w >> 16);
  p[2] = uint8_t(w >> 8);
  p[3] = uint8_t(w);
}

// The S-boxes and the four encryption and decryption tables, built once
// from kSbox: Te0[x] = (2·S[x], S[x], S[x], 3·S[x]), Td0[x] = (e·Si[x],
// 9·Si[x], d·Si[x], b·Si[x]) as big-endian words; Te{1,2,3} and Td{1,2,3}
// are their byte rotations.
struct Tables {
  uint8_t inv[256];
  uint32_t te[4][256];
  uint32_t td[4][256];
  Tables() {
    for (int x = 0; x < 256; ++x) inv[kSbox[x]] = uint8_t(x);
    for (int x = 0; x < 256; ++x) {
      uint8_t s = kSbox[x], si = inv[x];
      uint32_t e = (uint32_t(xtime(s)) << 24) | (uint32_t(s) << 16) | (uint32_t(s) << 8) |
                   uint32_t(uint8_t(xtime(s) ^ s));
      uint32_t d = (uint32_t(gmul(si, 0x0e)) << 24) | (uint32_t(gmul(si, 0x09)) << 16) |
                   (uint32_t(gmul(si, 0x0d)) << 8) | uint32_t(gmul(si, 0x0b));
      for (int r = 0; r < 4; ++r) {
        te[r][x] = e;
        td[r][x] = d;
        e = ror8(e);
        d = ror8(d);
      }
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// FIPS-197 key expansion: 44 big-endian words, then the 11 round keys as
// bytes in the order the AES-NI instructions and the byte layout expect.
struct Schedule {
  uint32_t ek[44];  // encryption round keys
  uint32_t dk[44];  // decryption round keys of the equivalent inverse cipher
  uint8_t ek_bytes[176];
};

void expand(const uint8_t* key, Schedule* s) {
  const Tables& t = tables();
  static const uint8_t rcon[10] = {0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36};
  for (int i = 0; i < 4; ++i) s->ek[i] = load_be(key + 4 * i);
  for (int i = 4; i < 44; ++i) {
    uint32_t w = s->ek[i - 1];
    if (i % 4 == 0) {
      w = (w << 8) | (w >> 24);
      w = (uint32_t(kSbox[w >> 24]) << 24) | (uint32_t(kSbox[(w >> 16) & 0xff]) << 16) |
          (uint32_t(kSbox[(w >> 8) & 0xff]) << 8) | uint32_t(kSbox[w & 0xff]);
      w ^= uint32_t(rcon[i / 4 - 1]) << 24;
    }
    s->ek[i] = s->ek[i - 4] ^ w;
  }
  for (int i = 0; i < 44; ++i) store_be(s->ek_bytes + 4 * i, s->ek[i]);
  // reverse the rounds; InvMixColumns on every round key but the outer two
  for (int r = 0; r <= 10; ++r) {
    for (int c = 0; c < 4; ++c) {
      uint32_t w = s->ek[4 * (10 - r) + c];
      if (r > 0 && r < 10) {
        w = t.td[0][kSbox[w >> 24]] ^ t.td[1][kSbox[(w >> 16) & 0xff]] ^
            t.td[2][kSbox[(w >> 8) & 0xff]] ^ t.td[3][kSbox[w & 0xff]];
      }
      s->dk[4 * r + c] = w;
    }
  }
}

void encrypt_block_tt(const Schedule& k, const uint8_t* in, uint8_t* out) {
  const Tables& t = tables();
  const uint32_t* rk = k.ek;
  uint32_t s0 = load_be(in) ^ rk[0], s1 = load_be(in + 4) ^ rk[1];
  uint32_t s2 = load_be(in + 8) ^ rk[2], s3 = load_be(in + 12) ^ rk[3];
  for (int r = 1; r < 10; ++r) {
    rk += 4;
    uint32_t t0 = t.te[0][s0 >> 24] ^ t.te[1][(s1 >> 16) & 0xff] ^ t.te[2][(s2 >> 8) & 0xff] ^
                  t.te[3][s3 & 0xff] ^ rk[0];
    uint32_t t1 = t.te[0][s1 >> 24] ^ t.te[1][(s2 >> 16) & 0xff] ^ t.te[2][(s3 >> 8) & 0xff] ^
                  t.te[3][s0 & 0xff] ^ rk[1];
    uint32_t t2 = t.te[0][s2 >> 24] ^ t.te[1][(s3 >> 16) & 0xff] ^ t.te[2][(s0 >> 8) & 0xff] ^
                  t.te[3][s1 & 0xff] ^ rk[2];
    uint32_t t3 = t.te[0][s3 >> 24] ^ t.te[1][(s0 >> 16) & 0xff] ^ t.te[2][(s1 >> 8) & 0xff] ^
                  t.te[3][s2 & 0xff] ^ rk[3];
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
  }
  rk += 4;
  auto last = [&](uint32_t a, uint32_t b, uint32_t c, uint32_t d, uint32_t key) {
    return ((uint32_t(kSbox[a >> 24]) << 24) | (uint32_t(kSbox[(b >> 16) & 0xff]) << 16) |
            (uint32_t(kSbox[(c >> 8) & 0xff]) << 8) | uint32_t(kSbox[d & 0xff])) ^ key;
  };
  store_be(out, last(s0, s1, s2, s3, rk[0]));
  store_be(out + 4, last(s1, s2, s3, s0, rk[1]));
  store_be(out + 8, last(s2, s3, s0, s1, rk[2]));
  store_be(out + 12, last(s3, s0, s1, s2, rk[3]));
}

void decrypt_block_tt(const Schedule& k, const uint8_t* in, uint8_t* out) {
  const Tables& t = tables();
  const uint32_t* rk = k.dk;
  uint32_t s0 = load_be(in) ^ rk[0], s1 = load_be(in + 4) ^ rk[1];
  uint32_t s2 = load_be(in + 8) ^ rk[2], s3 = load_be(in + 12) ^ rk[3];
  for (int r = 1; r < 10; ++r) {
    rk += 4;
    uint32_t t0 = t.td[0][s0 >> 24] ^ t.td[1][(s3 >> 16) & 0xff] ^ t.td[2][(s2 >> 8) & 0xff] ^
                  t.td[3][s1 & 0xff] ^ rk[0];
    uint32_t t1 = t.td[0][s1 >> 24] ^ t.td[1][(s0 >> 16) & 0xff] ^ t.td[2][(s3 >> 8) & 0xff] ^
                  t.td[3][s2 & 0xff] ^ rk[1];
    uint32_t t2 = t.td[0][s2 >> 24] ^ t.td[1][(s1 >> 16) & 0xff] ^ t.td[2][(s0 >> 8) & 0xff] ^
                  t.td[3][s3 & 0xff] ^ rk[2];
    uint32_t t3 = t.td[0][s3 >> 24] ^ t.td[1][(s2 >> 16) & 0xff] ^ t.td[2][(s1 >> 8) & 0xff] ^
                  t.td[3][s0 & 0xff] ^ rk[3];
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
  }
  rk += 4;
  const uint8_t* si = t.inv;
  auto last = [&](uint32_t a, uint32_t b, uint32_t c, uint32_t d, uint32_t key) {
    return ((uint32_t(si[a >> 24]) << 24) | (uint32_t(si[(b >> 16) & 0xff]) << 16) |
            (uint32_t(si[(c >> 8) & 0xff]) << 8) | uint32_t(si[d & 0xff])) ^ key;
  };
  store_be(out, last(s0, s3, s2, s1, rk[0]));
  store_be(out + 4, last(s1, s0, s3, s2, rk[1]));
  store_be(out + 8, last(s2, s1, s0, s3, rk[2]));
  store_be(out + 12, last(s3, s2, s1, s0, rk[3]));
}

void cbc_encrypt(const Schedule& k, const uint8_t* iv, const uint8_t* in, size_t nblocks,
                 uint8_t* out) {
#if FIRE_AES_NI
  __m128i rk[11];
  for (int r = 0; r < 11; ++r)
    rk[r] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(k.ek_bytes + 16 * r));
  __m128i chain = _mm_loadu_si128(reinterpret_cast<const __m128i*>(iv));
  for (size_t b = 0; b < nblocks; ++b) {
    __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 16 * b));
    x = _mm_xor_si128(_mm_xor_si128(x, chain), rk[0]);
    for (int r = 1; r < 10; ++r) x = _mm_aesenc_si128(x, rk[r]);
    chain = _mm_aesenclast_si128(x, rk[10]);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * b), chain);
  }
#else
  uint8_t chain[16], x[16];
  std::memcpy(chain, iv, 16);
  for (size_t b = 0; b < nblocks; ++b) {
    for (int i = 0; i < 16; ++i) x[i] = in[16 * b + i] ^ chain[i];
    encrypt_block_tt(k, x, out + 16 * b);
    std::memcpy(chain, out + 16 * b, 16);
  }
#endif
}

void cbc_decrypt(const Schedule& k, const uint8_t* iv, const uint8_t* in, size_t nblocks,
                 uint8_t* out) {
#if FIRE_AES_NI
  __m128i rk[11];
  rk[0] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(k.ek_bytes + 160));
  for (int r = 1; r < 10; ++r)
    rk[r] = _mm_aesimc_si128(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(k.ek_bytes + 16 * (10 - r))));
  rk[10] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(k.ek_bytes));
  __m128i prev = _mm_loadu_si128(reinterpret_cast<const __m128i*>(iv));
  size_t b = 0;
  for (; b + 4 <= nblocks; b += 4) {  // four independent blocks in flight
    __m128i c[4], x[4];
    for (int j = 0; j < 4; ++j) {
      c[j] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 16 * (b + j)));
      x[j] = _mm_xor_si128(c[j], rk[0]);
    }
    for (int r = 1; r < 10; ++r)
      for (int j = 0; j < 4; ++j) x[j] = _mm_aesdec_si128(x[j], rk[r]);
    for (int j = 0; j < 4; ++j) {
      x[j] = _mm_aesdeclast_si128(x[j], rk[10]);
      x[j] = _mm_xor_si128(x[j], j == 0 ? prev : c[j - 1]);
      _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * (b + j)), x[j]);
    }
    prev = c[3];
  }
  for (; b < nblocks; ++b) {
    __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 16 * b));
    __m128i x = _mm_xor_si128(c, rk[0]);
    for (int r = 1; r < 10; ++r) x = _mm_aesdec_si128(x, rk[r]);
    x = _mm_xor_si128(_mm_aesdeclast_si128(x, rk[10]), prev);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * b), x);
    prev = c;
  }
#else
  uint8_t prev[16], x[16];
  std::memcpy(prev, iv, 16);
  for (size_t b = 0; b < nblocks; ++b) {
    decrypt_block_tt(k, in + 16 * b, x);
    for (int i = 0; i < 16; ++i) {
      uint8_t c = in[16 * b + i];
      out[16 * b + i] = x[i] ^ prev[i];
      prev[i] = c;
    }
  }
#endif
}

}  // namespace

extern "C" {

// 1 when this library was built with AES-NI, 0 for the T-tables.
int fire_aes_backend() { return FIRE_AES_NI; }

// Encrypt n bytes.  With pkcs7 != 0 the PKCS7 pad is added and the output
// holds (n / 16 + 1) * 16 bytes; without, n must be a multiple of 16.
// Returns the bytes written, or -1 on a bad length.
long long fire_aes128_cbc_encrypt(const uint8_t* key, const uint8_t* iv, const uint8_t* in,
                                  long long n, int pkcs7, uint8_t* out) {
  if (n < 0 || (!pkcs7 && n % 16 != 0)) return -1;
  Schedule k;
  expand(key, &k);
  size_t full = size_t(n) / 16;
  cbc_encrypt(k, iv, in, full, out);
  if (!pkcs7) return n;
  uint8_t last[16];
  size_t rest = size_t(n) - 16 * full;
  std::memcpy(last, in + 16 * full, rest);
  std::memset(last + rest, int(16 - rest), 16 - rest);
  const uint8_t* chain = full ? out + 16 * (full - 1) : iv;
  cbc_encrypt(k, chain, last, 1, out + 16 * full);
  return (long long)(16 * (full + 1));
}

// Decrypt n bytes (a positive multiple of 16).  With pkcs7 != 0 the pad is
// checked and not counted.  Returns the plaintext's length, -1 on a bad
// length, -2 on a bad pad.
long long fire_aes128_cbc_decrypt(const uint8_t* key, const uint8_t* iv, const uint8_t* in,
                                  long long n, int pkcs7, uint8_t* out) {
  if (n <= 0 || n % 16 != 0) return -1;
  Schedule k;
  expand(key, &k);
  cbc_decrypt(k, iv, in, size_t(n) / 16, out);
  if (!pkcs7) return n;
  uint8_t pad = out[n - 1];
  if (pad == 0 || pad > 16) return -2;
  for (int i = 1; i <= pad; ++i)
    if (out[n - i] != pad) return -2;
  return n - pad;
}

}  // extern "C"
