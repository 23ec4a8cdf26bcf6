// Shared helpers for the jampack-jax native host engine.
//
// Format-mandated semantics (varints, checksum, token codec, model updates)
// follow the Jampack v0.80 stream contract; see SURVEY.md and the cited
// reference lines in each function.  All code here is written fresh for this
// framework.
#pragma once

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <type_traits>

namespace jpt {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using i32 = int32_t;
using i64 = int64_t;

constexpr u32 kGoldenPrime = 0x9E3779B1u;
constexpr int kProbBits = 16;
constexpr int kProbScale = 1 << kProbBits;
constexpr u32 kRansL = 1u << 23;
constexpr int kBwtUnits = 120;
constexpr int kAnsChunk = 1 << 20;
constexpr int kFilterChunk = 64 << 10;
constexpr int kMaxWidth = 32;

// ---- LEB128-with-carry varint (utils.cpp:22-90 semantics) ----
constexpr i32 kVarBase[4] = {
    0xFF >> 1,
    (0xFFFF >> 2) + (0xFF >> 1),
    (0xFFFFFF >> 3) + (0xFFFF >> 2) + (0xFF >> 1),
    i32((0xFFFFFFFFu >> 4) + (0xFFFFFF >> 3) + (0xFFFF >> 2) + (0xFF >> 1)),
};

inline int var_size(i32 val) {
  for (int i = 0; i < 4; i++)
    if (val < kVarBase[i]) return i + 1;
  return 5;
}

inline int var_encode(i32 val, u8* buf) {
  int n = var_size(val);
  if (n > 1) val -= kVarBase[n - 2];
  for (int k = 0; k < n - 1; k++) buf[k] = (val >> (7 * (n - 1 - k))) & 0x7F;
  buf[n - 1] = (val & 0x7F) | 0x80;
  return n;
}

inline int var_decode(const u8* buf, i32* out) {
  // legal encodings are <= 5 bytes; cap the scan so corrupt input can
  // neither read unboundedly past the buffer nor index past kVarBase
  int d = 0;
  u32 val = 0;
  while (d < 4 && (buf[d] & 0x80) == 0) {
    val = (val << 7) | buf[d];
    d++;
  }
  if ((buf[d] & 0x80) == 0) {  // 5th byte missing its terminator: corrupt
    *out = -1;
    return 5;
  }
  val = (val << 7) | (buf[d] & 0x7F);
  if (d > 0) val += u32(kVarBase[d - 1]);
  *out = i32(val);
  return d + 1;
}

// Bounded decode for untrusted streams: returns bytes consumed, or -1 if
// the varint would run past `rem` remaining bytes or is malformed.
inline int var_decode_n(const u8* buf, i64 rem, i32* out) {
  if (rem <= 0) return -1;
  int d = 0;
  u32 val = 0;
  while (d < 4 && d < rem && (buf[d] & 0x80) == 0) {
    val = (val << 7) | buf[d];
    d++;
  }
  if (d >= rem || (buf[d] & 0x80) == 0) return -1;
  val = (val << 7) | (buf[d] & 0x7F);
  if (d > 0) val += u32(kVarBase[d - 1]);
  *out = i32(val);
  return d + 1;
}

// ---- block checksum (checksum.cpp:12-36 semantics) ----
inline u32 load32_be(const u8* p) {
  return (u32(p[0]) << 24) | (u32(p[1]) << 16) | (u32(p[2]) << 8) | u32(p[3]);
}

inline u32 block_checksum(const u8* p, i64 size) {
  u32 s[4] = {3u, 0u, 0u, 0u};
  i64 j = 0;
  while ((j + 16) < size) {
    s[0] ^= (load32_be(p + j + 0) + (1u << (s[0] & 7))) * kGoldenPrime;
    s[1] ^= (load32_be(p + j + 4) + (1u << (s[1] & 7))) * kGoldenPrime;
    s[2] ^= (load32_be(p + j + 8) + (1u << (s[2] & 7))) * kGoldenPrime;
    s[3] ^= (load32_be(p + j + 12) + (1u << (s[3] & 7))) * kGoldenPrime;
    j += 16;
  }
  while (j < size) {
    s[0] ^= (u32(p[j]) + (1u << (s[0] & 7))) * kGoldenPrime;
    j++;
  }
  return s[0] ^ s[1] ^ s[2] ^ s[3];
}

}  // namespace jpt
