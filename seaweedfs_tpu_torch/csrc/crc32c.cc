// CRC32-C (Castagnoli, reflected polynomial 0x82F63B78): the needle
// checksum of every volume write and read.
//
// Built with the host C++ compiler into seaweedfs_tpu_torch/build/ at
// first use (storage/crc.py) and called through ctypes. Two paths give
// the same value:
//   * crc32c_sw: slicing-by-8, eight 256-entry tables, 8 bytes a step;
//   * crc32c_hw: the SSE4.2 crc32 instruction, 8 bytes a step, taken by
//     crc32c when the CPU reports SSE4.2 (x86-64 only).
// Each takes the running CRC of the bytes before (0 for none) and
// returns the CRC of those bytes followed by data[0, n), so a payload may
// be checksummed in pieces.

#include <cstdint>
#include <cstring>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = t[0][i];
      for (int s = 1; s < 8; s++) {
        c = t[0][c & 0xFF] ^ (c >> 8);
        t[s][i] = c;
      }
    }
  }
};

const Tables g_tables;

uint32_t crc_sw(uint32_t crc, const uint8_t* data, long long n) {
  const auto& t = g_tables.t;
  crc = ~crc;
  long long i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo;
    std::memcpy(&lo, data + i, 4);  // little-endian host
    crc ^= lo;
    crc = t[7][crc & 0xFF] ^ t[6][(crc >> 8) & 0xFF] ^
          t[5][(crc >> 16) & 0xFF] ^ t[4][crc >> 24] ^ t[3][data[i + 4]] ^
          t[2][data[i + 5]] ^ t[1][data[i + 6]] ^ t[0][data[i + 7]];
  }
  for (; i < n; i++) crc = t[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc_hw(uint32_t crc,
                                                   const uint8_t* data,
                                                   long long n) {
  uint64_t c = ~crc;
  long long i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t word;
    std::memcpy(&word, data + i, 8);
    c = __builtin_ia32_crc32di(c, word);
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  for (; i < n; i++) c32 = __builtin_ia32_crc32qi(c32, data[i]);
  return ~c32;
}

bool have_hw() {
  __builtin_cpu_init();
  return __builtin_cpu_supports("sse4.2");
}

const bool g_hw = have_hw();
#endif

}  // namespace

extern "C" {

uint32_t crc32c_sw(uint32_t crc, const uint8_t* data, long long n) {
  return crc_sw(crc, data, n);
}

// 1 when crc32c runs the SSE4.2 instruction, 0 when it runs crc32c_sw.
int crc32c_hw_path() {
#if defined(__x86_64__)
  return g_hw ? 1 : 0;
#else
  return 0;
#endif
}

uint32_t crc32c(uint32_t crc, const uint8_t* data, long long n) {
#if defined(__x86_64__)
  if (g_hw) return crc_hw(crc, data, n);
#endif
  return crc_sw(crc, data, n);
}

}  // extern "C"
