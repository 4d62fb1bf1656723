// Native TFRecord data-path kernels: hardware CRC32C + one-pass record
// scanning. The reference leans on TensorFlow's C++ runtime for TFRecord IO
// (slim DatasetDataProvider, SURVEY.md section 2.4); this is the framework's
// own native equivalent, exposed to Python via ctypes
// (twingan_tpu_torch/data/tfrecord.py). A copy of twingan_tpu/native/tfrecord.cc;
// twingan_tpu_torch/native/__init__.py builds it with png_unfilter.cc.
//
// TFRecord wire format (per record):
//   uint64 length (LE) | uint32 masked_crc32c(length) |
//   bytes payload[length] | uint32 masked_crc32c(payload)
// masked = ((crc >> 15) | (crc << 17)) + 0xa282ead8

#include <cstdint>
#include <cstdio>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#define TWIN_HW_CRC 1
#endif

namespace {

// Software fallback table (Castagnoli polynomial 0x82f63b78), generated at
// first use.
uint32_t g_table[256];
bool g_table_init = false;

void init_table() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    g_table[i] = c;
  }
  g_table_init = true;
}

uint32_t crc32c_sw(uint32_t crc, const uint8_t* data, size_t n) {
  if (!g_table_init) init_table();
  crc = ~crc;
  for (size_t i = 0; i < n; i++) crc = g_table[(crc ^ data[i]) & 0xff] ^ (crc >> 8);
  return ~crc;
}

#ifdef TWIN_HW_CRC
uint32_t crc32c_hw(uint32_t crc, const uint8_t* data, size_t n) {
  uint64_t c = ~crc;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, data, 8);
    c = _mm_crc32_u64(c, v);
    data += 8;
    n -= 8;
  }
  while (n > 0) {
    c = _mm_crc32_u8((uint32_t)c, *data++);
    n--;
  }
  return ~(uint32_t)c;
}
#endif

uint32_t crc32c(const uint8_t* data, size_t n) {
#ifdef TWIN_HW_CRC
  return crc32c_hw(0, data, n);
#else
  return crc32c_sw(0, data, n);
#endif
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

}  // namespace

extern "C" {

uint32_t twin_crc32c(const uint8_t* data, uint64_t n) { return crc32c(data, n); }

uint32_t twin_masked_crc32c(const uint8_t* data, uint64_t n) {
  return masked_crc(data, n);
}

// Scans a TFRecord file, filling payload offsets/lengths. Returns the number
// of records, or -(byte_position+1) on corruption. verify=0 skips CRC checks
// (header length-CRC is always checked as a framing sanity guard).
int64_t twin_scan_tfrecord(const char* path, int64_t* offsets, int64_t* lengths,
                           int64_t capacity, int verify) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // File size up front: fseek past EOF "succeeds", so the skip path needs
  // an explicit bound to reject records truncated mid-payload.
  fseek(f, 0, SEEK_END);
  int64_t file_size = ftell(f);
  fseek(f, 0, SEEK_SET);
  int64_t count = 0;
  uint8_t header[12];
  // Payload staging buffer for verification reads.
  size_t buf_cap = 1 << 20;
  uint8_t* buf = verify ? new uint8_t[buf_cap] : nullptr;
  int64_t pos = 0;
  int64_t result;
  for (;;) {
    size_t got = fread(header, 1, 12, f);
    if (got == 0) {
      result = count;
      break;
    }
    if (got != 12) {
      result = -(pos + 1);
      break;
    }
    uint64_t len;
    uint32_t len_crc;
    memcpy(&len, header, 8);
    memcpy(&len_crc, header + 8, 4);
    if (masked_crc(header, 8) != len_crc) {
      result = -(pos + 1);
      break;
    }
    int64_t payload_off = pos + 12;
    if (payload_off + (int64_t)len + 4 > file_size) {
      result = -(pos + 1);  // truncated: framing claims bytes past EOF
      break;
    }
    if (count < capacity) {
      offsets[count] = payload_off;
      lengths[count] = (int64_t)len;
    }
    if (verify) {
      if (len > buf_cap) {
        delete[] buf;
        buf_cap = len;
        buf = new uint8_t[buf_cap];
      }
      if (fread(buf, 1, len, f) != len) {
        result = -(pos + 1);
        break;
      }
      uint8_t footer[4];
      uint32_t data_crc;
      if (fread(footer, 1, 4, f) != 4) {
        result = -(pos + 1);
        break;
      }
      memcpy(&data_crc, footer, 4);
      if (masked_crc(buf, len) != data_crc) {
        result = -(pos + 1);
        break;
      }
    } else {
      if (fseek(f, (long)(len + 4), SEEK_CUR) != 0) {
        result = -(pos + 1);
        break;
      }
    }
    pos = payload_off + (int64_t)len + 4;
    count++;
  }
  if (buf) delete[] buf;
  fclose(f);
  return result;
}

}  // extern "C"
