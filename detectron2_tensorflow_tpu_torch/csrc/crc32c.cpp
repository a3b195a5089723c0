// Castagnoli CRC-32 (polynomial 0x82F63B78, reflected) of a byte buffer: the
// checksum of TFRecord framing (data/tfrecord_codec.py). A host library, not
// a CUDA kernel: g++ builds it at first use (kernels.load_host). One table
// lookup per byte; data/tfrecord_codec.py keeps the same loop in Python as
// the plain version it is tested against.
#include <cstdint>

namespace {

struct Table {
  uint32_t v[256];
  Table() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? 0x82F63B78u : 0u);
      v[n] = c;
    }
  }
};

const Table kTable;

}  // namespace

extern "C" uint32_t crc32c(const uint8_t* data, long len) {
  uint32_t crc = 0xFFFFFFFFu;
  for (long i = 0; i < len; ++i) crc = (crc >> 8) ^ kTable.v[(crc ^ data[i]) & 0xFFu];
  return crc ^ 0xFFFFFFFFu;
}
