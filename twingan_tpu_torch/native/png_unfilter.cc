// PNG row unfiltering: the inverse of the five filter types of the PNG
// specification (ISO/IEC 15948, section 9.2), exposed to Python via ctypes
// (twingan_tpu_torch/data/png.py holds the numpy version it is tested
// against). Average and Paeth depend on the byte just decoded to their
// left, so a row is one sequential pass; in Python that costs about 0.1 s
// for a 256 px RGB image, here well under a millisecond.
//
// Input: `rows` scanlines of 1 + `stride` bytes each (the filter-type byte,
// then the filtered bytes), as zlib inflates them. Output: rows x stride
// raw bytes. `bpp` is the number of bytes per complete pixel (at least 1).

#include <cstdint>
#include <cstdlib>

extern "C" {

// Returns 0, or -(row + 1) for a row whose filter type is not 0-4.
int64_t twin_png_unfilter(const uint8_t* in, int64_t rows, int64_t stride, int64_t bpp,
                          uint8_t* out) {
  for (int64_t r = 0; r < rows; r++) {
    const uint8_t* src = in + r * (stride + 1);
    const uint8_t type = src[0];
    src += 1;
    uint8_t* cur = out + r * stride;
    const uint8_t* prev = r ? out + (r - 1) * stride : nullptr;
    switch (type) {
      case 0:  // None
        for (int64_t i = 0; i < stride; i++) cur[i] = src[i];
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; i++) cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return -(r + 1);
    }
  }
  return 0;
}

}  // extern "C"
