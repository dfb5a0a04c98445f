// Host decoders of the detector formats' packed and big-endian frames
// (counterpart of libertem_tpu/native/decode.cpp; the same bits).
//
// Built with g++ -O3 -shared -fPIC at first use (ops/build.py) and
// called through ctypes (ops/decode.py), once a read: the readers hand
// over the whole read span and the destination (the host feed's pinned
// slot), so no frame passes through an intermediate array.
//
// Every frame decoder takes an input row stride in bytes: frame f's
// payload starts at inp + f * in_stride, so a read of whole records
// (an ASCII header then the payload, as MIB stores them) decodes in
// place of the cover.  Outputs are C-contiguous (n_frames, n_pix).
//
// Merlin Medipix RAW (R64) layout (single chip):
//  * r1:  64 pixels per 8-byte stripe; byte order reversed within the
//         stripe, bit b of a byte -> pixel (8*byte + b).
//  * r6:  one u8 per pixel, pixel order reversed in groups of 8.
//  * r12: one big-endian u16 per pixel, order reversed in groups of 4.
//  * r24: two consecutive r12 sub-frames, MSB 12 bits first.

#include <cstdint>
#include <cstring>

extern "C" {

// inp: n_frames rows of n_pix / 8 packed bytes; out: (n_frames, n_pix)
// u8.  8 bits expand to 8 output bytes (LSB first) branch-free: spread
// the byte into the 8 lanes of a u64, keep bit j in lane j, bring it to
// 0/1 with the +0x7F carry: one u64 store per input byte.
void decode_r1(const uint8_t* inp, int64_t in_stride, uint8_t* out,
               int64_t n_frames, int64_t n_pix) {
    const uint64_t SPREAD = 0x0101010101010101ULL;
    const uint64_t SELECT = 0x8040201008040201ULL;
    const uint64_t CARRY = 0x7F7F7F7F7F7F7F7FULL;
    for (int64_t f = 0; f < n_frames; f++) {
        const uint8_t* src = inp + f * in_stride;
        uint8_t* dst = out + f * n_pix;
        for (int64_t stripe = 0; stripe < n_pix / 64; stripe++) {
            for (int64_t byte = 0; byte < 8; byte++) {
                const uint64_t v = src[stripe * 8 + (7 - byte)];
                const uint64_t sel = (v * SPREAD) & SELECT;
                const uint64_t bits = ((sel + CARRY) >> 7) & SPREAD;
                memcpy(dst + stripe * 64 + byte * 8, &bits, 8);
            }
        }
    }
}

// A group of 8 r6 bytes reversed, or a group of 4 big-endian r12
// values reversed and brought to native order, is the group's 8 bytes
// in reverse order: one byte swap of a u64 each (the compiler turns
// the loop into vector shuffles).
static inline uint64_t reversed8(const uint8_t* src) {
    uint64_t v;
    memcpy(&v, src, 8);
    return __builtin_bswap64(v);
}

// inp: n_frames rows of n_pix u8; out: the same, order reversed in
// groups of 8
void decode_r6(const uint8_t* inp, int64_t in_stride, uint8_t* out,
               int64_t n_frames, int64_t n_pix) {
    for (int64_t f = 0; f < n_frames; f++) {
        const uint8_t* src = inp + f * in_stride;
        uint8_t* dst = out + f * n_pix;
        for (int64_t g = 0; g < n_pix / 8; g++) {
            const uint64_t v = reversed8(src + g * 8);
            memcpy(dst + g * 8, &v, 8);
        }
    }
}

// inp: n_frames rows of n_pix big-endian u16; out: native u16, order
// reversed in groups of 4
void decode_r12(const uint8_t* inp, int64_t in_stride, uint16_t* out,
                int64_t n_frames, int64_t n_pix) {
    for (int64_t f = 0; f < n_frames; f++) {
        const uint8_t* src = inp + f * in_stride;
        uint16_t* dst = out + f * n_pix;
        for (int64_t g = 0; g < n_pix / 4; g++) {
            const uint64_t v = reversed8(src + g * 8);
            memcpy(dst + g * 4, &v, 8);
        }
    }
}

// inp: n_frames rows of two r12 sub-frames of n_pix big-endian u16
// (MSB sub-frame, then LSB sub-frame); out: (n_frames, n_pix) u32
void decode_r24(const uint8_t* inp, int64_t in_stride, uint32_t* out,
                int64_t n_frames, int64_t n_pix) {
    for (int64_t f = 0; f < n_frames; f++) {
        const uint8_t* msb = inp + f * in_stride;
        const uint8_t* lsb = msb + n_pix * 2;
        uint32_t* dst = out + f * n_pix;
        for (int64_t g = 0; g < n_pix / 4; g++) {
            uint16_t hi[4], lo[4];
            const uint64_t vh = reversed8(msb + g * 8);
            const uint64_t vl = reversed8(lsb + g * 8);
            memcpy(hi, &vh, 8);
            memcpy(lo, &vl, 8);
            for (int c = 0; c < 4; c++) {
                dst[g * 4 + c] = ((uint32_t)hi[c] << 12) | lo[c];
            }
        }
    }
}

// n_rows rows of n items of another byte order -> native, into out
// ((n_rows, n) contiguous); inp == out with in_stride == n * size
// swaps in place
void byteswap16(const uint8_t* inp, int64_t in_stride, uint16_t* out,
                int64_t n_rows, int64_t n) {
    for (int64_t r = 0; r < n_rows; r++) {
        const uint8_t* src = inp + r * in_stride;
        uint16_t* dst = out + r * n;
        for (int64_t i = 0; i < n; i++) {
            uint16_t v;
            memcpy(&v, src + i * 2, 2);
            dst[i] = __builtin_bswap16(v);
        }
    }
}

void byteswap32(const uint8_t* inp, int64_t in_stride, uint32_t* out,
                int64_t n_rows, int64_t n) {
    for (int64_t r = 0; r < n_rows; r++) {
        const uint8_t* src = inp + r * in_stride;
        uint32_t* dst = out + r * n;
        for (int64_t i = 0; i < n; i++) {
            uint32_t v;
            memcpy(&v, src + i * 4, 4);
            dst[i] = __builtin_bswap32(v);
        }
    }
}

void byteswap64(const uint8_t* inp, int64_t in_stride, uint64_t* out,
                int64_t n_rows, int64_t n) {
    for (int64_t r = 0; r < n_rows; r++) {
        const uint8_t* src = inp + r * in_stride;
        uint64_t* dst = out + r * n;
        for (int64_t i = 0; i < n; i++) {
            uint64_t v;
            memcpy(&v, src + i * 8, 8);
            dst[i] = __builtin_bswap64(v);
        }
    }
}

// 12-bit little-endian packed pairs (3 bytes -> 2 pixels), the K2 IS
// format
void decode_uint12_le(const uint8_t* inp, uint16_t* out, int64_t n_pairs) {
    for (int64_t i = 0; i < n_pairs; i++) {
        const uint8_t b0 = inp[i * 3];
        const uint8_t b1 = inp[i * 3 + 1];
        const uint8_t b2 = inp[i * 3 + 2];
        out[i * 2] = (uint16_t)(b0 | ((b1 & 0x0F) << 8));
        out[i * 2 + 1] = (uint16_t)(((b1 & 0xF0) >> 4) | (b2 << 4));
    }
}

// K2 IS: n_blocks blocks of block_h x block_w 12-bit little-endian
// pixels, block b's payload at inp + payload_off[b], placed at rows
// [y[b], y[b] + block_h) and columns [x[b], x[b] + block_w) of frame
// frame_idx[b] of out ((n_frames, frame_h, frame_w) u16), in the
// order given (a later block over the same pixels wins).  One call
// decodes every block of one sector of a read.
void k2is_place_blocks(const uint8_t* inp, const int64_t* payload_off,
                       const int64_t* frame_idx, const int64_t* y,
                       const int64_t* x, int64_t n_blocks,
                       int64_t block_h, int64_t block_w, uint16_t* out,
                       int64_t frame_h, int64_t frame_w) {
    const int64_t pairs = block_w / 2;
    for (int64_t b = 0; b < n_blocks; b++) {
        const uint8_t* src = inp + payload_off[b];
        uint16_t* frame = out + frame_idx[b] * frame_h * frame_w;
        for (int64_t r = 0; r < block_h; r++) {
            uint16_t* dst = frame + (y[b] + r) * frame_w + x[b];
            const uint8_t* row = src + r * pairs * 3;
            for (int64_t i = 0; i < pairs; i++) {
                const uint8_t b0 = row[i * 3];
                const uint8_t b1 = row[i * 3 + 1];
                const uint8_t b2 = row[i * 3 + 2];
                dst[i * 2] = (uint16_t)(b0 | ((b1 & 0x0F) << 8));
                dst[i * 2 + 1] =
                    (uint16_t)(((b1 & 0xF0) >> 4) | (b2 << 4));
            }
        }
    }
}

}  // extern "C"
