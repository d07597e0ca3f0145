// Host-side image codecs of the port, beside image_tools.cpp: the pixel
// work of the PNG, GIF, WebP and TIFF readers (utils/png.py, utils/gif.py,
// utils/webp.py, utils/tiff.py parse the containers and call these).
// Built and loaded by dreamgaussian_tpu_torch/native.py, exposed through a
// plain C ABI for ctypes. Each function returns 0 on success and a positive
// code on a malformed stream.
//
//  - dg_png_unfilter: the five PNG row filters undone (None, Sub, Up,
//    Average, Paeth) over one pass of rows;
//  - dg_gif_lzw: GIF's variable-width LZW, codes of min_code + 1 to 12 bits;
//  - dg_webp_vp8l: a VP8L (lossless WebP) image stream as libwebp's
//    vp8l_dec.c decodes it: the four transforms (predictor with its 14
//    modes, cross-colour, subtract-green, colour indexing with pixel
//    bundling), the meta prefix codes, LZ77 with the 120 plane codes and the
//    colour cache; out: ARGB words;
//  - dg_webp_vp8: a VP8 (lossy WebP) key frame as libwebp's vp8_dec.c,
//    tree_dec.c, quant_dec.c and frame_dec.c decode it (boolean decoder,
//    segments, token partitions, intra predictions, WHT and IDCT, simple
//    and normal loop filters), then libwebp's output stage for
//    WebPDecodeRGB(A): its "fancy" chroma upsampling (upsampling.c) and its
//    14-bit fixed-point YUV->RGB (yuv.h);
//  - dg_webp_alpha_unfilter: the ALPH chunk's horizontal, vertical and
//    gradient filters undone (filters.c), in place;
//  - dg_tiff_decompress: a TIFF strip or tile's LZW, PackBits, CCITT
//    (Modified Huffman, T.4 1-D and 2-D, T.6) or ThunderScan data as
//    libtiff's tif_lzw.c, tif_packbits.c, tif_fax3.c and tif_thunder.c
//    decode it (utils/tiff.py parses the container);
//  - dg_tiff_unpredict: TIFF's horizontal and floating-point predictors
//    undone (tif_predict.c), in place;
//  - dg_sgilog_decode: SGILog and SGILog24 strips or tiles (LogL16,
//    LogLuv32 run-length, LogLuv24) as libtiff's tif_luv.c decodes them, to
//    float XYZ or its 8-bit RGB and grey; dg_xyz_to_rgb: OpenCV's float
//    XYZ-to-RGB conversion, which cv2 applies to a LogLuv decode;
//  - dg_hdr_decode: a Radiance HDR's RLE or flat RGBE pixels as OpenCV's
//    rgbe.cpp reads them (utils/hdr.py parses the header).
// Built with -ffp-contract=off: the float arithmetic that must round as
// OpenCV's and libtiff's does is written out, with no fused multiply-add.
// The probability and quantiser tables are those of the VP8 specification
// (RFC 6386), in libwebp's order of the intra 4x4 modes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

namespace {

const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// The intra 4x4 mode tree (libwebp's order: DC, TM, VE, HE, RD, VR, LD, VL,
// HD, HU); leaves are negated modes.
const int8_t kYModesIntra4[18] = {-0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};

// ---------------------------------------------------------------- PNG

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// ---------------------------------------------------------------- VP8L

struct LBits {   // least significant bit first
  const uint8_t* p;
  int64_t len, pos = 0, consumed = 0;
  uint64_t buf = 0;
  int cnt = 0;
  LBits(const uint8_t* d, int64_t n) : p(d), len(n) {}
  void fill() {
    while (cnt <= 56) {
      const uint64_t b = pos < len ? p[pos] : 0;
      ++pos;
      buf |= b << cnt;
      cnt += 8;
    }
  }
  uint32_t peek(int n) {
    if (cnt < n) fill();
    return (uint32_t)(buf & ((1ull << n) - 1));
  }
  void skip(int n) { buf >>= n; cnt -= n; consumed += n; }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool eos() const { return consumed > len * 8; }
};

constexpr int kPrimaryBits = 8;

// A canonical prefix code: an 8-bit table for short codes, the counts and
// sorted symbols for the rest; a code of one symbol reads no bits.
struct Huff {
  int single = -1;
  uint32_t table[1 << kPrimaryBits];
  uint16_t count[16];
  std::vector<uint16_t> sorted;
};

bool build_huff(const int* lengths, int n, Huff* h) {
  std::memset(h->count, 0, sizeof(h->count));
  int num = 0, last = -1;
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 0) {
      if (lengths[s] > 15) return false;
      h->count[lengths[s]]++;
      ++num;
      last = s;
    }
  }
  h->single = -1;
  if (num == 0) return false;
  if (num == 1) { h->single = last; return true; }
  int left = 1;
  for (int l = 1; l <= 15; ++l) {
    left = 2 * left - h->count[l];
    if (left < 0) return false;
  }
  if (left != 0) return false;   // incomplete: refused, as libwebp refuses it
  int offs[17];
  offs[1] = 0;
  for (int l = 1; l < 16; ++l) offs[l + 1] = offs[l] + h->count[l];
  h->sorted.assign(num, 0);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) h->sorted[offs[lengths[s]]++] = (uint16_t)s;
  std::memset(h->table, 0, sizeof(h->table));
  int code = 0, k = 0;
  for (int l = 1; l <= 15; ++l) {
    for (int i = 0; i < h->count[l]; ++i, ++k, ++code) {
      if (l > kPrimaryBits) continue;
      int rev = 0;
      for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
      for (int idx = rev; idx < (1 << kPrimaryBits); idx += 1 << l)
        h->table[idx] = ((uint32_t)l << 16) | h->sorted[k];
    }
    code <<= 1;
  }
  return true;
}

int read_sym(LBits& br, const Huff& h) {
  if (h.single >= 0) return h.single;
  const uint32_t e = h.table[br.peek(kPrimaryBits)];
  if (e) {
    br.skip(e >> 16);
    return e & 0xffff;
  }
  int code = 0, first = 0, index = 0;
  for (int l = 1; l <= 15; ++l) {
    code |= br.read(1);
    const int c = h.count[l];
    if (code - first < c) return h.sorted[index + code - first];
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return -1;
}

inline uint32_t add_px(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
inline uint32_t select_px(uint32_t a, uint32_t b, uint32_t c) {   // a = T, b = L, c = TL
  const int d = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff)
              + sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}
inline uint32_t clamp_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff)) << s;
  return out;
}
inline uint32_t clamp_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = avg2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}
inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct LTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct VP8LDec {
  LBits br;
  std::vector<LTransform> transforms;
  unsigned seen = 0;
  VP8LDec(const uint8_t* d, int64_t n) : br(d, n) {}

  bool read_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    Huff t;
    if (!build_huff(cl_lengths, 19, &t)) return false;
    int max_symbol = num_symbols;
    if (br.read(1)) {
      const int nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(nbits);
      if (max_symbol > num_symbols) return false;
    }
    int prev = 8, symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      const int code_len = read_sym(br, t);
      if (code_len < 0) return false;
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len != 0) prev = code_len;
      } else {
        const int slot = code_len - 16;
        const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        const int repeat = (int)br.read(extra[slot]) + offset[slot];
        if (symbol + repeat > num_symbols) return false;
        const int len = code_len == 16 ? prev : 0;
        for (int i = 0; i < repeat; ++i) lengths[symbol++] = len;
      }
    }
    return true;
  }

  bool read_code(int alphabet, Huff* h) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    if (br.read(1)) {   // simple code: one or two symbols
      const int num = (int)br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      lengths[br.read(first_bits)] = 1;
      if (num == 2) lengths[br.read(8)] = 1;
    } else {
      int cl[19] = {0};
      const int num_codes = (int)br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
      if (!read_lengths(cl, alphabet, lengths.data())) return false;
    }
    if (br.eos()) return false;
    return build_huff(lengths.data(), alphabet, h);
  }

  bool read_transform(int* xsize, int ysize) {
    const int type = (int)br.read(2);
    if (seen & (1u << type)) return false;
    seen |= 1u << type;
    LTransform t;
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    if (type == 0 || type == 1) {
      t.bits = (int)br.read(3) + 2;
      if (!decode_stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits), false, &t.data))
        return false;
    } else if (type == 3) {
      const int num_colors = (int)br.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal;
      if (!decode_stream(num_colors, 1, false, &pal)) return false;
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < num_colors; ++i) t.data[i] = add_px(pal[i], t.data[i - 1]);
    }
    transforms.push_back(std::move(t));
    return true;
  }

  int copy_value(int sym) {
    if (sym < 4) return sym + 1;
    const int extra = (sym - 2) >> 1;
    const int offset = (2 + (sym & 1)) << extra;
    return offset + (int)br.read(extra) + 1;
  }

  bool decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out) {
    int txs = xsize;
    if (level0)
      while (br.read(1))
        if (!read_transform(&txs, ysize)) return false;
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > 11) return false;
    }
    int hbits = 0, hxs = 0, ngroups = 1;
    std::vector<uint32_t> himg;
    if (level0 && br.read(1)) {
      hbits = (int)br.read(3) + 2;
      hxs = subsample(txs, hbits);
      if (!decode_stream(hxs, subsample(ysize, hbits), false, &himg)) return false;
      for (auto& v : himg) {
        v = (v >> 8) & 0xffff;
        ngroups = std::max(ngroups, (int)v + 1);
      }
    }
    // Every group's codes are read in order; those no tile names are
    // checked and dropped (libwebp maps the used ones the same way).
    std::vector<int> slot(ngroups, -1);
    int nused = 0;
    if (himg.empty()) {
      slot[0] = nused++;
    } else {
      for (auto& v : himg) {
        if (slot[v] < 0) slot[v] = nused++;
        v = slot[v];
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Huff> codes(5 * (size_t)nused);
    Huff scratch;
    for (int g = 0; g < ngroups; ++g)
      for (int j = 0; j < 5; ++j) {
        Huff* h = slot[g] >= 0 ? &codes[5 * (size_t)slot[g] + j] : &scratch;
        if (!read_code(kAlphabet[j] + (j == 0 ? cache_size : 0), h)) return false;
      }
    const int64_t total = (int64_t)txs * ysize;
    out->assign(total, 0);
    uint32_t* px = out->data();
    std::vector<uint32_t> cache(cache_size);
    const int shift = 32 - cache_bits;
    int64_t pos = 0, cached = 0;
    int col = 0, row = 0;
    while (pos < total) {
      const Huff* g = &codes[hbits ? 5 * (size_t)himg[(size_t)(row >> hbits) * hxs + (col >> hbits)] : 0];
      const int code = read_sym(br, g[0]);
      if (code < 0) return false;
      if (code < 256) {
        const int red = read_sym(br, g[1]), blue = read_sym(br, g[2]), alpha = read_sym(br, g[3]);
        if (red < 0 || blue < 0 || alpha < 0) return false;
        px[pos++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | blue;
        if (++col >= txs) { col = 0; ++row; }
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dsym = read_sym(br, g[4]);
        if (dsym < 0) return false;
        const int dcode = copy_value(dsym);
        int64_t dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          const int p = kCodeToPlane[dcode - 1];
          dist = (int64_t)(p >> 4) * txs + 8 - (p & 0xf);
          if (dist < 1) dist = 1;
        }
        if (dist > pos || total - pos < length) return false;
        for (int k = 0; k < length; ++k, ++pos) px[pos] = px[pos - dist];
        col += length;
        while (col >= txs) { col -= txs; ++row; }
      } else {
        const int key = code - 280;
        if (key >= cache_size) return false;
        for (; cached < pos; ++cached) cache[(uint32_t)(px[cached] * 0x1e35a7bdu) >> shift] = px[cached];
        px[pos++] = cache[key];
        if (++col >= txs) { col = 0; ++row; }
      }
      if (br.eos()) return false;
    }
    if (level0)
      for (int n = (int)transforms.size() - 1; n >= 0; --n) inverse(transforms[n], out);
    return true;
  }

  static void inverse(const LTransform& t, std::vector<uint32_t>* io) {
    const int w = t.xsize, h = t.ysize;
    uint32_t* d = io->data();
    if (t.type == 0) {   // predictor
      const int tpr = subsample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t* p = d + (size_t)y * w + x;
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : p[-1];
          } else if (x == 0) {
            pred = p[-w];
          } else {
            const uint32_t L = p[-1], T = p[-w], TL = p[-w - 1], TR = p[-w + 1];
            switch ((t.data[(size_t)(y >> t.bits) * tpr + (x >> t.bits)] >> 8) & 0xf) {
              case 1: pred = L; break;
              case 2: pred = T; break;
              case 3: pred = TR; break;
              case 4: pred = TL; break;
              case 5: pred = avg2(avg2(L, TR), T); break;
              case 6: pred = avg2(L, TL); break;
              case 7: pred = avg2(L, T); break;
              case 8: pred = avg2(TL, T); break;
              case 9: pred = avg2(T, TR); break;
              case 10: pred = avg2(avg2(L, TL), avg2(T, TR)); break;
              case 11: pred = select_px(T, L, TL); break;
              case 12: pred = clamp_full(L, T, TL); break;
              case 13: pred = clamp_half(L, T, TL); break;
              default: pred = 0xff000000u; break;
            }
          }
          *p = add_px(*p, pred);
        }
    } else if (t.type == 1) {   // cross-colour
      const int tpr = subsample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(size_t)(y >> t.bits) * tpr + (x >> t.bits)];
          const int g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff), r2b = (int8_t)((m >> 16) & 0xff);
          uint32_t& argb = d[(size_t)y * w + x];
          const int green = (int8_t)(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue += (g2b * green) >> 5;
          blue += (r2b * (int8_t)red) >> 5;
          argb = (argb & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)(blue & 0xff);
        }
    } else if (t.type == 2) {   // subtract green
      for (size_t i = 0; i < (size_t)w * h; ++i) {
        const uint32_t g = (d[i] >> 8) & 0xff;
        d[i] = (d[i] & 0xff00ff00u) | (((d[i] & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu);
      }
    } else {   // colour indexing
      const int in_w = subsample(w, t.bits);
      std::vector<uint32_t> out((size_t)w * h);
      const int bpp = 8 >> t.bits, cmask = (1 << t.bits) - 1, vmask = (1 << bpp) - 1;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t packed = (d[(size_t)y * in_w + (x >> t.bits)] >> 8) & 0xff;
          out[(size_t)y * w + x] = t.data[(packed >> ((x & cmask) * bpp)) & vmask];
        }
      io->swap(out);
    }
  }
};

// ---------------------------------------------------------------- VP8

struct BoolDec {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0, range = 255;
  int count = 0;
  void init(const uint8_t* s, size_t n) {
    p = s;
    end = s + n;
    value = (next() << 8) | next();
    range = 255;
    count = 0;
  }
  uint32_t next() { return p < end ? *p++ : 0; }
  int bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    const uint32_t big = split << 8;
    int r;
    if (value >= big) { r = 1; range -= split; value -= big; } else { r = 0; range = split; }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++count == 8) { count = 0; value |= next(); }
    }
    return r;
  }
  int literal(int n) {
    int v = 0;
    while (n--) v = (v << 1) | bit(128);
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return bit(128) ? -v : v;
  }
};

typedef uint8_t Probas[8][3][11];

int large_value(BoolDec& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// One block's tokens from position n; returns the position after the last
// non-zero coefficient (libwebp's GetCoeffs).
int get_coeffs(BoolDec& br, const Probas& bands, int ctx, const int dq[2], int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = bands[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = bands[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = (int16_t)((br.bit(128) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

constexpr int BPS = 32;

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_add(const int16_t* in, uint8_t* dst) {   // libwebp's TransformOne
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}
void fill_block(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}
// 16x16 (size 16) or chroma 8x8 (size 8): modes DC, TM, V, H and the DC
// variants without top (4), without left (5), without either (6).
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case 0:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill_block(dst, size, (dc + size) >> (shift + 1));
      break;
    case 1: true_motion(dst, size); break;
    case 2:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case 3:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    case 4:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill_block(dst, size, (dc + (size >> 1)) >> shift);
      break;
    case 5:
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill_block(dst, size, (dc + (size >> 1)) >> shift);
      break;
    default: fill_block(dst, size, 0x80); break;
  }
}

void predict4(uint8_t* dst, int mode) {
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = dst[-1 - BPS], A = dst[-BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
  const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
  switch (mode) {
    case 0: {   // DC
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, 4, dc >> 3);
      break;
    }
    case 1: true_motion(dst, 4); break;
    case 2: {   // VE
      const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case 3:   // HE
      std::memset(dst, AVG3(X, I, J), 4);
      std::memset(dst + BPS, AVG3(I, J, K), 4);
      std::memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      std::memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case 4:   // RD
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case 5:   // VR
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case 6:   // LD
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case 7:   // VL
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case 8:   // HD
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    default:   // HU
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

// The loop filters (dsp/dec.c).
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {   // 16 pixels along an edge
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
    else if (edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, hev_t = 0;
  bool inner = false;
};

inline int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

// libwebp's VP8YUVToR/G/B (14-bit coefficients, 6 fractional bits).
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t yuv_clip8(int v) { return (uint8_t)((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One output row of libwebp's fancy upsampler: ``a`` is the chroma row
// passed as its "top" row, ``b`` as its "current" row; ``bottom`` picks
// the role of the row in the pair.
void fancy_row(const uint8_t* y, const uint8_t* au, const uint8_t* av, const uint8_t* bu,
               const uint8_t* bv, bool bottom, int len, uint8_t* dst, int ch) {
  const uint8_t* cu[2] = {au, bu};
  const uint8_t* cv[2] = {av, bv};
  int uv[2][2];   // [plane][0: first, 1: second] for the pixel pair
  auto emit = [&](int x, int u, int v) { yuv_to_rgb(y[x], u, v, dst + (size_t)x * ch); };
  auto first = [&](const uint8_t* const* c, int i) {
    const int tl = c[0][i], l = c[1][i];
    return bottom ? (3 * l + tl + 2) >> 2 : (3 * tl + l + 2) >> 2;
  };
  emit(0, first(cu, 0), first(cv, 0));
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    for (int k = 0; k < 2; ++k) {
      const uint8_t* const* c = k == 0 ? cu : cv;
      const int tl = c[0][x - 1], t = c[0][x], l = c[1][x - 1], s = c[1][x];
      const int avg = tl + t + l + s + 8;
      const int d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + s)) >> 3;
      uv[k][0] = bottom ? (d03 + l) >> 1 : (d12 + tl) >> 1;
      uv[k][1] = bottom ? (d12 + s) >> 1 : (d03 + t) >> 1;
    }
    emit(2 * x - 1, uv[0][0], uv[1][0]);
    emit(2 * x, uv[0][1], uv[1][1]);
  }
  if (!(len & 1)) emit(len - 1, first(cu, last_pair), first(cv, last_pair));
}

int vp8_decode(const uint8_t* data, size_t size, int want_w, int want_h, uint8_t* out, int ch) {
  if (size < 10) return 1;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key = !(bits & 1), show = (bits >> 4) & 1;
  const int profile = (bits >> 1) & 7;
  const size_t part_len = bits >> 5;
  if (!key || profile > 3 || !show) return 2;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return 3;
  const int w = (data[6] | (data[7] << 8)) & 0x3fff, h = (data[8] | (data[9] << 8)) & 0x3fff;
  if (w != want_w || h != want_h || w == 0 || h == 0) return 4;
  const uint8_t* buf = data + 10;
  size_t left = size - 10;
  if (part_len > left) return 5;
  BoolDec br;
  br.init(buf, part_len);
  buf += part_len;
  left -= part_len;
  br.literal(1);   // colour space
  br.literal(1);   // clamping type
  // Segments.
  bool use_segment = br.literal(1), update_map = false, absolute = true;
  int seg_q[4] = {0}, seg_f[4] = {0}, seg_p[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.literal(1);
    if (br.literal(1)) {
      absolute = br.literal(1);
      for (int s = 0; s < 4; ++s) seg_q[s] = br.literal(1) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) seg_f[s] = br.literal(1) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_p[s] = br.literal(1) ? br.literal(8) : 255;
  }
  // Loop filter.
  const bool simple = br.literal(1);
  const int level = br.literal(6), sharpness = br.literal(3);
  const bool use_lf_delta = br.literal(1);
  int ref_delta0 = 0, mode_delta0 = 0;
  if (use_lf_delta && br.literal(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) { const int d = br.signed_literal(6); if (i == 0) ref_delta0 = d; }
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) { const int d = br.signed_literal(6); if (i == 0) mode_delta0 = d; }
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  // Token partitions.
  const int last_part = (1 << br.literal(2)) - 1;
  if (left < (size_t)(3 * last_part)) return 6;
  BoolDec parts[8];
  {
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last_part;
    size_t rest = left - 3 * last_part;
    for (int p = 0; p < last_part; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > rest) psize = rest;
      parts[p].init(start, psize);
      start += psize;
      rest -= psize;
    }
    parts[last_part].init(start, rest);
  }
  // Quantisers.
  const int base_q = br.literal(7);
  const int dy1_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dy2_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dy2_ac = br.literal(1) ? br.signed_literal(4) : 0;
  const int duv_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int duv_ac = br.literal(1) ? br.signed_literal(4) : 0;
  int dq[4][3][2];   // [segment][y1, y2, uv][dc, ac]
  for (int s = 0; s < 4; ++s) {
    int q = base_q;
    if (use_segment) {
      q = seg_q[s];
      if (!absolute) q += base_q;
    }
    dq[s][0][0] = kDcTable[clip_q(q + dy1_dc, 127)];
    dq[s][0][1] = kAcTable[clip_q(q, 127)];
    dq[s][1][0] = kDcTable[clip_q(q + dy2_dc, 127)] * 2;
    dq[s][1][1] = std::max((kAcTable[clip_q(q + dy2_ac, 127)] * 101581) >> 16, 8);
    dq[s][2][0] = kDcTable[clip_q(q + duv_dc, 117)];
    dq[s][2][1] = kAcTable[clip_q(q + duv_ac, 127)];
  }
  br.literal(1);   // refresh entropy probabilities: ignored for a key frame
  Probas proba[4];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[i]) ? br.literal(8) : kCoeffsProba0[i];
        }
  const bool use_skip = br.literal(1);
  const int skip_p = use_skip ? br.literal(8) : 0;
  // Filter strengths per segment and block size (PrecomputeFilterStrengths).
  FInfo fstr[4][2];
  for (int s = 0; s < 4 && filter_type > 0; ++s) {
    int base = level;
    if (use_segment) {
      base = seg_f[s];
      if (!absolute) base += level;
    }
    for (int i4 = 0; i4 <= 1; ++i4) {
      FInfo& f = fstr[s][i4];
      int lvl = base;
      if (use_lf_delta) {
        lvl += ref_delta0;
        if (i4) lvl += mode_delta0;
      }
      lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
      if (lvl > 0) {
        int il = lvl;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          if (il > 9 - sharpness) il = 9 - sharpness;
        }
        if (il < 1) il = 1;
        f.ilevel = il;
        f.limit = 2 * lvl + il;
        f.hev_t = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
      }
      f.inner = i4;
    }
  }

  const int mb_w = (w + 15) >> 4, mb_h = (h + 15) >> 4;
  const int ys = mb_w * 16, cs = mb_w * 8;
  std::vector<uint8_t> Y((size_t)ys * mb_h * 16), U((size_t)cs * mb_h * 8), V((size_t)cs * mb_h * 8);
  std::vector<FInfo> finfo((size_t)mb_w * mb_h);
  std::vector<uint8_t> intra_t(4 * (size_t)mb_w, 0);
  std::vector<uint8_t> nz_y(4 * (size_t)mb_w), nz_u(2 * (size_t)mb_w), nz_v(2 * (size_t)mb_w), nz_dc(mb_w);
  uint8_t ws[17 * BPS + 2 * 9 * BPS];
  uint8_t* const ydst = ws + BPS + 8;
  uint8_t* const udst = ws + 17 * BPS + BPS + 8;
  uint8_t* const vdst = udst + 9 * BPS;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolDec& tok = parts[mb_y & last_part];
    uint8_t intra_l[4] = {0, 0, 0, 0}, l_y[4] = {0, 0, 0, 0}, l_u[2] = {0, 0}, l_v[2] = {0, 0};
    uint8_t l_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      // Modes (first partition).
      int segment = 0;
      if (update_map)
        segment = !br.bit(seg_p[0]) ? br.bit(seg_p[1]) : br.bit(seg_p[2]) + 2;
      const bool skip = use_skip ? br.bit(skip_p) : false;
      const bool i4x4 = !br.bit(145);
      uint8_t modes[16];
      uint8_t* top = &intra_t[4 * (size_t)mb_x];
      if (!i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? 1 : 3) : (br.bit(163) ? 2 : 0);
        modes[0] = (uint8_t)ymode;
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ymode = -i;
            top[x] = (uint8_t)ymode;
          }
          std::memcpy(modes + 4 * y, top, 4);
          intra_l[y] = (uint8_t)ymode;
        }
      }
      const int uvmode = !br.bit(142) ? 0 : !br.bit(114) ? 2 : br.bit(183) ? 1 : 3;

      // Residuals (the row's token partition).
      int16_t coeffs[384];
      std::memset(coeffs, 0, sizeof(coeffs));
      bool nonzero = false;
      if (!skip) {
        const int (*q)[2] = dq[segment];
        int first = 0, ac_type = 3;
        if (!i4x4) {
          int16_t dc[16] = {0};
          const int nz = get_coeffs(tok, proba[1], nz_dc[mb_x] + l_dc, q[1], 0, dc);
          nz_dc[mb_x] = l_dc = nz > 0;
          if (nz > 1) {
            transform_wht(dc, coeffs);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) coeffs[i] = (int16_t)dc0;
          }
          first = 1;
          ac_type = 0;
        }
        for (int y = 0; y < 4; ++y) {
          int l = l_y[y];
          for (int x = 0; x < 4; ++x) {
            uint8_t& t = nz_y[4 * (size_t)mb_x + x];
            const int nz = get_coeffs(tok, proba[ac_type], l + t, q[0], first, coeffs + 16 * (4 * y + x));
            l = t = nz > first;
          }
          l_y[y] = (uint8_t)l;
        }
        for (int c = 0; c < 2; ++c) {
          uint8_t* tops = c == 0 ? &nz_u[2 * (size_t)mb_x] : &nz_v[2 * (size_t)mb_x];
          uint8_t* lefts = c == 0 ? l_u : l_v;
          for (int y = 0; y < 2; ++y) {
            int l = lefts[y];
            for (int x = 0; x < 2; ++x) {
              const int nz = get_coeffs(tok, proba[2], l + tops[x], q[2], 0,
                                        coeffs + 256 + 64 * c + 16 * (2 * y + x));
              l = tops[x] = nz > 0;
            }
            lefts[y] = (uint8_t)l;
          }
        }
        for (int i = 0; i < 384 && !nonzero; ++i) nonzero = coeffs[i] != 0;
      } else {
        std::memset(&nz_y[4 * (size_t)mb_x], 0, 4);
        std::memset(&nz_u[2 * (size_t)mb_x], 0, 2);
        std::memset(&nz_v[2 * (size_t)mb_x], 0, 2);
        std::memset(l_y, 0, 4);
        std::memset(l_u, 0, 2);
        std::memset(l_v, 0, 2);
        if (!i4x4) nz_dc[mb_x] = l_dc = 0;
      }
      if (filter_type > 0) {
        finfo[(size_t)mb_y * mb_w + mb_x] = fstr[segment][i4x4];
        finfo[(size_t)mb_y * mb_w + mb_x].inner |= nonzero;
      }

      // Reconstruction in the work buffer, from the unfiltered frame.
      uint8_t* Yb = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
      uint8_t* Ub = &U[(size_t)mb_y * 8 * cs + mb_x * 8];
      uint8_t* Vb = &V[(size_t)mb_y * 8 * cs + mb_x * 8];
      if (mb_y == 0) {
        std::memset(ydst - BPS - 1, 127, 21);
        std::memset(udst - BPS - 1, 127, 9);
        std::memset(vdst - BPS - 1, 127, 9);
      } else {
        ydst[-BPS - 1] = mb_x > 0 ? Yb[-ys - 1] : 129;
        udst[-BPS - 1] = mb_x > 0 ? Ub[-cs - 1] : 129;
        vdst[-BPS - 1] = mb_x > 0 ? Vb[-cs - 1] : 129;
        std::memcpy(ydst - BPS, Yb - ys, 16);
        std::memcpy(udst - BPS, Ub - cs, 8);
        std::memcpy(vdst - BPS, Vb - cs, 8);
        if (mb_x < mb_w - 1) std::memcpy(ydst - BPS + 16, Yb - ys + 16, 4);
        else std::memset(ydst - BPS + 16, Yb[-ys + 15], 4);
      }
      for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = mb_x > 0 ? Yb[(size_t)j * ys - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        udst[j * BPS - 1] = mb_x > 0 ? Ub[(size_t)j * cs - 1] : 129;
        vdst[j * BPS - 1] = mb_x > 0 ? Vb[(size_t)j * cs - 1] : 129;
      }
      const int dc_mode = mb_x == 0 ? (mb_y == 0 ? 6 : 5) : (mb_y == 0 ? 4 : 0);
      if (i4x4) {
        for (int r = 1; r < 4; ++r) std::memcpy(ydst + (4 * r - 1) * BPS + 16, ydst - BPS + 16, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, modes[n]);
          transform_add(coeffs + 16 * n, dst);
        }
      } else {
        predict_block(ydst, 16, modes[0] == 0 ? dc_mode : modes[0]);
        for (int n = 0; n < 16; ++n)
          transform_add(coeffs + 16 * n, ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int cmode = uvmode == 0 ? dc_mode : uvmode;
      predict_block(udst, 8, cmode);
      predict_block(vdst, 8, cmode);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        transform_add(coeffs + 256 + 16 * n, udst + off);
        transform_add(coeffs + 320 + 16 * n, vdst + off);
      }
      for (int j = 0; j < 16; ++j) std::memcpy(Yb + (size_t)j * ys, ydst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(Ub + (size_t)j * cs, udst + j * BPS, 8);
        std::memcpy(Vb + (size_t)j * cs, vdst + j * BPS, 8);
      }
    }
  }

  // Loop filter, macroblocks in raster order (DoFilter).
  for (int mb_y = 0; mb_y < mb_h && filter_type > 0; ++mb_y)
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
      if (f.limit == 0) continue;
      uint8_t* y = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
      if (filter_type == 1) {
        if (mb_x > 0) simple_filter(y, 1, ys, f.limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, f.limit);
        if (mb_y > 0) simple_filter(y, ys, 1, f.limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, f.limit);
      } else {
        uint8_t* u = &U[(size_t)mb_y * 8 * cs + mb_x * 8];
        uint8_t* v = &V[(size_t)mb_y * 8 * cs + mb_x * 8];
        const int lim = f.limit, il = f.ilevel, ht = f.hev_t;
        if (mb_x > 0) {
          filter_loop(y, 1, ys, 16, lim + 4, il, ht, true);
          filter_loop(u, 1, cs, 8, lim + 4, il, ht, true);
          filter_loop(v, 1, cs, 8, lim + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k, 1, ys, 16, lim, il, ht, false);
          filter_loop(u + 4, 1, cs, 8, lim, il, ht, false);
          filter_loop(v + 4, 1, cs, 8, lim, il, ht, false);
        }
        if (mb_y > 0) {
          filter_loop(y, ys, 1, 16, lim + 4, il, ht, true);
          filter_loop(u, cs, 1, 8, lim + 4, il, ht, true);
          filter_loop(v, cs, 1, 8, lim + 4, il, ht, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, lim, il, ht, false);
          filter_loop(u + 4 * cs, cs, 1, 8, lim, il, ht, false);
          filter_loop(v + 4 * cs, cs, 1, 8, lim, il, ht, false);
        }
      }
    }

  // Output: fancy upsampling and YUV->RGB, row by row.
  const int uv_h = (h + 1) >> 1;
  for (int r = 0; r < h; ++r) {
    int a, b;
    bool bottom = false;
    if (r == 0) {
      a = b = 0;
    } else if (r & 1) {
      a = (r - 1) >> 1;
      b = std::min((r + 1) >> 1, uv_h - 1);
      if (r == h - 1) b = a;
    } else {
      a = r / 2 - 1;
      b = r / 2;
      bottom = true;
    }
    fancy_row(&Y[(size_t)r * ys], &U[(size_t)a * cs], &V[(size_t)a * cs], &U[(size_t)b * cs],
              &V[(size_t)b * cs], bottom, w, out + (size_t)r * w * ch, ch);
  }
  return 0;
}


// ---------------------------------------------------------------- TIFF CCITT
// The T.4 / T.6 codes (ITU-T T.4 tables 1-3 and 4), as (bits, run) pairs;
// the decoder below reads them as libtiff's tif_fax3.c does.

struct FaxCode {
  const char* bits;
  int run;
};

const FaxCode kWhiteCodes[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5},
    {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11},
    {"001000", 12}, {"000011", 13}, {"110100", 14}, {"110101", 15}, {"101010", 16},
    {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36},
    {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46},
    {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63},
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320},
    {"00110111", 384}, {"01100100", 448}, {"01100101", 512}, {"01101000", 576},
    {"01100111", 640}, {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088},
    {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728}};

const FaxCode kBlackCodes[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5}, {"0010", 6},
    {"00011", 7}, {"000101", 8}, {"000100", 9}, {"0000100", 10}, {"0000101", 11},
    {"0000111", 12}, {"00000100", 13}, {"00000111", 14}, {"000011000", 15},
    {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63},
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448},
    {"0000001101100", 512}, {"0000001101101", 576}, {"0000001001010", 640},
    {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}};

// Make-up codes of 1792 to 2560, common to both colours.
const FaxCode kExtendedCodes[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

enum FaxState { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
                S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct FaxEntry {
  uint8_t state, width;
  int32_t param;
};

// A table indexed by the next ``bits`` bits of the stream, first bit in bit 0.
struct FaxTable {
  int bits;
  std::vector<FaxEntry> e;
  explicit FaxTable(int b) : bits(b), e((size_t)1 << b, FaxEntry{S_Null, 0, 0}) {}
  void add(const char* code, uint8_t state, int32_t param) {
    const int len = (int)std::strlen(code);
    uint32_t idx = 0;
    for (int i = 0; i < len; ++i)
      if (code[i] == '1') idx |= 1u << i;
    for (uint32_t rest = 0; rest < (1u << (bits - len)); ++rest)
      e[idx | (rest << len)] = FaxEntry{state, (uint8_t)len, param};
  }
};

struct FaxTables {
  FaxTable white{12}, black{13}, main{7};
  FaxTables() {
    for (const FaxCode& c : kWhiteCodes) white.add(c.bits, c.run < 64 ? S_TermW : S_MakeUpW, c.run);
    for (const FaxCode& c : kBlackCodes) black.add(c.bits, c.run < 64 ? S_TermB : S_MakeUpB, c.run);
    for (const FaxCode& c : kExtendedCodes) {
      white.add(c.bits, S_MakeUp, c.run);
      black.add(c.bits, S_MakeUp, c.run);
    }
    white.add("00000000000", S_EOL, 0);     // an EOL's first 11 bits, as libtiff's tables
    black.add("00000000000", S_EOL, 0);     // hold it: SYNC_EOL then reads its 1 bit
    main.add("0001", S_Pass, 0);
    main.add("001", S_Horiz, 0);
    main.add("1", S_V0, 0);
    main.add("011", S_VR, 1);
    main.add("000011", S_VR, 2);
    main.add("0000011", S_VR, 3);
    main.add("010", S_VL, 1);
    main.add("000010", S_VL, 2);
    main.add("0000010", S_VL, 3);
    main.add("0000001", S_Ext, 0);
    main.add("0000000", S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

uint8_t reverse_bits(uint8_t b) {
  b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// libtiff's bit accumulator (tif_fax3.h NeedBits8/NeedBits16/GetBits/
// ClrBits): bits enter at the top of ``acc`` a byte at a time, so the
// count of bits held, which the word alignment of compression 32771 reads,
// is the one libtiff holds.
struct FaxBits {
  const uint8_t* p;
  int64_t n, pos = 0;
  bool msb_first;
  uint32_t acc = 0;
  int avail = 0;
  uint32_t byte() { const uint8_t b = p[pos++]; return msb_first ? reverse_bits(b) : b; }
  bool need8(int k) {
    if (avail < k) {
      if (pos >= n) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= byte() << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int k) {
    if (avail < k) {
      if (pos >= n) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= byte() << avail;
        if ((avail += 8) < k) {
          if (pos >= n) {
            avail = k;
          } else {
            acc |= byte() << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int k) const { return acc & ((1u << k) - 1); }
  void clr(int k) { acc >>= k; avail -= k; }
};

// One strip or tile of CCITT data (libtiff's Fax3DecodeRLE, Fax3Decode1D,
// Fax3Decode2D and Fax4Decode) into ``rows`` packed rows of ``width`` bits,
// black runs as 1 bits. ``kind``: 2 Modified Huffman (rows byte-aligned),
// 32771 the same word-aligned (``odd`` the parity of the data's offset in
// the file, which libtiff's alignment test reads), 3 T.4 (``two_d`` from
// T4Options bit 0), 4 T.6. Returns the rows decoded in full.
int fax_decode(const uint8_t* data, int64_t len, int kind, bool two_d, bool msb_first, bool odd,
               int width, int rows, uint8_t* out) {
  const FaxTables& T = fax_tables();
  FaxBits B{data, len, 0, msb_first};
  const int64_t rowbytes = (width + 7) / 8;
  std::vector<int32_t> cur((size_t)2 * width + 8), ref((size_t)2 * width + 8);
  ref[0] = width;
  ref[1] = 0;
  size_t nref = 2;
  bool eol_seen = false;
  std::memset(out, 0, (size_t)rowbytes * rows);
  for (int row = 0; row < rows; ++row) {
    int a0 = 0, run_length = 0;
    size_t pa = 0;
    bool eof = false;
    auto setvalue = [&](int x) {
      if (pa < cur.size()) cur[pa++] = run_length + x;
      a0 += x;
      run_length = 0;
    };
    // One run of ``table``'s colour with its make-up codes; false at a bad
    // code, an EOL or the end of the data.
    auto run = [&](const FaxTable& table, uint8_t term, uint8_t makeup, bool* eol) -> bool {
      for (;;) {
        if (!B.need16(table.bits)) { eof = true; return false; }
        const FaxEntry& t = table.e[B.get(table.bits)];
        B.clr(t.width);
        if (t.state == term) { setvalue(t.param); return true; }
        if (t.state == makeup || t.state == S_MakeUp) {
          a0 += t.param;
          run_length += t.param;
          continue;
        }
        if (t.state == S_EOL && eol) *eol = true;
        return false;
      }
    };
    auto sync_eol = [&]() -> bool {       // SYNC_EOL
      if (!eol_seen) {
        for (;;) {
          if (!B.need16(11)) return false;
          if (B.get(11) == 0) break;
          B.clr(1);
        }
      }
      for (;;) {
        if (!B.need8(8)) return false;
        if (B.get(8)) break;
        B.clr(8);
      }
      while (B.get(1) == 0) B.clr(1);
      B.clr(1);
      eol_seen = false;
      return true;
    };
    auto expand_1d = [&]() {
      for (;;) {
        bool eol = false;
        if (!run(T.white, S_TermW, S_MakeUpW, &eol)) { eol_seen = eol; return; }
        if (a0 >= width) return;
        if (!run(T.black, S_TermB, S_MakeUpB, &eol)) { eol_seen = eol; return; }
        if (a0 >= width) return;
        if (pa >= 2 && cur[pa - 1] == 0 && cur[pa - 2] == 0) pa -= 2;
      }
    };
    auto expand_2d = [&]() {
      size_t pb = 0;
      int b1 = ref[pb++];
      auto check_b1 = [&]() -> bool {
        if (pa != 0)
          while (b1 <= a0 && b1 < width) {
            if (pb + 1 >= nref) return false;
            b1 += ref[pb] + ref[pb + 1];
            pb += 2;
          }
        return true;
      };
      while (a0 < width) {
        if (!B.need8(7)) { eof = true; return; }
        const FaxEntry& t = T.main.e[B.get(7)];
        B.clr(t.width);
        switch (t.state) {
          case S_Pass:
            if (!check_b1() || pb + 1 >= nref) return;
            b1 += ref[pb++];
            run_length += b1 - a0;
            a0 = b1;
            b1 += ref[pb++];
            break;
          case S_Horiz: {
            const bool black_first = (pa & 1) != 0;
            const FaxTable& first = black_first ? T.black : T.white;
            const FaxTable& second = black_first ? T.white : T.black;
            if (!run(first, black_first ? S_TermB : S_TermW, black_first ? S_MakeUpB : S_MakeUpW,
                     nullptr) ||
                !run(second, black_first ? S_TermW : S_TermB, black_first ? S_MakeUpW : S_MakeUpB,
                     nullptr))
              return;
            if (!check_b1()) return;
            break;
          }
          case S_V0:
            if (!check_b1()) return;
            setvalue(b1 - a0);
            if (pb >= nref) return;
            b1 += ref[pb++];
            break;
          case S_VR:
            if (!check_b1()) return;
            setvalue(b1 - a0 + t.param);
            if (pb >= nref) return;
            b1 += ref[pb++];
            break;
          case S_VL:
            if (!check_b1()) return;
            if (b1 < a0 + t.param) return;
            setvalue(b1 - a0 - t.param);
            if (pb == 0) return;
            b1 -= ref[--pb];
            break;
          case S_EOL:
            if (pa < cur.size()) cur[pa++] = width - a0;
            if (!B.need8(4)) { eof = true; return; }
            B.clr(4);
            eol_seen = true;
            return;
          default:
            return;
        }
      }
      if (run_length) {
        if (run_length + a0 < width) {
          if (!B.need8(1)) { eof = true; return; }
          if (!B.get(1)) return;
          B.clr(1);
        }
        setvalue(0);
      }
    };
    bool one_d = true;
    if (kind == 3) {
      if (!sync_eol()) return row;
      if (two_d) {
        if (!B.need8(1)) return row;
        one_d = B.get(1) != 0;
        B.clr(1);
      }
    } else if (kind == 4) {
      one_d = false;
    }
    if (one_d) expand_1d(); else expand_2d();
    if (eof) return row;
    // CLEANUP_RUNS: the row's runs made to sum to its width.
    if (run_length) setvalue(0);
    if (a0 != width) {
      while (a0 > width && pa > 0) a0 -= cur[--pa];
      if (a0 < width) {
        if (a0 < 0) a0 = 0;
        if (pa & 1) setvalue(0);
        setvalue(width - a0);
      } else if (a0 > width) {
        setvalue(width);
        setvalue(0);
      }
    }
    // _TIFFFax3fillruns: black runs (odd positions) as 1 bits.
    uint8_t* dst = out + (size_t)row * rowbytes;
    int x = 0;
    for (size_t i = 0; i < pa && x < width; ++i) {
      int r = cur[i];
      if (r > width - x || r < 0) r = width - x;
      if (i & 1)
        for (int k = x; k < x + r; ++k) dst[k >> 3] |= (uint8_t)(0x80 >> (k & 7));
      x += r;
    }
    if (kind == 2 || kind == 32771) {
      if (kind == 2) {
        B.clr(B.avail - (B.avail & ~7));
      } else {
        B.clr(B.avail - (B.avail & ~15));
        if (B.avail == 0 && ((B.pos + (odd ? 1 : 0)) & 1)) ++B.pos;
      }
    }
    if (kind == 3 || kind == 4) {
      if (pa < cur.size()) cur[pa++] = 0;         // the imaginary change closing the reference
      std::swap(cur, ref);
      nref = pa;
    }
    if (kind == 4 && eol_seen) return row + 1;
  }
  return rows;
}

// TIFF LZW (libtiff's LZWDecode): MSB-first codes of 9 to 12 bits, the
// width raised when the next free entry reaches 2^width - 1; 256 clears,
// 257 ends. Decodes until ``out`` holds ``cap`` bytes or the codes end.
int64_t tiff_lzw(const uint8_t* data, int64_t len, uint8_t* out, int64_t cap) {
  std::vector<int32_t> prefix(4096 + 1024, -1), length(4096 + 1024, 0);
  std::vector<uint8_t> suffix(4096 + 1024), first(4096 + 1024);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int width = 9, next = 258, prev = -1;
  uint64_t acc = 0;
  int nb = 0;
  int64_t pos = 0, o = 0;
  auto read = [&](int* code) {
    while (nb < width && pos < len) {
      acc = (acc << 8) | data[pos++];
      nb += 8;
    }
    if (nb < width) return false;
    nb -= width;
    *code = (int)((acc >> nb) & ((1u << width) - 1));
    return true;
  };
  std::vector<uint8_t> stack(4096 + 1024);
  while (o < cap) {
    int code;
    if (!read(&code) || code == 257) break;
    if (code == 256) {
      width = 9;
      next = 258;
      do {
        if (!read(&code)) return o;
      } while (code == 256);
      if (code == 257) break;
      if (code > 256) return -1;
      out[o++] = (uint8_t)code;
      prev = code;
      continue;
    }
    if (prev < 0) {           // no clear code first: the table as after one
      if (code > 255) return -1;
      out[o++] = (uint8_t)code;
      prev = code;
      continue;
    }
    if (code > next || next >= (int)prefix.size()) return -1;
    const int base = code < next ? code : prev;
    prefix[next] = prev;
    suffix[next] = first[base];
    first[next] = first[prev];
    length[next] = length[prev] + 1;
    ++next;
    if (next > (1 << width) - 2 && width < 12) ++width;
    int n = 0;
    for (int e = code; e >= 0 && n < (int)stack.size(); e = prefix[e]) stack[n++] = suffix[e];
    while (n > 0 && o < cap) out[o++] = stack[--n];
    prev = code;
  }
  return o;
}

// PackBits (libtiff's PackBitsDecode) until ``out`` holds ``cap`` bytes.
int64_t tiff_packbits(const uint8_t* data, int64_t len, uint8_t* out, int64_t cap) {
  int64_t pos = 0, o = 0;
  while (pos < len && o < cap) {
    int n = data[pos++];
    if (n >= 128) n -= 256;
    if (n < 0) {
      if (n == -128) continue;
      int64_t k = std::min<int64_t>(1 - n, cap - o);
      if (pos >= len) break;
      const uint8_t b = data[pos++];
      std::memset(out + o, b, (size_t)k);
      o += k;
    } else {
      int64_t k = std::min<int64_t>(n + 1, cap - o);
      if (len - pos < k) break;
      std::memcpy(out + o, data + pos, (size_t)k);
      o += k;
      pos += k;
    }
  }
  return o;
}

template <typename T>
void horizontal_acc(uint8_t* row, int64_t row_bytes, int stride) {
  T* p = reinterpret_cast<T*>(row);
  const int64_t n = row_bytes / (int64_t)sizeof(T);
  for (int64_t i = stride; i < n; ++i) p[i] = (T)(p[i] + p[i - stride]);
}


// ---------------------------------------------------------------- Radiance HDR
// OpenCV's rgbe.cpp (Bruce Walter's RGBE reader): a pixel's mantissas
// times ldexp(1, e - 136), an exponent of 0 giving 0.
inline void rgbe_to_float(const uint8_t* p, float* rgb) {
  if (p[3]) {
    const float f = (float)std::ldexp(1.0, (int)p[3] - (128 + 8));
    rgb[0] = p[0] * f;
    rgb[1] = p[1] * f;
    rgb[2] = p[2] * f;
  } else {
    rgb[0] = rgb[1] = rgb[2] = 0.f;
  }
}

// RGBE_ReadPixels: ``n`` flat 4-byte pixels; false where the data ends first.
bool rgbe_flat(const uint8_t* data, int64_t len, int64_t* pos, float* rgb, int64_t n) {
  for (int64_t i = 0; i < n; ++i, rgb += 3) {
    if (len - *pos < 4) return false;
    rgbe_to_float(data + *pos, rgb);
    *pos += 4;
  }
  return true;
}

// ---------------------------------------------------------------- SGILog (libtiff tif_luv.c)
constexpr double kLn2 = 0.69314718055994530942;
constexpr double kUvScale = 410.;
constexpr double kUNeu = 0.210526316, kVNeu = 0.473684211;
constexpr int kUvNdivs = 16289, kUvNvs = 163;
constexpr float kUvSqsiz = 0.003500f, kUvVstart = 0.016940f;

// uvcode.h (Greg Ward Larson, SGI): per v row of the (u', v') grid, its
// first u', its cell count and the cells before it.
struct UvRow {
  float ustart;
  int16_t nus, ncum;
};
const UvRow kUvRow[kUvNvs] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10}, {0.237874f, 9, 17},
    {0.235906f, 10, 26}, {0.232153f, 12, 36}, {0.228352f, 14, 48}, {0.226259f, 15, 62},
    {0.222371f, 17, 77}, {0.220410f, 18, 94}, {0.214710f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204}, {0.199245f, 29, 231},
    {0.195525f, 31, 260}, {0.193560f, 32, 291}, {0.189878f, 34, 323}, {0.186216f, 36, 357},
    {0.186216f, 36, 393}, {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637}, {0.168612f, 46, 683},
    {0.163575f, 49, 729}, {0.158642f, 52, 778}, {0.158642f, 52, 830}, {0.158642f, 52, 882},
    {0.153815f, 55, 934}, {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284}, {0.138270f, 65, 1346},
    {0.138270f, 65, 1411}, {0.138270f, 65, 1476}, {0.132166f, 69, 1541}, {0.132166f, 69, 1610},
    {0.126204f, 73, 1679}, {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129}, {0.112962f, 82, 2206},
    {0.112962f, 82, 2288}, {0.112962f, 82, 2370}, {0.107450f, 86, 2452}, {0.107450f, 86, 2538},
    {0.107450f, 86, 2624}, {0.107450f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164}, {0.095126f, 95, 3259},
    {0.095126f, 95, 3354}, {0.088276f, 100, 3449}, {0.088276f, 100, 3549}, {0.088276f, 100, 3649},
    {0.088276f, 100, 3749}, {0.081523f, 105, 3849}, {0.081523f, 105, 3954}, {0.081523f, 105, 4059},
    {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379}, {0.074861f, 110, 4489},
    {0.074861f, 110, 4599}, {0.068290f, 115, 4709}, {0.068290f, 115, 4824}, {0.068290f, 115, 4939},
    {0.068290f, 115, 5054}, {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407},
    {0.063573f, 119, 5526}, {0.057219f, 124, 5645}, {0.057219f, 124, 5769}, {0.057219f, 124, 5893},
    {0.057219f, 124, 6017}, {0.050985f, 129, 6141}, {0.050985f, 129, 6270}, {0.050985f, 129, 6399},
    {0.050985f, 129, 6528}, {0.050985f, 129, 6657}, {0.044859f, 134, 6786}, {0.044859f, 134, 6920},
    {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322}, {0.040571f, 138, 7460},
    {0.040571f, 138, 7598}, {0.040571f, 138, 7736}, {0.036339f, 142, 7874}, {0.036339f, 142, 8016},
    {0.036339f, 142, 8158}, {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588},
    {0.032139f, 146, 8734}, {0.032139f, 146, 8880}, {0.027947f, 150, 9026}, {0.027947f, 150, 9176},
    {0.027947f, 150, 9326}, {0.023739f, 154, 9476}, {0.023739f, 154, 9630}, {0.023739f, 154, 9784},
    {0.023739f, 154, 9938}, {0.019504f, 158, 10092}, {0.019504f, 158, 10250},
    {0.019504f, 158, 10408}, {0.016976f, 161, 10566}, {0.016976f, 161, 10727},
    {0.016976f, 161, 10888}, {0.016976f, 161, 11049}, {0.012639f, 165, 11210},
    {0.012639f, 165, 11375}, {0.012639f, 165, 11540}, {0.009991f, 168, 11705},
    {0.009991f, 168, 11873}, {0.009991f, 168, 12041}, {0.009016f, 170, 12209},
    {0.009016f, 170, 12379}, {0.009016f, 170, 12549}, {0.006217f, 173, 12719},
    {0.006217f, 173, 12892}, {0.005097f, 175, 13065}, {0.005097f, 175, 13240},
    {0.005097f, 175, 13415}, {0.003909f, 177, 13590}, {0.003909f, 177, 13767},
    {0.002340f, 177, 13944}, {0.002389f, 170, 14121}, {0.001068f, 164, 14291},
    {0.001653f, 157, 14455}, {0.000717f, 150, 14612}, {0.001614f, 143, 14762},
    {0.000270f, 136, 14905}, {0.000484f, 129, 15041}, {0.001103f, 123, 15170},
    {0.001242f, 115, 15293}, {0.001188f, 109, 15408}, {0.001011f, 103, 15517},
    {0.000709f, 97, 15620}, {0.000301f, 89, 15717}, {0.002416f, 82, 15806}, {0.003251f, 76, 15888},
    {0.003246f, 69, 15964}, {0.004141f, 62, 16033}, {0.005963f, 55, 16095}, {0.008839f, 47, 16150},
    {0.010490f, 40, 16197}, {0.016994f, 31, 16237}, {0.023659f, 21, 16268}
};

double logl16_to_y(int p16) {
  const int le = p16 & 0x7fff;
  if (!le) return 0.;
  const double y = std::exp(kLn2 / 256. * (le + .5) - kLn2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

double logl10_to_y(int p10) {
  if (p10 == 0) return 0.;
  return std::exp(kLn2 / 64. * (p10 + .5) - kLn2 * 12.);
}

bool uv_decode(double* up, double* vp, int c) {
  if (c < 0 || c >= kUvNdivs) return false;
  int lower = 0, upper = kUvNvs;
  while (upper - lower > 1) {
    const int vi = (lower + upper) >> 1;
    const int ui = c - kUvRow[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  const int vi = lower, ui = c - kUvRow[vi].ncum;
  *up = kUvRow[vi].ustart + (ui + .5) * kUvSqsiz;
  *vp = kUvVstart + (vi + .5) * kUvSqsiz;
  return true;
}

void uv_l_to_xyz(double u, double v, double l, float* xyz) {
  const double s = 1. / (6. * u - 16. * v + 12.);
  const double x = 9. * u * s, y = 4. * v * s;
  xyz[0] = (float)(x / y * l);
  xyz[1] = (float)l;
  xyz[2] = (float)((1. - x - y) / y * l);
}

void logluv32_to_xyz(uint32_t p, float* xyz) {
  const double l = logl16_to_y((int)p >> 16);
  if (l <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  uv_l_to_xyz(1. / kUvScale * ((p >> 8 & 0xff) + .5), 1. / kUvScale * ((p & 0xff) + .5), l, xyz);
}

void logluv24_to_xyz(uint32_t p, float* xyz) {
  const double l = logl10_to_y(p >> 14 & 0x3ff);
  if (l <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  double u, v;
  if (!uv_decode(&u, &v, (int)(p & 0x3fff))) {
    u = kUNeu;
    v = kVNeu;
  }
  uv_l_to_xyz(u, v, l, xyz);
}

uint8_t gamma2_byte(double c) {
  return (uint8_t)((c <= 0.) ? 0 : (c >= 1.) ? 255 : (int)(256. * std::sqrt(c)));
}

// XYZtoRGB24: CCIR-709 primaries and a 2.0 gamma, in double.
void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {
  const double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  const double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  const double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma2_byte(r);
  rgb[1] = gamma2_byte(g);
  rgb[2] = gamma2_byte(b);
}

// One row's byte planes (most significant first) of SGILog's run-length
// code, OR-ed into ``tp`` (LogL16Decode, LogLuvDecode32): a byte of 128 or
// more repeats the next byte (it minus 126) times, a smaller one copies
// that many bytes. False where the data ends before the row does.
template <typename T>
bool sgilog_planes(const uint8_t* data, int64_t len, int64_t* pos, T* tp, int64_t npixels,
                   int nbytes) {
  std::fill(tp, tp + npixels, (T)0);
  const uint8_t* bp = data + *pos;
  int64_t cc = len - *pos;
  for (int shft = 8 * (nbytes - 1); shft >= 0; shft -= 8) {
    int64_t i = 0;
    while (i < npixels && cc > 0) {
      if (*bp >= 128) {
        if (cc < 2) break;
        int rc = *bp++ + (2 - 128);
        const T b = (T)((T)*bp++ << shft);
        cc -= 2;
        while (rc-- && i < npixels) tp[i++] |= b;
      } else {
        int rc = *bp++;
        while (--cc && rc-- && i < npixels) tp[i++] |= (T)((T)*bp++ << shft);
      }
    }
    if (i != npixels) {
      *pos = bp - data;
      return false;
    }
  }
  *pos = bp - data;
  return true;
}

// ---------------------------------------------------------------- ThunderScan (tif_thunder.c)
// One row of 4-bit pixels as ThunderDecode writes it (its ``op`` and
// nibble order); false where the codes end short of ``maxpixels`` or
// overrun it, the rest of the row from its last byte written zeroed.
bool thunder_row(const uint8_t* data, int64_t len, int64_t* pos, uint8_t* row, int64_t maxpixels) {
  uint8_t* op = row;
  static const int kTwoBit[4] = {0, 1, 0, -1};
  static const int kThreeBit[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const uint8_t* bp = data + *pos;
  int64_t cc = len - *pos;
  unsigned lastpixel = 0;
  int64_t npixels = 0;
  auto setpixel = [&](unsigned v) {
    lastpixel = v & 0xf;
    if (npixels < maxpixels) {
      if (npixels++ & 1)
        *op++ |= (uint8_t)lastpixel;
      else
        op[0] = (uint8_t)(lastpixel << 4);
    }
  };
  while (cc > 0 && npixels < maxpixels) {
    int n = *bp++, delta;
    cc--;
    switch (n & 0xc0) {
      case 0x00:                      // a run of the last pixel
        if (npixels & 1) {
          op[0] |= (uint8_t)lastpixel;
          lastpixel = *op++;
          npixels++;
          n--;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        if (npixels <= maxpixels) {
          for (; n > 0; n -= 2) *op++ = (uint8_t)lastpixel;
        }
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      case 0x40:                      // three 2-bit deltas, 2 skips
        if ((delta = (n >> 4) & 3) != 2) setpixel((unsigned)((int)lastpixel + kTwoBit[delta]));
        if ((delta = (n >> 2) & 3) != 2) setpixel((unsigned)((int)lastpixel + kTwoBit[delta]));
        if ((delta = n & 3) != 2) setpixel((unsigned)((int)lastpixel + kTwoBit[delta]));
        break;
      case 0x80:                      // two 3-bit deltas, 4 skips
        if ((delta = (n >> 3) & 7) != 4) setpixel((unsigned)((int)lastpixel + kThreeBit[delta]));
        if ((delta = n & 7) != 4) setpixel((unsigned)((int)lastpixel + kThreeBit[delta]));
        break;
      default:                        // a raw pixel
        setpixel((unsigned)n);
        break;
    }
  }
  *pos = bp - data;
  if (npixels != maxpixels) {
    uint8_t* const end = row + (maxpixels + 1) / 2;
    if (op < end) std::memset(op, 0, (size_t)(end - op));
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// PNG rows: ``raw`` holds h rows of a filter byte and ``stride`` bytes;
// ``out`` receives the h * stride reconstructed bytes; ``bpp`` is the
// filter's byte distance (bytes per pixel, at least 1).
int dg_png_unfilter(const uint8_t* raw, int32_t h, int64_t stride, int32_t bpp, uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + (size_t)y * (stride + 1);
    const int kind = in[0];
    ++in;
    uint8_t* cur = out + (size_t)y * stride;
    const uint8_t* prev = y > 0 ? cur - stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? cur[x - bpp] : 0;
      const int b = prev ? prev[x] : 0;
      const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return 1;
      }
      cur[x] = (uint8_t)(in[x] + pred);
    }
  }
  return 0;
}

// GIF LZW: ``data`` is an image's sub-blocks joined; ``out`` receives up to
// ``n_out`` indices (the rest left as they are); ``*n_done`` the count.
int dg_gif_lzw(const uint8_t* data, int64_t len, int32_t min_code, uint8_t* out, int64_t n_out,
               int64_t* n_done) {
  if (min_code < 1 || min_code > 11) return 1;
  const int clear = 1 << min_code, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  for (int i = 0; i < clear; ++i) {
    prefix[i] = 0xffff;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int width = min_code + 1, next = eoi + 1, prev = -1;
  uint64_t acc = 0;
  int nb = 0;
  int64_t pos = 0, o = 0;
  while (o < n_out) {
    while (nb < width && pos < len) {
      acc |= (uint64_t)data[pos++] << nb;
      nb += 8;
    }
    if (nb < width) break;
    const int code = (int)(acc & ((1u << width) - 1));
    acc >>= width;
    nb -= width;
    if (code == clear) {
      width = min_code + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int entry;
    if (prev < 0) {
      if (code >= clear) return 2;
      entry = code;
    } else {
      if (code > next || (code == next && next >= 4096)) return 2;
      const int base = code < next ? code : prev;
      if (next < 4096) {
        prefix[next] = (uint16_t)prev;
        suffix[next] = first[base];
        first[next] = first[prev];
        length[next] = (uint16_t)(length[prev] + 1);
        ++next;
        if (next == (1 << width) && width < 12) ++width;
      }
      entry = code;
    }
    int n = 0;
    for (int e = entry; e != 0xffff && n <= 4096; e = prefix[e]) stack[n++] = suffix[e];
    while (n > 0 && o < n_out) out[o++] = stack[--n];
    prev = code;
  }
  *n_done = o;
  return 0;
}

// A VP8L image stream (after the 5-byte VP8L header, or an ALPH chunk's
// lossless payload) of w x h pixels into ``argb`` (w * h words).
int dg_webp_vp8l(const uint8_t* data, int64_t len, int32_t w, int32_t h, uint32_t* argb) {
  VP8LDec dec(data, len);
  std::vector<uint32_t> out;
  if (!dec.decode_stream(w, h, true, &out)) return 1;
  if (out.size() != (size_t)w * h) return 2;
  std::memcpy(argb, out.data(), out.size() * sizeof(uint32_t));
  return 0;
}

// A VP8 key frame (the VP8 chunk's payload) of w x h pixels into ``out``:
// RGB in the first three of every ``channels`` bytes.
int dg_webp_vp8(const uint8_t* data, int64_t len, int32_t w, int32_t h, uint8_t* out,
                int32_t channels) {
  return vp8_decode(data, (size_t)len, w, h, out, channels);
}

// An ALPH plane (w x h bytes) unfiltered in place: method 1 horizontal, 2
// vertical, 3 gradient.
int dg_webp_alpha_unfilter(uint8_t* a, int32_t w, int32_t h, int32_t method) {
  if (method < 1 || method > 3) return 1;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = a + (size_t)y * w;
    const uint8_t* prev = y > 0 ? row - w : nullptr;
    if (!prev || method == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = (uint8_t)(pred + row[x]);
    } else if (method == 2) {
      for (int x = 0; x < w; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        left = (uint8_t)(row[x] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        row[x] = left;
      }
    }
  }
  return 0;
}

// A TIFF strip or tile decompressed into ``out`` (``cap`` bytes, the rest
// left as it is): ``compression`` 5 LZW, 32773 PackBits, or CCITT 2, 3, 4,
// 32771 (then ``width`` x ``rows`` bits, ``options`` bit 0 T.4's 2-D coding,
// bit 1 FillOrder 2, bit 2 an odd offset of the data in the file).
// ``*n_done`` receives the bytes (LZW, PackBits) or rows (CCITT) decoded.
int dg_tiff_decompress(const uint8_t* data, int64_t len, int32_t compression, uint8_t* out,
                       int64_t cap, int32_t width, int32_t rows, int32_t options,
                       int64_t* n_done) {
  if (compression == 5) {
    *n_done = tiff_lzw(data, len, out, cap);
    return *n_done < 0 ? 1 : 0;
  }
  if (compression == 32773) {
    *n_done = tiff_packbits(data, len, out, cap);
    return 0;
  }
  if (compression == 32809) {       // ThunderScan: rows of ``options`` bytes, ``width`` pixels
    if (options <= 0 || cap % options) return 4;
    int64_t pos = 0;
    *n_done = 0;
    for (int64_t at = 0; at < cap; at += options) {
      if (!thunder_row(data, len, &pos, out + at, width)) return 4;
      *n_done = at + options;
    }
    return 0;
  }
  if (compression == 2 || compression == 3 || compression == 4 || compression == 32771) {
    if ((int64_t)(width + 7) / 8 * rows > cap) return 2;
    *n_done = fax_decode(data, len, compression, (options & 1) != 0, (options & 2) == 0,
                         (options & 4) != 0, width, rows, out);
    return 0;
  }
  return 3;
}

// TIFF's predictors undone in place over ``rows`` rows of ``row_bytes``
// bytes: 2 horizontal differences of ``bits``-bit samples (8, 16, 32, 64;
// native byte order) ``stride`` samples apart; 3 the floating-point
// predictor (libtiff's fpAcc): each row's bytes summed ``stride`` apart,
// then gathered from byte planes (most significant first) into
// little-endian samples of ``bits`` / 8 bytes.
int dg_tiff_unpredict(uint8_t* buf, int64_t rows, int64_t row_bytes, int32_t predictor,
                      int32_t bits, int32_t stride) {
  const int bytes = bits / 8;
  if (bytes < 1 || row_bytes % ((int64_t)bytes * stride) != 0) return 1;
  std::vector<uint8_t> tmp(predictor == 3 ? (size_t)row_bytes : 0);
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = buf + y * row_bytes;
    if (predictor == 2) {
      switch (bits) {
        case 8: horizontal_acc<uint8_t>(row, row_bytes, stride); break;
        case 16: horizontal_acc<uint16_t>(row, row_bytes, stride); break;
        case 32: horizontal_acc<uint32_t>(row, row_bytes, stride); break;
        case 64: horizontal_acc<uint64_t>(row, row_bytes, stride); break;
        default: return 2;
      }
    } else if (predictor == 3) {
      for (int64_t i = stride; i < row_bytes; ++i) row[i] = (uint8_t)(row[i] + row[i - stride]);
      std::memcpy(tmp.data(), row, (size_t)row_bytes);
      const int64_t wc = row_bytes / bytes;
      for (int64_t c = 0; c < wc; ++c)
        for (int b = 0; b < bytes; ++b) row[bytes * c + b] = tmp[(bytes - b - 1) * wc + c];
    } else {
      return 3;
    }
  }
  return 0;
}

// A Radiance HDR's pixels after its header, as OpenCV's RGBE_ReadPixels_RLE
// reads them into ``rgb`` (h x w x 3 float32, red first): new-style RLE
// scanlines (2, 2, then the width; each channel's runs of 129 to 255 or
// literals of 1 to 128), flat pixels for widths outside 8..32767, and flat
// pixels from the first scanline that does not start with 2, 2 on. Returns
// 1 where the data ends short, 2 for a scanline of another width, 3 for a
// run or literal that overruns its channel (cv2 returns None for each).
int dg_hdr_decode(const uint8_t* data, int64_t len, int32_t w, int32_t h, float* rgb) {
  int64_t pos = 0;
  if (w < 8 || w > 0x7fff) return rgbe_flat(data, len, &pos, rgb, (int64_t)w * h) ? 0 : 1;
  std::vector<uint8_t> line((size_t)4 * w);
  for (int32_t left = h; left > 0; --left) {
    if (len - pos < 4) return 1;
    const uint8_t* p = data + pos;
    pos += 4;
    if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) {
      rgbe_to_float(p, rgb);
      return rgbe_flat(data, len, &pos, rgb + 3, (int64_t)w * left - 1) ? 0 : 1;
    }
    if (((int)p[2] << 8 | p[3]) != w) return 2;
    uint8_t* ptr = line.data();
    for (int i = 0; i < 4; ++i) {
      uint8_t* const end = line.data() + (size_t)(i + 1) * w;
      while (ptr < end) {
        if (len - pos < 2) return 1;
        const int head = data[pos], value = data[pos + 1];
        pos += 2;
        if (head > 128) {
          const int count = head - 128;
          if (count == 0 || count > end - ptr) return 3;
          std::memset(ptr, value, (size_t)count);
          ptr += count;
        } else {
          int count = head;
          if (count == 0 || count > end - ptr) return 3;
          *ptr++ = (uint8_t)value;
          if (--count > 0) {
            if (len - pos < count) return 1;
            std::memcpy(ptr, data + pos, (size_t)count);
            ptr += count;
            pos += count;
          }
        }
      }
    }
    for (int32_t x = 0; x < w; ++x, rgb += 3) {
      const uint8_t px[4] = {line[x], line[x + w], line[x + 2 * w], line[x + 3 * w]};
      rgbe_to_float(px, rgb);
    }
  }
  return 0;
}

// A TIFF strip or tile of SGILog data decoded row by row as libtiff's
// LogLuvDecodeStrip / LogLuvDecodeTile do, each row ``width`` pixels:
// ``mode`` 0 LogL16 (photometric LogL), 1 LogLuv32 (SGILog), 2 LogLuv24
// (SGILog24). ``fmt`` 0: SGILOGDATAFMT_FLOAT (float32 X, Y, Z per pixel;
// LogL not taken); 1: SGILOGDATAFMT_8BIT (LogLuv as XYZtoRGB24's uint8
// R, G, B; LogL as L16toGry's uint8 grey). Decoding stops at the first
// row whose data ends short, as libtiff's does: ``*rows_done`` receives
// the rows written (the rest of ``out`` left as it is); returns 1 then.
int dg_sgilog_decode(const uint8_t* data, int64_t len, int32_t mode, int32_t fmt, int32_t width,
                     int32_t rows, void* out, int32_t* rows_done) {
  int64_t pos = 0;
  std::vector<uint32_t> luv((size_t)width);
  std::vector<int16_t> l16((size_t)width);
  *rows_done = 0;
  if (mode == 0 && fmt != 1) return 2;
  for (int32_t y = 0; y < rows; ++y) {
    if (mode == 0) {
      if (!sgilog_planes<int16_t>(data, len, &pos, l16.data(), width, 2)) return 1;
      uint8_t* grey = (uint8_t*)out + (size_t)y * width;
      for (int32_t i = 0; i < width; ++i) grey[i] = gamma2_byte(logl16_to_y(l16[i]));
    } else {
      if (mode == 1) {
        if (!sgilog_planes<uint32_t>(data, len, &pos, luv.data(), width, 4)) return 1;
      } else {
        int32_t i = 0;
        for (; i < width && len - pos >= 3; ++i, pos += 3)
          luv[i] = (uint32_t)data[pos] << 16 | (uint32_t)data[pos + 1] << 8 | data[pos + 2];
        if (i != width) return 1;
      }
      for (int32_t i = 0; i < width; ++i) {
        float xyz[3];
        if (mode == 1)
          logluv32_to_xyz(luv[i], xyz);
        else
          logluv24_to_xyz(luv[i], xyz);
        const size_t at = ((size_t)y * width + i) * 3;
        if (fmt == 0)
          std::memcpy((float*)out + at, xyz, sizeof xyz);
        else
          xyz_to_rgb24(xyz, (uint8_t*)out + at);
      }
    }
    *rows_done = y + 1;
  }
  return 0;
}

// OpenCV's cvtColor(COLOR_XYZ2BGR) on float32, in place over h rows of w
// pixels and written in R, G, B order: per row, the first multiple of four
// pixels as its 4-lane vector code sums them (X*c0 + (Y*c1 + Z*c2)), the
// rest as its scalar tail does ((X*c0 + Y*c1) + Z*c2); no fused
// multiply-add (this file is built with -ffp-contract=off).
void dg_xyz_to_rgb(float* img, int32_t h, int32_t w) {
  static const float kC[9] = {3.240479f, -1.53715f, -0.498535f, -0.969256f, 1.875991f,
                              0.041556f, 0.055648f, -0.204043f, 1.057311f};
  const int32_t vec = w / 4 * 4;
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      float* p = img + ((size_t)y * w + x) * 3;
      const float X = p[0], Y = p[1], Z = p[2];
      for (int c = 0; c < 3; ++c) {
        const float* k = kC + 3 * c;
        p[c] = x < vec ? X * k[0] + (Y * k[1] + Z * k[2]) : (X * k[0] + Y * k[1]) + Z * k[2];
      }
    }
  }
}

}  // extern "C"
