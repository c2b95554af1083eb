/* The subset of libdeflate's C ABI that manta_tpu's native core links
 * (native/manta_core.cpp: mt_bgzf_inflate_batch, mt_bgzf_deflate_batch),
 * implemented over zlib.
 *
 * The native core is linked against libdeflate.so.0. On a host without
 * that library, manta_tpu_torch.native_core builds this file into a
 * library with the soname libdeflate.so.0 and loads it before the core,
 * so the dynamic loader resolves the core's dependency to it. Raw
 * deflate in and out: the inflated bytes are the same; compressed bytes
 * may differ from libdeflate's, which no reader depends on.
 *
 * zlib's header is not needed to build this file: the few declarations
 * used are written out below (zlib's stable 1.x ABI).
 */

#include <limits.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

typedef struct {
    const unsigned char* next_in;
    unsigned avail_in;
    unsigned long total_in;
    unsigned char* next_out;
    unsigned avail_out;
    unsigned long total_out;
    const char* msg;
    void* state;
    void* zalloc;
    void* zfree;
    void* opaque;
    int data_type;
    unsigned long adler;
    unsigned long reserved;
} z_stream;

int inflateInit2_(z_stream* s, int window_bits, const char* version,
                  int stream_size);
int inflate(z_stream* s, int flush);
int inflateReset(z_stream* s);
int inflateEnd(z_stream* s);
int deflateInit2_(z_stream* s, int level, int method, int window_bits,
                  int mem_level, int strategy, const char* version,
                  int stream_size);
int deflate(z_stream* s, int flush);
int deflateReset(z_stream* s);
int deflateEnd(z_stream* s);
unsigned long crc32(unsigned long crc, const unsigned char* buf,
                    unsigned len);

enum { Z_OK = 0, Z_STREAM_END = 1, Z_BUF_ERROR = -5, Z_FINISH = 4,
       Z_DEFLATED = 8, Z_RAW_WINDOW = -15, Z_MEM_LEVEL = 8 };
static const char kZlibVersion[] = "1.2.11";  /* only the major is checked */

/* libdeflate_result */
enum { LD_SUCCESS = 0, LD_BAD_DATA = 1, LD_SHORT_OUTPUT = 2,
       LD_INSUFFICIENT_SPACE = 3 };

struct libdeflate_decompressor { z_stream s; };
struct libdeflate_compressor { z_stream s; };

struct libdeflate_decompressor* libdeflate_alloc_decompressor(void) {
    struct libdeflate_decompressor* d = calloc(1, sizeof(*d));
    if (d && inflateInit2_(&d->s, Z_RAW_WINDOW, kZlibVersion,
                           (int)sizeof(z_stream)) != Z_OK) {
        free(d);
        return NULL;
    }
    return d;
}

void libdeflate_free_decompressor(struct libdeflate_decompressor* d) {
    if (!d) return;
    inflateEnd(&d->s);
    free(d);
}

int libdeflate_deflate_decompress(struct libdeflate_decompressor* d,
                                  const void* in, size_t in_nbytes,
                                  void* out, size_t out_nbytes_avail,
                                  size_t* actual_out_nbytes_ret) {
    if (in_nbytes > UINT_MAX || out_nbytes_avail > UINT_MAX)
        return LD_BAD_DATA;
    if (inflateReset(&d->s) != Z_OK) return LD_BAD_DATA;
    d->s.next_in = in;
    d->s.avail_in = (unsigned)in_nbytes;
    d->s.next_out = out;
    d->s.avail_out = (unsigned)out_nbytes_avail;
    const int rc = inflate(&d->s, Z_FINISH);
    if (rc != Z_STREAM_END)
        return (rc == Z_BUF_ERROR || rc == Z_OK) && d->s.avail_out == 0
            ? LD_INSUFFICIENT_SPACE : LD_BAD_DATA;
    const size_t got = out_nbytes_avail - d->s.avail_out;
    if (actual_out_nbytes_ret) {
        *actual_out_nbytes_ret = got;
        return LD_SUCCESS;
    }
    return got == out_nbytes_avail ? LD_SUCCESS : LD_SHORT_OUTPUT;
}

struct libdeflate_compressor* libdeflate_alloc_compressor(int level) {
    if (level < 0 || level > 12) return NULL;
    struct libdeflate_compressor* c = calloc(1, sizeof(*c));
    /* libdeflate's levels run to 12, zlib's to 9 */
    if (c && deflateInit2_(&c->s, level > 9 ? 9 : level, Z_DEFLATED,
                           Z_RAW_WINDOW, Z_MEM_LEVEL, 0, kZlibVersion,
                           (int)sizeof(z_stream)) != Z_OK) {
        free(c);
        return NULL;
    }
    return c;
}

void libdeflate_free_compressor(struct libdeflate_compressor* c) {
    if (!c) return;
    deflateEnd(&c->s);
    free(c);
}

/* Returns the compressed size, or 0 if it does not fit. */
size_t libdeflate_deflate_compress(struct libdeflate_compressor* c,
                                   const void* in, size_t in_nbytes,
                                   void* out, size_t out_nbytes_avail) {
    if (in_nbytes > UINT_MAX) return 0;
    if (out_nbytes_avail > UINT_MAX) out_nbytes_avail = UINT_MAX;
    if (deflateReset(&c->s) != Z_OK) return 0;
    c->s.next_in = in;
    c->s.avail_in = (unsigned)in_nbytes;
    c->s.next_out = out;
    c->s.avail_out = (unsigned)out_nbytes_avail;
    if (deflate(&c->s, Z_FINISH) != Z_STREAM_END) return 0;
    return out_nbytes_avail - c->s.avail_out;
}

uint32_t libdeflate_crc32(uint32_t crc, const void* buf, size_t len) {
    const unsigned char* p = buf;
    unsigned long v = crc;
    while (len > 0) {
        const unsigned n = len > (1u << 30) ? (1u << 30) : (unsigned)len;
        v = crc32(v, p, n);
        p += n;
        len -= n;
    }
    return (uint32_t)v;
}
