/* LZF codec for PCD binary_compressed bodies: host C, built at first use by
 * pcl_tpu_torch/ops/_build.py (host_library) and called through ctypes from
 * pcl_tpu_torch/io/lzf.py. The format: a control byte c < 32 starts a literal
 * run of c + 1 bytes; otherwise a back-reference of length (c >> 5) + 2 (a
 * length field of 7 takes an extension byte) at offset ((c & 0x1f) << 8) |
 * next byte, counted back from the output position less one. */
#include <stdint.h>
#include <string.h>

/* LZF decompression: returns bytes written, or 0 on malformed input. */
long lzf_decompress(const uint8_t *in, long in_len, uint8_t *out, long out_len) {
    const uint8_t *ip = in, *in_end = in + in_len;
    uint8_t *op = out, *out_end = out + out_len;
    while (ip < in_end) {
        unsigned int ctrl = *ip++;
        if (ctrl < 32) {                      /* literal run */
            ctrl++;
            if (op + ctrl > out_end || ip + ctrl > in_end) return 0;
            memcpy(op, ip, ctrl);
            op += ctrl; ip += ctrl;
        } else {                              /* back reference */
            unsigned int len = ctrl >> 5;
            const uint8_t *ref;
            if (ip >= in_end) return 0;
            if (len == 7) { len += *ip++; if (ip >= in_end) return 0; }
            ref = op - ((ctrl & 0x1f) << 8) - 1 - *ip++;
            len += 2;
            if (op + len > out_end || ref < out) return 0;
            /* overlapping copy must be byte-wise */
            while (len--) *op++ = *ref++;
        }
    }
    return (long)(op - out);
}

#define HLOG 14
#define HSIZE (1 << HLOG)
#define MAX_LIT (1 << 5)
#define MAX_OFF (1 << 13)
#define MAX_REF ((1 << 8) + (1 << 3))

static unsigned int first(const uint8_t *p) { return (p[0] << 8) | p[1]; }
static unsigned int next_h(unsigned int v, const uint8_t *p) { return (v << 8) | p[2]; }
static unsigned int idx(unsigned int h) {
    return (((h >> (3*8 - HLOG)) - h*5) & (HSIZE - 1));
}

/* LZF compression: returns compressed size, or 0 if output would not fit. */
long lzf_compress(const uint8_t *in, long in_len, uint8_t *out, long out_len) {
    const uint8_t *htab[HSIZE];
    const uint8_t *ip = in, *in_end = in + in_len;
    uint8_t *op = out, *out_end = out + out_len;
    unsigned int hval;
    long lit = 0;
    memset(htab, 0, sizeof(htab));
    if (in_len < 3) goto tail;
    hval = first(ip);
    while (ip + 2 < in_end) {
        unsigned int h;
        const uint8_t *ref;
        hval = next_h(hval, ip);
        h = idx(hval);
        ref = htab[h];
        htab[h] = ip;
        long off;
        if (ref && (off = ip - ref - 1) < MAX_OFF && ref >= in
            && ref[0] == ip[0] && ref[1] == ip[1] && ref[2] == ip[2]) {
            /* match: first flush literals. Minimum emitted length is 3
             * (ref[0..2]==ip[0..2] just verified): the format stores
             * len-2 in a 3-bit field whose value 0 would alias into a
             * LITERAL control byte — a "length-2 match" is unencodable
             * and silently corrupted the stream near buffer ends. */
            long len = 3;
            long maxlen = in_end - ip;
            if (maxlen > MAX_REF) maxlen = MAX_REF;
            while (len < maxlen && ref[len] == ip[len]) len++;
            if (op + lit + 1 + 3 >= out_end) return 0;
            if (lit) { *op++ = (uint8_t)(lit - 1); memcpy(op, ip - lit, lit); op += lit; lit = 0; }
            len -= 2;
            if (len < 7) {
                *op++ = (uint8_t)((off >> 8) + (len << 5));
            } else {
                *op++ = (uint8_t)((off >> 8) + (7 << 5));
                *op++ = (uint8_t)(len - 7);
            }
            *op++ = (uint8_t)off;
            ip += len + 2;
            if (ip + 2 < in_end) {
                hval = first(ip);
            }
            continue;
        }
        lit++;
        ip++;
        if (lit == MAX_LIT) {
            if (op + 1 + MAX_LIT >= out_end) return 0;
            *op++ = MAX_LIT - 1;
            memcpy(op, ip - lit, lit); op += lit; lit = 0;
        }
    }
tail:
    while (ip < in_end) {
        lit++; ip++;
        if (lit == MAX_LIT) {
            if (op + 1 + MAX_LIT >= out_end) return 0;
            *op++ = MAX_LIT - 1;
            memcpy(op, ip - lit, lit); op += lit; lit = 0;
        }
    }
    if (lit) {
        if (op + lit + 1 >= out_end) return 0;
        *op++ = (uint8_t)(lit - 1);
        memcpy(op, ip - lit, lit); op += lit;
    }
    return (long)(op - out);
}
