/* crc32c (Castagnoli, iSCSI polynomial) — the checksum Ceph uses for
 * shard hashes (ceph_crc32c semantics: caller-supplied running crc, no
 * implicit init/final inversion).  Slicing-by-8 software implementation;
 * built on demand by ceph_tpu_torch.native (ops/_build.py, host cc) and
 * loaded via ctypes.
 */

#include <stddef.h>
#include <stdint.h>

static uint32_t T[8][256];
static int initialized = 0;

static uint32_t reflect32(uint32_t v) {
    uint32_t r = 0;
    for (int i = 0; i < 32; i++)
        if (v & (1u << i))
            r |= 1u << (31 - i);
    return r;
}

static uint32_t reflect8(uint32_t v) {
    uint32_t r = 0;
    for (int i = 0; i < 8; i++)
        if (v & (1u << i))
            r |= 1u << (7 - i);
    return r;
}

static void init_tables(void) {
    const uint32_t P = 0x1EDC6F41u;
    for (int i = 0; i < 256; i++) {
        uint32_t c = reflect8((uint32_t)i) << 24;
        for (int j = 0; j < 8; j++)
            c = (c & 0x80000000u) ? (c << 1) ^ P : (c << 1);
        T[0][i] = reflect32(c);
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = T[0][i];
        for (int s = 1; s < 8; s++) {
            c = (c >> 8) ^ T[0][c & 0xff];
            T[s][i] = c;
        }
    }
    initialized = 1;
}

uint32_t ceph_crc32c(uint32_t crc, const unsigned char *data, size_t len) {
    if (!initialized)
        init_tables();
    while (len && ((uintptr_t)data & 7)) {
        crc = (crc >> 8) ^ T[0][(crc ^ *data++) & 0xff];
        len--;
    }
    while (len >= 8) {
        uint32_t lo = crc ^ ((uint32_t)data[0] | ((uint32_t)data[1] << 8) |
                            ((uint32_t)data[2] << 16) |
                            ((uint32_t)data[3] << 24));
        uint32_t hi = (uint32_t)data[4] | ((uint32_t)data[5] << 8) |
                      ((uint32_t)data[6] << 16) | ((uint32_t)data[7] << 24);
        crc = T[7][lo & 0xff] ^ T[6][(lo >> 8) & 0xff] ^
              T[5][(lo >> 16) & 0xff] ^ T[4][lo >> 24] ^
              T[3][hi & 0xff] ^ T[2][(hi >> 8) & 0xff] ^
              T[1][(hi >> 16) & 0xff] ^ T[0][hi >> 24];
        data += 8;
        len -= 8;
    }
    while (len--) {
        crc = (crc >> 8) ^ T[0][(crc ^ *data++) & 0xff];
    }
    return crc;
}
