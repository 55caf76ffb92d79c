/* Keccak-f[1600] permutation, C implementation.
 *
 * Native host-side component backing the STROBE-128/Merlin transcript
 * (the reference delegates this to jsign/merlin + x/crypto, which wrap
 * optimized Go/asm keccak). Loaded from Python via ctypes.
 *
 * Built by go_curdleproofs_tpu_torch/utils/native.py with the host cc into
 * _build/libcurdle_host.so. Copied from go_curdleproofs_tpu/native/keccak.c.
 */

#include <stdint.h>
#include <string.h>

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

/* state: 200 bytes = 25 little-endian u64 lanes, lane index x + 5*y */
void keccak_f1600(unsigned char *state) {
  uint64_t a[25];
  memcpy(a, state, 200); /* little-endian host assumed (x86_64/aarch64) */

  for (int round = 0; round < 24; round++) {
    uint64_t c[5], d[5], b[25];
    /* theta */
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ ROTL64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
    /* rho + pi */
    static const int rot[5][5] = {{0, 36, 3, 41, 18},
                                  {1, 44, 10, 45, 2},
                                  {62, 6, 43, 15, 61},
                                  {28, 55, 25, 21, 56},
                                  {27, 20, 39, 8, 14}};
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) {
        int r = rot[x][y];
        uint64_t v = a[x + 5 * y];
        b[y + 5 * ((2 * x + 3 * y) % 5)] = r ? ROTL64(v, r) : v;
      }
    /* chi */
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x + 5 * y] =
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    /* iota */
    a[0] ^= RC[round];
  }
  memcpy(state, a, 200);
}
