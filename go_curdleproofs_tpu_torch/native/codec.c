/* BLS12-381 G1 point codec — native host-side implementation.
 *
 * The host equivalent of gnark-crypto's assembly-backed SetBytes/Bytes
 * (ZCash 48-byte compressed format; whisk/types.go:74-107 of the Go reference):
 * Montgomery 6x64-limb Fp arithmetic with __int128, windowed exponentiation
 * for the decompression sqrt, and a Jacobian double-and-add subgroup check.
 * The device path (ops/codec_batch.py) batches these on the card; this C
 * path serves single-point host decoding and the host group operations.
 * Loaded via ctypes. Copied from go_curdleproofs_tpu/native/codec.c.
 *
 * API (all big-endian byte buffers):
 *   g1_decompress(in[48], x_out[48], y_out[48]) -> 0 ok, 1 infinity, <0 error
 *   g1_compress(x[48], y[48], out[48])          -> 0
 *   g1_subgroup_check(x[48], y[48])             -> 1 in subgroup, 0 not, <0 err
 */

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

/* p, little-endian limbs */
static const u64 P[6] = {0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL,
                         0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                         0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
/* -p^-1 mod 2^64 */
static const u64 PINV = 0x89f3fffcfffcfffdULL;
/* R^2 mod p (R = 2^384), for to-Montgomery conversion */
static const u64 R2[6] = {0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL,
                          0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL,
                          0x9a793e85b519952dULL, 0x11988fe592cae3aaULL};
/* 1 in Montgomery form (R mod p) */
static const u64 RONE[6] = {0x760900000002fffdULL, 0xebf4000bc40c0002ULL,
                            0x5f48985753c758baULL, 0x77ce585370525745ULL,
                            0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL};
/* group order r, big-endian bit access helper uses LE limbs */
static const u64 ORDER[4] = {0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
                             0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL};

typedef struct { u64 l[6]; } fe; /* Montgomery form */

static int fe_is_zero(const fe *a) {
  return !(a->l[0] | a->l[1] | a->l[2] | a->l[3] | a->l[4] | a->l[5]);
}

static int geq_p(const u64 *a) {
  for (int i = 5; i >= 0; i--) {
    if (a[i] > P[i]) return 1;
    if (a[i] < P[i]) return 0;
  }
  return 1;
}

static void sub_p(u64 *a) {
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a[i] - P[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

static void fe_add(fe *o, const fe *a, const fe *b) {
  u128 c = 0;
  for (int i = 0; i < 6; i++) {
    c += (u128)a->l[i] + b->l[i];
    o->l[i] = (u64)c;
    c >>= 64;
  }
  if (c || geq_p(o->l)) sub_p(o->l);
}

static void fe_sub(fe *o, const fe *a, const fe *b) {
  u128 borrow = 0;
  u64 t[6];
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a->l[i] - b->l[i] - borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) { /* add p back */
    u128 c = 0;
    for (int i = 0; i < 6; i++) {
      c += (u128)t[i] + P[i];
      t[i] = (u64)c;
      c >>= 64;
    }
  }
  memcpy(o->l, t, sizeof t);
}

static void fe_neg(fe *o, const fe *a) {
  if (fe_is_zero(a)) { *o = *a; return; }
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)P[i] - a->l[i] - borrow;
    o->l[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

/* CIOS Montgomery multiplication */
static void fe_mul(fe *o, const fe *a, const fe *b) {
  u64 t[8] = {0};
  for (int i = 0; i < 6; i++) {
    u128 carry = 0;
    for (int j = 0; j < 6; j++) {
      carry += (u128)a->l[i] * b->l[j] + t[j];
      t[j] = (u64)carry;
      carry >>= 64;
    }
    carry += t[6];
    t[6] = (u64)carry;
    t[7] = (u64)(carry >> 64);

    u64 m = t[0] * PINV;
    carry = (u128)m * P[0] + t[0];
    carry >>= 64;
    for (int j = 1; j < 6; j++) {
      carry += (u128)m * P[j] + t[j];
      t[j - 1] = (u64)carry;
      carry >>= 64;
    }
    carry += t[6];
    t[5] = (u64)carry;
    t[6] = t[7] + (u64)(carry >> 64);
    t[7] = 0;
  }
  if (t[6] || geq_p(t)) sub_p(t);
  memcpy(o->l, t, 6 * sizeof(u64));
}

static void fe_sqr(fe *o, const fe *a) { fe_mul(o, a, a); }

static void fe_from_bytes_be(fe *o, const unsigned char *in) {
  u64 raw[6];
  for (int i = 0; i < 6; i++) {
    u64 v = 0;
    for (int j = 0; j < 8; j++) v = (v << 8) | in[(5 - i) * 8 + j];
    raw[i] = v;
  }
  fe tmp, r2;
  memcpy(tmp.l, raw, sizeof raw);
  memcpy(r2.l, R2, sizeof R2);
  fe_mul(o, &tmp, &r2); /* to Montgomery */
}

static void fe_to_bytes_be(unsigned char *out, const fe *a) {
  fe one = {{1, 0, 0, 0, 0, 0}}, v;
  fe_mul(&v, a, &one); /* from Montgomery */
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 8; j++)
      out[(5 - i) * 8 + j] = (unsigned char)(v.l[i] >> (56 - 8 * j));
}

/* a^e for a fixed big-endian bit string e (square-and-multiply) */
static void fe_pow_be_bits(fe *o, const fe *a, const unsigned char *ebytes,
                           int nbytes) {
  fe acc;
  memcpy(acc.l, RONE, sizeof RONE);
  for (int i = 0; i < nbytes * 8; i++) {
    fe_sqr(&acc, &acc);
    if ((ebytes[i / 8] >> (7 - (i % 8))) & 1) fe_mul(&acc, &acc, a);
  }
  *o = acc;
}

/* (p+1)/4, big-endian */
static const unsigned char EXP_SQRT[48] = {
    0x06, 0x80, 0x44, 0x7a, 0x8e, 0x5f, 0xf9, 0xa6, 0x92, 0xc6, 0xe9, 0xed,
    0x90, 0xd2, 0xeb, 0x35, 0xd9, 0x1d, 0xd2, 0xe1, 0x3c, 0xe1, 0x44, 0xaf,
    0xd9, 0xcc, 0x34, 0xa8, 0x3d, 0xac, 0x3d, 0x89, 0x07, 0xaa, 0xff, 0xff,
    0xac, 0x54, 0xff, 0xff, 0xee, 0x7f, 0xbf, 0xff, 0xff, 0xff, 0xea, 0xab};

static int fe_sqrt(fe *o, const fe *a) {
  fe cand, chk;
  fe_pow_be_bits(&cand, a, EXP_SQRT, 48);
  fe_sqr(&chk, &cand);
  fe diff;
  fe_sub(&diff, &chk, a);
  if (!fe_is_zero(&diff)) return -1;
  *o = cand;
  return 0;
}

static int fe_lex_largest(const fe *a) {
  /* a > (p-1)/2  <=>  2a >= p+1  <=> 2a carries or 2a > p ... do via bytes */
  unsigned char ab[48], hb[48] = {
      0x0d, 0x00, 0x88, 0xf5, 0x1c, 0xbf, 0xf3, 0x4d, 0x25, 0x8d, 0xd3, 0xdb,
      0x21, 0xa5, 0xd6, 0x6b, 0xb2, 0x3b, 0xa5, 0xc2, 0x79, 0xc2, 0x89, 0x5f,
      0xb3, 0x98, 0x69, 0x50, 0x7b, 0x58, 0x7b, 0x12, 0x0f, 0x55, 0xff, 0xff,
      0x58, 0xa9, 0xff, 0xff, 0xdc, 0xff, 0x7f, 0xff, 0xff, 0xff, 0xd5, 0x55};
  fe_to_bytes_be(ab, a);
  int cmp = memcmp(ab, hb, 48);
  return cmp > 0;
}

/* ---- G1 arithmetic (Jacobian, a=0) for the subgroup check ---- */

typedef struct { fe x, y, z; } jac;

static void jac_double(jac *o, const jac *p) {
  if (fe_is_zero(&p->z) || fe_is_zero(&p->y)) {
    memset(o, 0, sizeof *o);
    memcpy(o->x.l, RONE, sizeof RONE);
    memcpy(o->y.l, RONE, sizeof RONE);
    return;
  }
  fe a, b, c, d, e, f, t, z3;
  /* z3 first: o may alias p and o->y is written below */
  fe_mul(&z3, &p->y, &p->z);
  fe_add(&z3, &z3, &z3);
  fe_sqr(&a, &p->x);
  fe_sqr(&b, &p->y);
  fe_sqr(&c, &b);
  fe_add(&t, &p->x, &b);
  fe_sqr(&t, &t);
  fe_sub(&t, &t, &a);
  fe_sub(&t, &t, &c);
  fe_add(&d, &t, &t);
  fe_add(&e, &a, &a);
  fe_add(&e, &e, &a);
  fe_sqr(&f, &e);
  fe_sub(&o->x, &f, &d);
  fe_sub(&o->x, &o->x, &d);
  fe_sub(&t, &d, &o->x);
  fe_mul(&t, &e, &t);
  fe c8;
  fe_add(&c8, &c, &c);
  fe_add(&c8, &c8, &c8);
  fe_add(&c8, &c8, &c8);
  fe_sub(&o->y, &t, &c8);
  o->z = z3;
}

static void jac_add_affine(jac *o, const jac *p, const fe *qx, const fe *qy) {
  if (fe_is_zero(&p->z)) {
    o->x = *qx;
    o->y = *qy;
    memcpy(o->z.l, RONE, sizeof RONE);
    return;
  }
  fe z1z1, u2, s2, h, r, hh, hhh, v, t;
  fe_sqr(&z1z1, &p->z);
  fe_mul(&u2, qx, &z1z1);
  fe_mul(&s2, qy, &p->z);
  fe_mul(&s2, &s2, &z1z1);
  fe_sub(&h, &u2, &p->x);
  fe_sub(&r, &s2, &p->y);
  if (fe_is_zero(&h)) {
    if (fe_is_zero(&r)) { jac_double(o, p); return; }
    memset(o, 0, sizeof *o);
    memcpy(o->x.l, RONE, sizeof RONE);
    memcpy(o->y.l, RONE, sizeof RONE);
    return;
  }
  fe_sqr(&hh, &h);
  fe_mul(&hhh, &h, &hh);
  fe_mul(&v, &p->x, &hh);
  fe_sqr(&t, &r);
  fe_sub(&t, &t, &hhh);
  fe_sub(&t, &t, &v);
  fe_sub(&o->x, &t, &v);
  fe_sub(&t, &v, &o->x);
  fe_mul(&t, &r, &t);
  fe w;
  fe_mul(&w, &p->y, &hhh);
  fe_sub(&o->y, &t, &w);
  fe_mul(&o->z, &p->z, &h);
}

int g1_subgroup_check(const unsigned char *xb, const unsigned char *yb) {
  fe x, y;
  fe_from_bytes_be(&x, xb);
  fe_from_bytes_be(&y, yb);
  jac acc;
  memset(&acc, 0, sizeof acc);
  memcpy(acc.x.l, RONE, sizeof RONE);
  memcpy(acc.y.l, RONE, sizeof RONE);
  int started = 0;
  for (int i = 255; i >= 0; i--) {
    if (started) jac_double(&acc, &acc);
    if ((ORDER[i / 64] >> (i % 64)) & 1) {
      if (!started) {
        acc.x = x;
        acc.y = y;
        memcpy(acc.z.l, RONE, sizeof RONE);
        started = 1;
      } else {
        jac_add_affine(&acc, &acc, &x, &y);
      }
    }
  }
  return fe_is_zero(&acc.z) ? 1 : 0;
}

int g1_decompress(const unsigned char *in, unsigned char *x_out,
                  unsigned char *y_out) {
  unsigned char meta = in[0] & 0xe0;
  if (meta == 0xc0) { /* infinity */
    if (in[0] & 0x1f) return -2;
    for (int i = 1; i < 48; i++)
      if (in[i]) return -2;
    return 1;
  }
  if (meta != 0x80 && meta != 0xa0) return -3;
  unsigned char xb[48];
  memcpy(xb, in, 48);
  xb[0] &= 0x1f;
  /* canonical check x < p */
  static const unsigned char PBE[48] = {
      0x1a, 0x01, 0x11, 0xea, 0x39, 0x7f, 0xe6, 0x9a, 0x4b, 0x1b, 0xa7, 0xb6,
      0x43, 0x4b, 0xac, 0xd7, 0x64, 0x77, 0x4b, 0x84, 0xf3, 0x85, 0x12, 0xbf,
      0x67, 0x30, 0xd2, 0xa0, 0xf6, 0xb0, 0xf6, 0x24, 0x1e, 0xab, 0xff, 0xfe,
      0xb1, 0x53, 0xff, 0xff, 0xb9, 0xfe, 0xff, 0xff, 0xff, 0xff, 0xaa, 0xab};
  if (memcmp(xb, PBE, 48) >= 0) return -4;
  fe x, rhs, y;
  fe_from_bytes_be(&x, xb);
  fe_sqr(&rhs, &x);
  fe_mul(&rhs, &rhs, &x);
  /* + 4: add RONE four times */
  fe four;
  fe_add(&four, (const fe *)RONE, (const fe *)RONE);
  fe_add(&four, &four, &four);
  fe_add(&rhs, &rhs, &four);
  if (fe_sqrt(&y, &rhs) != 0) return -5;
  int largest = fe_lex_largest(&y);
  int want_largest = (meta == 0xa0);
  if (largest != want_largest) fe_neg(&y, &y);
  memcpy(x_out, xb, 48);
  fe_to_bytes_be(y_out, &y);
  return 0;
}

int g1_compress(const unsigned char *xb, const unsigned char *yb,
                unsigned char *out) {
  fe y;
  fe_from_bytes_be(&y, yb);
  memcpy(out, xb, 48);
  out[0] |= fe_lex_largest(&y) ? 0xa0 : 0x80;
  return 0;
}

/* ---- host group-op fast path (utils/field_host.py fallback is Python
 * bignum; these serve the verifier's transcript-replay group ops and the
 * MSM window combine — gnark's assembly-backed G1Jac equivalents) ---- */

/* p-2, big-endian (Fermat inversion exponent) */
static const unsigned char EXP_INV[48] = {
    0x1a, 0x01, 0x11, 0xea, 0x39, 0x7f, 0xe6, 0x9a, 0x4b, 0x1b, 0xa7, 0xb6,
    0x43, 0x4b, 0xac, 0xd7, 0x64, 0x77, 0x4b, 0x84, 0xf3, 0x85, 0x12, 0xbf,
    0x67, 0x30, 0xd2, 0xa0, 0xf6, 0xb0, 0xf6, 0x24, 0x1e, 0xab, 0xff, 0xfe,
    0xb1, 0x53, 0xff, 0xff, 0xb9, 0xfe, 0xff, 0xff, 0xff, 0xff, 0xaa, 0xa9};

static void jac_set_inf(jac *o) {
  memset(o, 0, sizeof *o);
  memcpy(o->x.l, RONE, sizeof RONE);
  memcpy(o->y.l, RONE, sizeof RONE);
}

static int jac_to_affine_bytes(const jac *p, unsigned char *out /*96*/) {
  if (fe_is_zero(&p->z)) return 1;
  fe zi, zi2, t;
  fe_pow_be_bits(&zi, &p->z, EXP_INV, 48);
  fe_sqr(&zi2, &zi);
  fe_mul(&t, &p->x, &zi2);
  fe_to_bytes_be(out, &t);
  fe_mul(&t, &p->y, &zi2);
  fe_mul(&t, &t, &zi);
  fe_to_bytes_be(out + 48, &t);
  return 0;
}

/* pt/out: 96-byte x||y big-endian; returns 1 when the result is infinity. */
int g1_mul_host(const unsigned char *pt, int32_t pt_inf,
                const unsigned char *k_be, int32_t k_len,
                unsigned char *out) {
  if (pt_inf) return 1;
  fe x, y;
  fe_from_bytes_be(&x, pt);
  fe_from_bytes_be(&y, pt + 48);
  jac acc;
  jac_set_inf(&acc);
  int started = 0;
  for (int i = 0; i < k_len * 8; i++) {
    if (started) jac_double(&acc, &acc);
    if ((k_be[i / 8] >> (7 - (i % 8))) & 1) {
      if (!started) {
        acc.x = x;
        acc.y = y;
        memcpy(acc.z.l, RONE, sizeof RONE);
        started = 1;
      } else {
        jac_add_affine(&acc, &acc, &x, &y);
      }
    }
  }
  if (!started) return 1;
  return jac_to_affine_bytes(&acc, out);
}

int g1_add_host(const unsigned char *p, int32_t p_inf,
                const unsigned char *q, int32_t q_inf, unsigned char *out) {
  if (p_inf && q_inf) return 1;
  if (p_inf) {
    memcpy(out, q, 96);
    return 0;
  }
  if (q_inf) {
    memcpy(out, p, 96);
    return 0;
  }
  jac a;
  fe_from_bytes_be(&a.x, p);
  fe_from_bytes_be(&a.y, p + 48);
  memcpy(a.z.l, RONE, sizeof RONE);
  fe qx, qy;
  fe_from_bytes_be(&qx, q);
  fe_from_bytes_be(&qy, q + 48);
  jac_add_affine(&a, &a, &qx, &qy);
  return jac_to_affine_bytes(&a, out);
}

/* MSB-first Horner combine: acc = 2^wbits * acc + S_w over m window sums
 * (wins: m rows of 96-byte x||y; infs[w] nonzero = skip row). Returns 1
 * when the total is infinity. */
int g1_combine_windows_host(const unsigned char *wins,
                            const unsigned char *infs, int32_t m,
                            int32_t wbits, unsigned char *out) {
  jac acc;
  jac_set_inf(&acc);
  int started = 0;
  for (int w = 0; w < m; w++) {
    if (started)
      for (int b = 0; b < wbits; b++) jac_double(&acc, &acc);
    if (!infs[w]) {
      fe x, y;
      fe_from_bytes_be(&x, wins + (size_t)w * 96);
      fe_from_bytes_be(&y, wins + (size_t)w * 96 + 48);
      if (!started) {
        acc.x = x;
        acc.y = y;
        memcpy(acc.z.l, RONE, sizeof RONE);
        started = 1;
      } else {
        jac_add_affine(&acc, &acc, &x, &y);
      }
    }
  }
  if (!started) return 1;
  return jac_to_affine_bytes(&acc, out);
}
