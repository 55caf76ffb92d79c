/* STROBE-128 / Merlin transcript ops — native host fast path.
 *
 * The verifier's Fiat-Shamir replay absorbs thousands of short messages
 * (48-byte points, 32-byte scalars) and squeezes hundreds of
 * rejection-sampled challenges (transcript/transcript.go of the Go
 * reference). Per-message Python STROBE pays interpreter overhead; these
 * bulk entry points do a whole label-group (or challenge vector) in one
 * ctypes call. Byte-exact with utils/strobe.py + utils/merlin.py, which are
 * byte-exact with the merlin crate / jsign/merlin.
 *
 * Copied from go_curdleproofs_tpu/native/strobe.c.
 *
 * State is marshalled as (uint8_t st[200], int32_t pos3[3] = {pos,
 * pos_begin, cur_flags}), matching the Python Strobe128 fields.
 */

#include <stdint.h>
#include <string.h>

void keccak_f1600(unsigned char *state); /* keccak.c */

#define STROBE_R 166
#define FLAG_I 1
#define FLAG_A (1 << 1)
#define FLAG_C (1 << 2)
#define FLAG_M (1 << 4)

typedef struct {
  uint8_t *st;
  int pos;
  int pos_begin;
  int cur_flags;
} sst;

static void run_f(sst *s) {
  s->st[s->pos] ^= (uint8_t)s->pos_begin;
  s->st[s->pos + 1] ^= 0x04;
  s->st[STROBE_R + 1] ^= 0x80;
  keccak_f1600(s->st);
  s->pos = 0;
  s->pos_begin = 0;
}

static void absorb(sst *s, const uint8_t *data, int n) {
  int i = 0;
  while (i < n) {
    int take = STROBE_R - s->pos;
    if (take > n - i) take = n - i;
    for (int j = 0; j < take; j++) s->st[s->pos + j] ^= data[i + j];
    s->pos += take;
    i += take;
    if (s->pos == STROBE_R) run_f(s);
  }
}

static void squeeze(sst *s, uint8_t *out, int n) {
  int got = 0;
  while (got < n) {
    int take = STROBE_R - s->pos;
    if (take > n - got) take = n - got;
    memcpy(out + got, s->st + s->pos, take);
    memset(s->st + s->pos, 0, take);
    s->pos += take;
    got += take;
    if (s->pos == STROBE_R) run_f(s);
  }
}

static void begin_op(sst *s, int flags, int more) {
  if (more) return; /* continuation: caller guarantees flags match */
  uint8_t hdr[2];
  hdr[0] = (uint8_t)s->pos_begin;
  hdr[1] = (uint8_t)flags;
  s->pos_begin = s->pos + 1;
  s->cur_flags = flags;
  absorb(s, hdr, 2);
  if ((flags & FLAG_C) && s->pos != 0) run_f(s);
}

static void load(sst *s, uint8_t *st, int32_t *pos3) {
  s->st = st;
  s->pos = pos3[0];
  s->pos_begin = pos3[1];
  s->cur_flags = pos3[2];
}

static void store(const sst *s, int32_t *pos3) {
  pos3[0] = s->pos;
  pos3[1] = s->pos_begin;
  pos3[2] = s->cur_flags;
}

static void append_one(sst *s, const uint8_t *label, int ll,
                       const uint8_t *msg, int ml) {
  uint8_t len4[4] = {(uint8_t)ml, (uint8_t)(ml >> 8), (uint8_t)(ml >> 16),
                     (uint8_t)(ml >> 24)};
  begin_op(s, FLAG_M | FLAG_A, 0);
  absorb(s, label, ll);
  absorb(s, len4, 4); /* meta_ad(u32le(len), more=1) */
  begin_op(s, FLAG_A, 0);
  absorb(s, msg, ml);
}

/* Absorb `count` equal-length messages (contiguous rows) under one label. */
void merlin_append_msgs(uint8_t *st, int32_t *pos3, const uint8_t *label,
                        int32_t ll, const uint8_t *msgs, int32_t msg_len,
                        int32_t count) {
  sst s;
  load(&s, st, pos3);
  for (int i = 0; i < count; i++)
    append_one(&s, label, ll, msgs + (size_t)i * msg_len, msg_len);
  store(&s, pos3);
}

/* BLS12-381 scalar field order r, big-endian bytes. */
static const uint8_t R_BE[32] = {
    0x73, 0xed, 0xa7, 0x53, 0x29, 0x9d, 0x7d, 0x48, 0x33, 0x39, 0xd8,
    0x08, 0x09, 0xa1, 0xd8, 0x05, 0x53, 0xbd, 0xa4, 0x02, 0xff, 0xfe,
    0x5b, 0xfe, 0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x01};

static int lt_r(const uint8_t *v) {
  for (int i = 0; i < 32; i++) {
    if (v[i] < R_BE[i]) return 1;
    if (v[i] > R_BE[i]) return 0;
  }
  return 0; /* equal -> not canonical */
}

/* `count` rejection-sampled canonical Fr challenges, each re-absorbed on
 * acceptance (utils/transcript.py get_and_append_challenge). out: count
 * rows of 32 big-endian bytes. */
void transcript_challenges(uint8_t *st, int32_t *pos3, const uint8_t *label,
                           int32_t ll, uint8_t *out, int32_t count) {
  sst s;
  load(&s, st, pos3);
  uint8_t len4[4] = {32, 0, 0, 0};
  for (int i = 0; i < count; i++) {
    uint8_t *dst = out + (size_t)i * 32;
    do {
      begin_op(&s, FLAG_M | FLAG_A, 0);
      absorb(&s, label, ll);
      absorb(&s, len4, 4);
      begin_op(&s, FLAG_I | FLAG_A | FLAG_C, 0);
      squeeze(&s, dst, 32);
    } while (!lt_r(dst));
    append_one(&s, label, ll, dst, 32);
  }
  store(&s, pos3);
}
