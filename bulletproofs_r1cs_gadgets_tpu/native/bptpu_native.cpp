// Native host-side primitives for bulletproofs_r1cs_gadgets_tpu.
//
// The reference stack's host-side hot loops live in Rust (curve25519-dalek
// Scalar arithmetic, merlin's keccak; SURVEY.md S2b N1/N8).  This file is
// their C++ equivalent for the rebuild: the device owns the batched proof
// math, while the host owns transcripts and sparse-Merkle-tree maintenance
// (SURVEY.md CS-5: 253 sequential Poseidon hashes per tree update), which
// are latency- not throughput-bound and therefore belong on CPU.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this environment).
//
// Build: python -m bulletproofs_r1cs_gadgets_tpu.native.build
//
// Field arithmetic: 4x64-bit limbs with unsigned __int128 products,
// reduction mod L = 2^252 + C by folding 2^252 == -C three times
// (mirrors the device fold strategy in ops/field.py, so both sides
// are testable against each other).

#include <cstdint>
#include <cstring>

using u64 = uint64_t;
using u128 = unsigned __int128;

extern "C" {

// ------------------------------------------------------------------ keccak
static const u64 KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline u64 rotl64(u64 x, int n) { return (x << n) | (x >> (64 - n)); }

void keccak_f1600(uint8_t state_bytes[200]) {
  u64 a[25];
  memcpy(a, state_bytes, 200);
  for (int round = 0; round < 24; ++round) {
    u64 c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d[x];
    u64 b[25];
    static const int rotc[5][5] = {{0, 36, 3, 41, 18},
                                   {1, 44, 10, 45, 2},
                                   {62, 6, 43, 15, 61},
                                   {28, 55, 25, 21, 56},
                                   {27, 20, 39, 8, 14}};
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], rotc[x][y]);
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) &
                                       b[(x + 2) % 5 + 5 * y]);
    a[0] ^= KECCAK_RC[round];
  }
  memcpy(state_bytes, a, 200);
}

// ------------------------------------------------------- scalar field (L)
// L = 2^252 + C, C = 0x14def9dea2f79cd65812631a5cf5d3ed
static const u64 L_LIMBS[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                               0ULL, 0x1000000000000000ULL};
static const u64 C_LIMBS[2] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL};

struct U256 {
  u64 w[4];
};

static inline int ge_l(const u64 x[4]) {
  for (int i = 3; i >= 0; --i) {
    if (x[i] > L_LIMBS[i]) return 1;
    if (x[i] < L_LIMBS[i]) return 0;
  }
  return 1;  // equal
}

static inline void sub_l(u64 x[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 diff = (u128)x[i] - L_LIMBS[i] - borrow;
    x[i] = (u64)diff;
    borrow = (diff >> 64) ? 1 : 0;
  }
}

// Shift L left by `s` bits into an 8-limb buffer.
static void l_shifted(int s, u64 out[8]) {
  memset(out, 0, 8 * sizeof(u64));
  int limb = s / 64, off = s % 64;
  for (int i = 0; i < 4; ++i) {
    if (off == 0) {
      if (limb + i < 8) out[limb + i] |= L_LIMBS[i];
    } else {
      u128 v = (u128)L_LIMBS[i] << off;
      if (limb + i < 8) out[limb + i] |= (u64)v;
      if (limb + i + 1 < 8) out[limb + i + 1] |= (u64)(v >> 64);
    }
  }
}

// x (8 limbs, < 2^512) -> x mod L (4 limbs).
//
// Each pass rewrites x = lo + 2^252*hi as lo + (L << k) - C*hi, where the
// added multiple of L (pass-specific k: 200, 80, 0, 0) dominates C*hi, so
// all arithmetic stays non-negative.  Value bounds per pass:
//   < 2^512 -> < 2^454 -> < 2^334 -> < 2^254 -> < 2^253.2,
// after which at most three conditional subtractions of L finish.
// The (L << k) tables are precomputed; a pass whose hi = x >> 252 is
// already zero leaves x < 2^252 and the loop exits early (the common case
// after pass 2 for canonical-operand products).
static u64 KL_TAB[4][8];
static int KL_READY = 0;
static const int KSHIFT[4] = {200, 80, 0, 0};

static void reduce_wide(const u64 in[8], u64 out[4]) {
  u64 x[8];
  memcpy(x, in, 8 * sizeof(u64));
  if (!KL_READY) {  // idempotent: same values from any thread
    for (int p = 0; p < 4; ++p) l_shifted(KSHIFT[p], KL_TAB[p]);
    KL_READY = 1;
  }

  for (int pass = 0; pass < 4; ++pass) {
    // hi = x >> 252 (5 limbs), lo = x mod 2^252
    u64 hi[5];
    u64 any_hi = 0;
    for (int i = 0; i < 5; ++i) {
      u64 lo_part = x[3 + i] >> 60;
      u64 hi_part = (i + 4 < 8) ? (x[4 + i] << 4) : 0;
      hi[i] = lo_part | hi_part;
      any_hi |= hi[i];
    }
    if (!any_hi) break;  // x < 2^252 already
    u64 lo[4] = {x[0], x[1], x[2], x[3] & 0x0fffffffffffffffULL};
    // prod = hi * C (5x2 -> up to 7 limbs)
    u64 prod[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 5; ++i) {
      u128 carry = 0;
      for (int j = 0; j < 2; ++j) {
        u128 cur = (u128)hi[i] * C_LIMBS[j] + prod[i + j] + carry;
        prod[i + j] = (u64)cur;
        carry = cur >> 64;
      }
      for (int k = i + 2; carry && k < 8; ++k) {
        u128 cur = (u128)prod[k] + carry;
        prod[k] = (u64)cur;
        carry = cur >> 64;
      }
    }
    // x = lo + (L << KSHIFT[pass]) - prod   (non-negative by construction)
    const u64* kl = KL_TAB[pass];
    u128 carry = 0;
    for (int i = 0; i < 8; ++i) {
      u128 cur = (u128)((i < 4) ? lo[i] : 0) + kl[i] + carry;
      x[i] = (u64)cur;
      carry = cur >> 64;
    }
    u128 borrow = 0;
    for (int i = 0; i < 8; ++i) {
      u128 diff = (u128)x[i] - prod[i] - borrow;
      x[i] = (u64)diff;
      borrow = (diff >> 64) ? 1 : 0;
    }
  }
  u64 fin[4] = {x[0], x[1], x[2], x[3]};
  while (ge_l(fin)) sub_l(fin);
  memcpy(out, fin, 4 * sizeof(u64));
}

// full 4x4 schoolbook product into 8 limbs (no reduction)
static inline void mul_wide(const u64 a[4], const u64 b[4], u64 prod[8]) {
  memset(prod, 0, 8 * sizeof(u64));
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)a[i] * b[j] + prod[i + j] + carry;
      prod[i + j] = (u64)cur;
      carry = cur >> 64;
    }
    prod[i + 4] += (u64)carry;
  }
}

void sc_mul(const u64 a[4], const u64 b[4], u64 out[4]) {
  u64 prod[8];
  mul_wide(a, b, prod);
  reduce_wide(prod, out);
}

void sc_add(const u64 a[4], const u64 b[4], u64 out[4]) {
  // canonical inputs (< L < 2^253): sum < 2L fits 4 limbs; one conditional
  // subtraction restores canonical form (reduce_wide here cost 25x).
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)a[i] + b[i] + carry;
    out[i] = (u64)cur;
    carry = cur >> 64;
  }
  // carry-out cannot happen for canonical inputs (2L < 2^254)
  while (ge_l(out)) sub_l(out);
}

void sc_sub(const u64 a[4], const u64 b[4], u64 out[4]) {
  // a - b mod L: a + (L - b)
  u64 nb[4];
  memcpy(nb, L_LIMBS, sizeof(nb));
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 diff = (u128)nb[i] - b[i] - borrow;
    nb[i] = (u64)diff;
    borrow = (diff >> 64) ? 1 : 0;
  }
  sc_add(a, nb, out);
}

// --- 4-limb helpers for the binary-xgcd inversion -------------------------
static inline int limbs_is_zero(const u64 x[4]) {
  return (x[0] | x[1] | x[2] | x[3]) == 0;
}

static inline int limbs_is_one(const u64 x[4]) {
  return x[0] == 1 && (x[1] | x[2] | x[3]) == 0;
}

static inline int limbs_cmp(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > b[i]) return 1;
    if (a[i] < b[i]) return -1;
  }
  return 0;
}

static inline void limbs_sub(u64 a[4], const u64 b[4]) {  // a -= b (a >= b)
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 diff = (u128)a[i] - b[i] - borrow;
    a[i] = (u64)diff;
    borrow = (diff >> 64) ? 1 : 0;
  }
}

static inline void limbs_shr1(u64 x[4]) {
  x[0] = (x[0] >> 1) | (x[1] << 63);
  x[1] = (x[1] >> 1) | (x[2] << 63);
  x[2] = (x[2] >> 1) | (x[3] << 63);
  x[3] >>= 1;
}

// x = x/2 mod L for x < L: if odd first add L (L odd; x+L < 2^254 so the
// carry-out bit is tracked in `carry`).
static inline void limbs_half_mod(u64 x[4]) {
  u64 carry = 0;
  if (x[0] & 1) {
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
      u128 cur = (u128)x[i] + L_LIMBS[i] + c;
      x[i] = (u64)cur;
      c = cur >> 64;
    }
    carry = (u64)c;
  }
  limbs_shr1(x);
  x[3] |= carry << 63;
}

void sc_inv(const u64 a[4], u64 out[4]) {
  // Binary extended GCD mod L (variable-time; see PARITY.md on the
  // constant-time deviation).  ~10x the Fermat ladder this replaced —
  // inversion dominates the inverse-S-box witness chains (188 sequential
  // inversions per Poseidon permutation, gadget_poseidon.rs:153-185).
  // Invariants: x1*a == u (mod L), x2*a == v (mod L).
  if (limbs_is_zero(a)) {  // dalek semantics: invert(0) == 0
    memset(out, 0, 4 * sizeof(u64));
    return;
  }
  u64 u[4], v[4], x1[4] = {1, 0, 0, 0}, x2[4] = {0, 0, 0, 0};
  memcpy(u, a, sizeof(u));
  while (ge_l(u)) sub_l(u);
  memcpy(v, L_LIMBS, sizeof(v));
  while (!limbs_is_one(u) && !limbs_is_one(v)) {
    while (!(u[0] & 1)) {
      limbs_shr1(u);
      limbs_half_mod(x1);
    }
    while (!(v[0] & 1)) {
      limbs_shr1(v);
      limbs_half_mod(x2);
    }
    if (limbs_cmp(u, v) >= 0) {
      limbs_sub(u, v);  // u, v odd -> u-v even; next loop halves
      // x1 = x1 - x2 mod L
      if (limbs_cmp(x1, x2) < 0) {
        u128 c = 0;
        for (int i = 0; i < 4; ++i) {
          u128 cur = (u128)x1[i] + L_LIMBS[i] + c;
          x1[i] = (u64)cur;
          c = cur >> 64;
        }
        (void)c;  // x1+L < 2^254: the bit above limb 3 is impossible here
      }
      limbs_sub(x1, x2);
    } else {
      limbs_sub(v, u);
      if (limbs_cmp(x2, x1) < 0) {
        u128 c = 0;
        for (int i = 0; i < 4; ++i) {
          u128 cur = (u128)x2[i] + L_LIMBS[i] + c;
          x2[i] = (u64)cur;
          c = cur >> 64;
        }
        (void)c;
      }
      limbs_sub(x2, x1);
    }
  }
  if (limbs_is_one(u)) {
    memcpy(out, x1, 4 * sizeof(u64));
  } else {
    memcpy(out, x2, 4 * sizeof(u64));
  }
  while (ge_l(out)) sub_l(out);
}

// ------------------------------------------------- vectorized field (Z/L)
// Array layout: (n, 4) little-endian u64 limbs, C-contiguous (numpy view).
// These back the prover's hot O(n) loops (l/r polynomial construction, IPP
// scalar folds, inner products, constraint flattening) that the dalek
// engine runs as Rust iterator chains; here they are host C++ so Python
// never loops over 2^18 scalars (as Python loops they made the warm prove
// ~40% host Python).

using i64 = long long;

void sc_vec_mul(const u64* a, const u64* b, u64* out, i64 n) {
  for (i64 i = 0; i < n; ++i) sc_mul(a + 4 * i, b + 4 * i, out + 4 * i);
}

void sc_vec_add(const u64* a, const u64* b, u64* out, i64 n) {
  for (i64 i = 0; i < n; ++i) sc_add(a + 4 * i, b + 4 * i, out + 4 * i);
}

void sc_vec_sub(const u64* a, const u64* b, u64* out, i64 n) {
  for (i64 i = 0; i < n; ++i) sc_sub(a + 4 * i, b + 4 * i, out + 4 * i);
}

// out_i = a_i * s
void sc_vec_scale(const u64* a, const u64 s[4], u64* out, i64 n) {
  for (i64 i = 0; i < n; ++i) sc_mul(a + 4 * i, s, out + 4 * i);
}

// out_i = a_i * x + b_i * y   (the IPP fold: a' = a_L*u + a_R*u_inv).
// Fused: both 512-bit products are summed WIDE (sum < 2*L^2 < 2^507, no
// overflow) and reduced once — one reduce_wide instead of two plus a
// canonical add per element (~1.5x on the per-round a/b fold loops).
void sc_vec_axpby(const u64* a, const u64 x[4], const u64* b, const u64 y[4],
                  u64* out, i64 n) {
  u64 p1[8], p2[8];
  for (i64 i = 0; i < n; ++i) {
    mul_wide(a + 4 * i, x, p1);
    mul_wide(b + 4 * i, y, p2);
    u128 carry = 0;
    for (int j = 0; j < 8; ++j) {
      u128 cur = (u128)p1[j] + p2[j] + carry;
      p1[j] = (u64)cur;
      carry = cur >> 64;
    }
    reduce_wide(p1, out + 4 * i);
  }
}

// out = sum_i a_i * b_i  (lazy 512-bit accumulation, one final reduction)
void sc_vec_inner(const u64* a, const u64* b, i64 n, u64 out[4]) {
  u64 acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  u64 prod[8];
  for (i64 i = 0; i < n; ++i) {
    mul_wide(a + 4 * i, b + 4 * i, prod);
    // acc += prod; on carry-out risk (acc high limb near max), pre-reduce.
    u128 carry = 0;
    for (int j = 0; j < 8; ++j) {
      u128 cur = (u128)acc[j] + prod[j] + carry;
      acc[j] = (u64)cur;
      carry = cur >> 64;
    }
    if (acc[7] >> 56) {  // headroom check: reduce long before overflow
      u64 red[4];
      reduce_wide(acc, red);
      memset(acc, 0, sizeof(acc));
      memcpy(acc, red, sizeof(red));
    }
  }
  reduce_wide(acc, out);
}

// out_i = base^i for i in 0..n-1
void sc_vec_powers(const u64 base[4], u64* out, i64 n) {
  if (n <= 0) return;
  u64 cur[4] = {1, 0, 0, 0};
  memcpy(out, cur, 32);
  for (i64 i = 1; i < n; ++i) {
    sc_mul(out + 4 * (i - 1), base, out + 4 * i);
  }
}

// 64-byte little-endian wide values -> canonical scalars (dalek
// from_bytes_mod_order_wide; used for bulk blinding generation)
void sc_vec_from_wide(const uint8_t* bytes, u64* out, i64 n) {
  for (i64 i = 0; i < n; ++i) {
    u64 wide[8];
    memcpy(wide, bytes + 64 * i, 64);
    reduce_wide(wide, out + 4 * i);
  }
}

// Montgomery batch inversion; zeros pass through as zero (dalek semantics)
void sc_vec_batch_inv(const u64* a, u64* out, i64 n) {
  // prefix[i] = product of nonzero a_0..a_{i-1}
  u64* prefix = new u64[4 * (n + 1)];
  u64 one[4] = {1, 0, 0, 0};
  memcpy(prefix, one, 32);
  for (i64 i = 0; i < n; ++i) {
    const u64* x = a + 4 * i;
    bool zero = !(x[0] | x[1] | x[2] | x[3]);
    if (zero)
      memcpy(prefix + 4 * (i + 1), prefix + 4 * i, 32);
    else
      sc_mul(prefix + 4 * i, x, prefix + 4 * (i + 1));
  }
  u64 inv_all[4];
  sc_inv(prefix + 4 * n, inv_all);
  for (i64 i = n - 1; i >= 0; --i) {
    const u64* x = a + 4 * i;
    bool zero = !(x[0] | x[1] | x[2] | x[3]);
    if (zero) {
      memset(out + 4 * i, 0, 32);
    } else {
      sc_mul(prefix + 4 * i, inv_all, out + 4 * i);
      sc_mul(inv_all, x, inv_all);
    }
  }
  delete[] prefix;
}

// Constraint flattening: for each tape term t, out[widx[t]] += zpow[cidx[t]]
// * coeff[t] (sign folded into coeff).  One call per wire class (wL/wR/wO/
// wV); the z-power table is shared.
void sc_flatten(const u64* zpow, const u64* coeff, const i64* cidx,
                const i64* widx, i64 m, u64* out) {
  u64 t[4];
  for (i64 i = 0; i < m; ++i) {
    sc_mul(zpow + 4 * cidx[i], coeff + 4 * i, t);
    sc_add(out + 4 * widx[i], t, out + 4 * widx[i]);
  }
}

// ----------------------------------------------------------- poseidon (L)
// Generic width-6 Poseidon permutation over Z/L matching
// gadgets/poseidon.py (reference gadget_poseidon.rs:189-280).
// sbox_type: 0 = cube, 1 = inverse.
// round_keys: (total_rounds * width) scalars; mds: width*width scalars,
// all as 4x64-bit LE limb vectors.
void poseidon_permutation(const u64* state_in, u64* state_out, int width,
                          const u64* round_keys, const u64* mds,
                          int full_b, int partial, int full_e,
                          int sbox_type) {
  u64 st[16][4];
  for (int i = 0; i < width; ++i) memcpy(st[i], state_in + 4 * i, 32);
  int off = 0;
  int total = full_b + partial + full_e;
  u64 tmp[16][4];
  for (int r = 0; r < total; ++r) {
    bool full = (r < full_b) || (r >= full_b + partial);
    for (int i = 0; i < width; ++i) {
      sc_add(st[i], round_keys + 4 * (off + i), st[i]);
    }
    off += width;
    for (int i = 0; i < width; ++i) {
      bool apply = full || (i == width - 1);
      if (!apply) continue;
      if (sbox_type == 0) {
        u64 sq[4];
        sc_mul(st[i], st[i], sq);
        sc_mul(sq, st[i], st[i]);
      } else {
        sc_inv(st[i], st[i]);
      }
    }
    // linear layer: tmp[i] = sum_j mds[i][j] * st[j]
    for (int i = 0; i < width; ++i) {
      u64 acc[4] = {0, 0, 0, 0};
      for (int j = 0; j < width; ++j) {
        u64 prod[4];
        sc_mul(mds + 4 * (i * width + j), st[j], prod);
        sc_add(acc, prod, acc);
      }
      memcpy(tmp[i], acc, 32);
    }
    for (int i = 0; i < width; ++i) memcpy(st[i], tmp[i], 32);
  }
  for (int i = 0; i < width; ++i) memcpy(state_out + 4 * i, st[i], 32);
}

// Witness-recording permutation: like poseidon_permutation but also emits,
// per S-box application (round-major, lane-minor order), the value fed to
// the S-box (after key add) and the S-box output.  These are exactly the
// multiplier wire values of the circuit dual (gadget_poseidon.rs:141-185):
// inverse S-box multipliers are (u, u^-1, 1), (u, 0, 0), (u, u^-1, 1);
// cube S-box multipliers are (u, u, u^2), (u^2, u, u^3).
static void poseidon_permutation_record(const u64* state_in, u64* state_out,
                                        int width, const u64* round_keys,
                                        const u64* mds, int full_b,
                                        int partial, int full_e,
                                        int sbox_type, u64* sbox_uv) {
  u64 st[16][4];
  for (int i = 0; i < width; ++i) memcpy(st[i], state_in + 4 * i, 32);
  int off = 0;
  int total = full_b + partial + full_e;
  u64 tmp[16][4];
  i64 rec = 0;
  for (int r = 0; r < total; ++r) {
    bool full = (r < full_b) || (r >= full_b + partial);
    for (int i = 0; i < width; ++i) {
      sc_add(st[i], round_keys + 4 * (off + i), st[i]);
    }
    off += width;
    for (int i = 0; i < width; ++i) {
      bool apply = full || (i == width - 1);
      if (!apply) continue;
      memcpy(sbox_uv + 8 * rec, st[i], 32);  // u
      if (sbox_type == 0) {
        u64 sq[4];
        sc_mul(st[i], st[i], sq);
        sc_mul(sq, st[i], st[i]);
      } else {
        sc_inv(st[i], st[i]);
      }
      memcpy(sbox_uv + 8 * rec + 4, st[i], 32);  // sbox output
      ++rec;
    }
    for (int i = 0; i < width; ++i) {
      u64 acc[4] = {0, 0, 0, 0};
      for (int j = 0; j < width; ++j) {
        u64 prod[4];
        sc_mul(mds + 4 * (i * width + j), st[j], prod);
        sc_add(acc, prod, acc);
      }
      memcpy(tmp[i], acc, 32);
    }
    for (int i = 0; i < width; ++i) memcpy(st[i], tmp[i], 32);
  }
  for (int i = 0; i < width; ++i) memcpy(state_out + 4 * i, st[i], 32);
}

// VSMT-2 witness chain (SURVEY CS-2): starting from the leaf, per level
// select left/right from the index bit and hash [0, l, r, PAD, 0, 0].
// Inputs: leaf, bits (depth scalars in {0,1}, LSB first), nodes (depth
// proof nodes, leaf level first).  Outputs:
//   cur_chain: (depth+1, 4)  running hash values (cur_chain[0] = leaf)
//   sbox_uv:   (depth, nsbox, 2, 4)  per-level S-box (u, out) pairs
// The select multiplier wires derive from cur_chain/bits/nodes in numpy.
void vsmt2_chain_witness(const u64* leaf, const u64* bits, const u64* nodes,
                         i64 depth, int width, const u64* round_keys,
                         const u64* mds, int full_b, int partial, int full_e,
                         int sbox_type, const u64* pad_const, u64* cur_chain,
                         u64* sbox_uv) {
  int nsbox = (full_b + full_e) * width + partial;
  u64 cur[4];
  memcpy(cur, leaf, 32);
  memcpy(cur_chain, leaf, 32);
  for (i64 lvl = 0; lvl < depth; ++lvl) {
    const u64* node = nodes + 4 * lvl;
    bool b = bits[4 * lvl] != 0;
    u64 state[6 * 4];
    memset(state, 0, sizeof(state));
    // [0, left, right, PAD, 0, 0]
    if (b) {
      memcpy(state + 4 * 1, node, 32);  // left = node
      memcpy(state + 4 * 2, cur, 32);   // right = cur
    } else {
      memcpy(state + 4 * 1, cur, 32);
      memcpy(state + 4 * 2, node, 32);
    }
    memcpy(state + 4 * 3, pad_const, 32);
    u64 out_state[6 * 4];
    poseidon_permutation_record(state, out_state, width, round_keys, mds,
                                full_b, partial, full_e, sbox_type,
                                sbox_uv + (i64)8 * nsbox * lvl);
    memcpy(cur, out_state + 4 * 1, 32);
    memcpy(cur_chain + 4 * (lvl + 1), cur, 32);
  }
}

// Single-permutation witness recording entry (used by the compiled
// Poseidon-hash circuits; states/outputs as in poseidon_permutation).
void poseidon_permutation_witness(const u64* state_in, u64* state_out,
                                  int width, const u64* round_keys,
                                  const u64* mds, int full_b, int partial,
                                  int full_e, int sbox_type, u64* sbox_uv) {
  poseidon_permutation_record(state_in, state_out, width, round_keys, mds,
                              full_b, partial, full_e, sbox_type, sbox_uv);
}

// Batched permutation: n independent states (for bulk tree verification).
void poseidon_permutation_batch(const u64* states_in, u64* states_out, int n,
                                int width, const u64* round_keys,
                                const u64* mds, int full_b, int partial,
                                int full_e, int sbox_type) {
  for (int k = 0; k < n; ++k) {
    poseidon_permutation(states_in + 4 * width * k, states_out + 4 * width * k,
                         width, round_keys, mds, full_b, partial, full_e,
                         sbox_type);
  }
}

// ------------------------------------------------- curve field (2^255-19)
// 5x51-bit limbs, u128 products (standard ref10-style schoolbook with *19
// wraparound).  Used only for generator derivation (hash-to-group): the
// SHAKE-256 generator chains need two Elligator maps + one Edwards add per
// point (core/ristretto.py from_uniform_bytes / RFC 9496 one-way map), and
// deriving 2x262144 of them in Python costs ~13 min; here it is seconds.
typedef struct { u64 v[5]; } fe;

static const u64 FE_MASK = (1ULL << 51) - 1;

static inline void fe_frombytes(fe* h, const uint8_t s[32]) {
  u64 w[4];
  memcpy(w, s, 32);
  h->v[0] = w[0] & FE_MASK;
  h->v[1] = ((w[0] >> 51) | (w[1] << 13)) & FE_MASK;
  h->v[2] = ((w[1] >> 38) | (w[2] << 26)) & FE_MASK;
  h->v[3] = ((w[2] >> 25) | (w[3] << 39)) & FE_MASK;
  h->v[4] = (w[3] >> 12) & FE_MASK;  // drops bit 255 (RFC 9496 mask)
}

static inline void fe_carry(fe* h) {
  u64* v = h->v;
  for (int r = 0; r < 2; ++r) {
    u64 c = v[4] >> 51; v[4] &= FE_MASK; v[0] += 19 * c;
    for (int i = 0; i < 4; ++i) {
      c = v[i] >> 51; v[i] &= FE_MASK; v[i + 1] += c;
    }
  }
}

static inline void fe_tobytes(uint8_t s[32], const fe* f) {
  fe t = *f;
  fe_carry(&t);
  // strong reduce: add 19, propagate, drop bit 255 trick
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  u64 c;
  for (int i = 0; i < 4; ++i) {
    c = t.v[i] >> 51; t.v[i] &= FE_MASK; t.v[i + 1] += c;
  }
  t.v[4] &= FE_MASK;
  u64 w[4];
  w[0] = t.v[0] | (t.v[1] << 51);
  w[1] = (t.v[1] >> 13) | (t.v[2] << 38);
  w[2] = (t.v[2] >> 26) | (t.v[3] << 25);
  w[3] = (t.v[3] >> 39) | (t.v[4] << 12);
  memcpy(s, w, 32);
}

static inline void fe_add(fe* h, const fe* a, const fe* b) {
  for (int i = 0; i < 5; ++i) h->v[i] = a->v[i] + b->v[i];
  fe_carry(h);
}

// h = a - b (adds 2p to keep limbs non-negative)
static inline void fe_sub(fe* h, const fe* a, const fe* b) {
  static const u64 TWOP[5] = {0xfffffffffffdaULL, 0xffffffffffffeULL,
                              0xffffffffffffeULL, 0xffffffffffffeULL,
                              0xffffffffffffeULL};
  for (int i = 0; i < 5; ++i) h->v[i] = a->v[i] + TWOP[i] - b->v[i];
  fe_carry(h);
}

static inline void fe_neg(fe* h, const fe* a) {
  fe zero = {{0, 0, 0, 0, 0}};
  fe_sub(h, &zero, a);
}

static inline void fe_mul(fe* h, const fe* f, const fe* g) {
  const u64 *a = f->v, *b = g->v;
  u64 b1_19 = 19 * b[1], b2_19 = 19 * b[2], b3_19 = 19 * b[3],
      b4_19 = 19 * b[4];
  u128 c0 = (u128)a[0] * b[0] + (u128)a[1] * b4_19 + (u128)a[2] * b3_19 +
            (u128)a[3] * b2_19 + (u128)a[4] * b1_19;
  u128 c1 = (u128)a[0] * b[1] + (u128)a[1] * b[0] + (u128)a[2] * b4_19 +
            (u128)a[3] * b3_19 + (u128)a[4] * b2_19;
  u128 c2 = (u128)a[0] * b[2] + (u128)a[1] * b[1] + (u128)a[2] * b[0] +
            (u128)a[3] * b4_19 + (u128)a[4] * b3_19;
  u128 c3 = (u128)a[0] * b[3] + (u128)a[1] * b[2] + (u128)a[2] * b[1] +
            (u128)a[3] * b[0] + (u128)a[4] * b4_19;
  u128 c4 = (u128)a[0] * b[4] + (u128)a[1] * b[3] + (u128)a[2] * b[2] +
            (u128)a[3] * b[1] + (u128)a[4] * b[0];
  c1 += (u64)(c0 >> 51); c0 = (u64)c0 & FE_MASK;
  c2 += (u64)(c1 >> 51); c1 = (u64)c1 & FE_MASK;
  c3 += (u64)(c2 >> 51); c2 = (u64)c2 & FE_MASK;
  c4 += (u64)(c3 >> 51); c3 = (u64)c3 & FE_MASK;
  u64 carry = (u64)(c4 >> 51); c4 = (u64)c4 & FE_MASK;
  c0 += (u128)19 * carry;
  c1 += (u64)(c0 >> 51); c0 = (u64)c0 & FE_MASK;
  h->v[0] = (u64)c0; h->v[1] = (u64)c1; h->v[2] = (u64)c2;
  h->v[3] = (u64)c3; h->v[4] = (u64)c4;
}

static inline void fe_sq(fe* h, const fe* f) { fe_mul(h, f, f); }

static inline int fe_eq(const fe* a, const fe* b) {
  uint8_t sa[32], sb[32];
  fe_tobytes(sa, a);
  fe_tobytes(sb, b);
  return memcmp(sa, sb, 32) == 0;
}

static inline int fe_isneg(const fe* a) {
  uint8_t s[32];
  fe_tobytes(s, a);
  return s[0] & 1;
}

// x^((p-5)/8): square-and-multiply over the fixed 252-bit exponent
// 2^252 - 3 = 0b0111...1101 (249 ones, 0, 1) — simple MSB-first ladder.
static void fe_pow2523(fe* out, const fe* x) {
  // exponent (p-5)/8 = 2^252 - 3; bits MSB->LSB: bit 251..0, all ones
  // except bit 1.
  fe acc = *x;  // bit 251
  for (int i = 250; i >= 0; --i) {
    fe_sq(&acc, &acc);
    if (i != 1) fe_mul(&acc, &acc, x);
  }
  *out = acc;
}

static const uint8_t SQRT_M1_B[32] = {0xb0,0xa0,0x0e,0x4a,0x27,0x1b,0xee,0xc4,0x78,0xe4,0x2f,0xad,0x06,0x18,0x43,0x2f,0xa7,0xd7,0xfb,0x3d,0x99,0x00,0x4d,0x2b,0x0b,0xdf,0xc1,0x4f,0x80,0x24,0x83,0x2b};
static const uint8_t ED_D_B[32] = {0xa3,0x78,0x59,0x13,0xca,0x4d,0xeb,0x75,0xab,0xd8,0x41,0x41,0x4d,0x0a,0x70,0x00,0x98,0xe8,0x79,0x77,0x79,0x40,0xc7,0x8c,0x73,0xfe,0x6f,0x2b,0xee,0x6c,0x03,0x52};
static const uint8_t ONE_MINUS_D_SQ_B[32] = {0x76,0xc1,0x5f,0x94,0xc1,0x09,0x7c,0xe2,0x0f,0x35,0x5e,0xcd,0x38,0xa1,0x81,0x2c,0xe4,0xdf,0x70,0xbe,0xdd,0xab,0x94,0x99,0xd7,0xe0,0xb3,0xb2,0xa8,0x72,0x90,0x02};
static const uint8_t D_MINUS_ONE_SQ_B[32] = {0x20,0x4d,0xed,0x44,0xaa,0x5a,0xad,0x31,0x99,0x19,0x1e,0xb0,0x2c,0x4a,0x9e,0xd2,0xeb,0x4e,0x9b,0x52,0x2f,0xd3,0xdc,0x4c,0x41,0x22,0x6c,0xf6,0x7a,0xb3,0x68,0x59};
static const uint8_t SQRT_AD_MINUS_ONE_B[32] = {0x1b,0x2e,0x7b,0x49,0xa0,0xf6,0x97,0x7e,0xbd,0x54,0x78,0x1b,0x0c,0x8e,0x9d,0xaf,0xfd,0xd1,0xf5,0x31,0xc9,0xfc,0x3c,0x0f,0xac,0x48,0x83,0x2b,0xbf,0x31,0x69,0x37};

typedef struct { fe X, Y, Z, T; } ge;

// unified add-2008-hwcd-3 (a = -1), matches core/ristretto.py __add__
static void ge_add(ge* out, const ge* p, const ge* q) {
  fe A, B, C, Dv, E, F, G, H, t0, t1, d2;
  fe_frombytes(&d2, ED_D_B);
  fe_add(&d2, &d2, &d2);  // 2d
  fe_sub(&t0, &p->Y, &p->X);
  fe_sub(&t1, &q->Y, &q->X);
  fe_mul(&A, &t0, &t1);
  fe_add(&t0, &p->Y, &p->X);
  fe_add(&t1, &q->Y, &q->X);
  fe_mul(&B, &t0, &t1);
  fe_mul(&C, &p->T, &q->T);
  fe_mul(&C, &C, &d2);
  fe_mul(&Dv, &p->Z, &q->Z);
  fe_add(&Dv, &Dv, &Dv);
  fe_sub(&E, &B, &A);
  fe_sub(&F, &Dv, &C);
  fe_add(&G, &Dv, &C);
  fe_add(&H, &B, &A);
  fe_mul(&out->X, &E, &F);
  fe_mul(&out->Y, &G, &H);
  fe_mul(&out->Z, &F, &G);
  fe_mul(&out->T, &E, &H);
}

// RFC 9496 SQRT_RATIO_M1; returns was_square, r = sqrt(u/v) (or sqrt(i*u/v))
static int fe_sqrt_ratio(fe* r, const fe* u, const fe* v) {
  fe v3, v7, t, check, u_neg, u_neg_i, sqrtm1;
  fe_frombytes(&sqrtm1, SQRT_M1_B);
  fe_sq(&v3, v);
  fe_mul(&v3, &v3, v);        // v^3
  fe_sq(&v7, &v3);
  fe_mul(&v7, &v7, v);        // v^7
  fe_mul(&t, u, &v7);
  fe_pow2523(&t, &t);         // (u v^7)^((p-5)/8)
  fe_mul(r, u, &v3);
  fe_mul(r, r, &t);
  fe_sq(&check, r);
  fe_mul(&check, &check, v);  // v r^2
  fe_neg(&u_neg, u);
  fe_mul(&u_neg_i, &u_neg, &sqrtm1);
  int correct = fe_eq(&check, u);
  int flipped = fe_eq(&check, &u_neg);
  int flipped_i = fe_eq(&check, &u_neg_i);
  if (flipped | flipped_i) fe_mul(r, r, &sqrtm1);
  if (fe_isneg(r)) fe_neg(r, r);
  return correct | flipped;
}

// RFC 9496 MAP (one-way map), matches core/ristretto.py _elligator
static void ge_elligator(ge* out, const fe* t) {
  fe sqrtm1, d, one_minus_d_sq, d_minus_one_sq, sqrt_ad_minus_one;
  fe_frombytes(&sqrtm1, SQRT_M1_B);
  fe_frombytes(&d, ED_D_B);
  fe_frombytes(&one_minus_d_sq, ONE_MINUS_D_SQ_B);
  fe_frombytes(&d_minus_one_sq, D_MINUS_ONE_SQ_B);
  fe_frombytes(&sqrt_ad_minus_one, SQRT_AD_MINUS_ONE_B);
  fe one = {{1, 0, 0, 0, 0}};
  fe r, u, v, s, s_prime, c, n, w0, w1, w2, w3, tmp;
  fe_sq(&r, t);
  fe_mul(&r, &r, &sqrtm1);            // r = sqrt(-1) t^2
  fe_add(&u, &r, &one);
  fe_mul(&u, &u, &one_minus_d_sq);    // u = (r+1)(1-d^2)
  fe_neg(&v, &one);
  fe_mul(&tmp, &r, &d);
  fe_sub(&v, &v, &tmp);               // -1 - r d
  fe_add(&tmp, &r, &d);
  fe_mul(&v, &v, &tmp);               // v = (-1 - r d)(r + d)
  int was_square = fe_sqrt_ratio(&s, &u, &v);
  fe_mul(&s_prime, &s, t);
  if (!fe_isneg(&s_prime)) fe_neg(&s_prime, &s_prime);  // -ABS(s t)
  if (!was_square) { s = s_prime; c = r; }
  else { fe_neg(&c, &one); }
  fe_sub(&tmp, &r, &one);
  fe_mul(&n, &c, &tmp);
  fe_mul(&n, &n, &d_minus_one_sq);
  fe_sub(&n, &n, &v);                 // n = c (r-1) (d-1)^2 - v
  fe_mul(&w0, &s, &v);
  fe_add(&w0, &w0, &w0);              // w0 = 2 s v
  fe_mul(&w1, &n, &sqrt_ad_minus_one);
  fe_sq(&tmp, &s);
  fe_sub(&w2, &one, &tmp);            // 1 - s^2
  fe_add(&w3, &one, &tmp);            // 1 + s^2
  fe_mul(&out->X, &w0, &w3);
  fe_mul(&out->Y, &w2, &w1);
  fe_mul(&out->Z, &w1, &w3);
  fe_mul(&out->T, &w0, &w2);
}

// seeds: n 64-byte uniform strings; out: n points as 4 coords x 32 LE bytes
// (= the (n, 4, 16) uint16 layout of core/pedersen.py point arrays).
void ge_from_uniform_batch(const uint8_t* seeds, uint8_t* out, i64 n) {
  for (i64 i = 0; i < n; ++i) {
    fe t1, t2;
    fe_frombytes(&t1, seeds + 64 * i);
    fe_frombytes(&t2, seeds + 64 * i + 32);
    ge p1, p2, p;
    ge_elligator(&p1, &t1);
    ge_elligator(&p2, &t2);
    ge_add(&p, &p1, &p2);
    uint8_t* o = out + 128 * i;
    fe_tobytes(o, &p.X);
    fe_tobytes(o + 32, &p.Y);
    fe_tobytes(o + 64, &p.Z);
    fe_tobytes(o + 96, &p.T);
  }
}


// ===================================================================
// Single-core group layer over raw extended coords (X,Y,Z,T as 32-byte
// LE field elements each; 128 B/point).  This is the host stand-in for
// the reference engine's curve25519-dalek serial backend (same 51-bit
// limb schedule, same Pippenger window policy): it powers the
// NativeBackend CPU prover and the measured single-core baseline proxy
// (BASELINE.md).  All functions are variable-time (prover-side only).

static void ge_frombytes_raw(ge* p, const uint8_t* b) {
  fe_frombytes(&p->X, b);
  fe_frombytes(&p->Y, b + 32);
  fe_frombytes(&p->Z, b + 64);
  fe_frombytes(&p->T, b + 96);
}

static void ge_tobytes_raw(uint8_t* b, const ge* p) {
  fe_tobytes(b, &p->X);
  fe_tobytes(b + 32, &p->Y);
  fe_tobytes(b + 64, &p->Z);
  fe_tobytes(b + 96, &p->T);
}

static void ge_ident(ge* p) {
  for (int i = 0; i < 5; ++i) {
    p->X.v[i] = 0;
    p->Y.v[i] = 0;
    p->Z.v[i] = 0;
    p->T.v[i] = 0;
  }
  p->Y.v[0] = 1;
  p->Z.v[0] = 1;
}

// dbl-2008-hwcd (a = -1): cheaper than the unified add for P + P
static void ge_dbl(ge* out, const ge* p) {
  fe A, B, C, E, G, F, H, t;
  fe_sq(&A, &p->X);
  fe_sq(&B, &p->Y);
  fe_sq(&C, &p->Z);
  fe_add(&C, &C, &C);
  fe_add(&t, &p->X, &p->Y);
  fe_sq(&t, &t);
  fe_add(&E, &A, &B);
  fe_sub(&E, &t, &E);        // (X+Y)^2 - A - B
  fe_sub(&G, &B, &A);        // D + B with D = -A
  fe_sub(&F, &G, &C);
  fe_neg(&H, &A);
  fe_sub(&H, &H, &B);        // -(A + B)
  fe_mul(&out->X, &E, &F);
  fe_mul(&out->Y, &G, &H);
  fe_mul(&out->Z, &F, &G);
  fe_mul(&out->T, &E, &H);
}

static void ge_neg_pt(ge* out, const ge* p) {
  fe_neg(&out->X, &p->X);
  out->Y = p->Y;
  out->Z = p->Z;
  fe_neg(&out->T, &p->T);
}

static inline int sc_bit(const uint8_t* s, int i) {
  return (s[i >> 3] >> (i & 7)) & 1;
}

// width-w non-adjacent form of a 256-bit LE scalar; out has 257 digits
static void sc_wnaf(const uint8_t* s, int w, int8_t* out) {
  int val[257];
  for (int i = 0; i < 256; ++i) val[i] = sc_bit(s, i);
  val[256] = 0;
  for (int i = 0; i <= 256; ++i) out[i] = 0;
  int width = 1 << w;
  for (int i = 0; i <= 256 - 0; ) {
    if (i > 256) break;
    if (val[i] == 0) { ++i; continue; }
    // collect w bits
    int d = 0;
    for (int j = 0; j < w && i + j <= 256; ++j) d |= val[i + j] << j;
    if (d & (width >> 1)) {
      d -= width;
      // propagate carry
      int k = i + w;
      while (k <= 256 && val[k] == 1) { val[k] = 0; ++k; }
      if (k <= 256) val[k] = 1;
    }
    out[i] = (int8_t)d;
    for (int j = 0; j < w && i + j <= 256; ++j) val[i + j] = 0;
    i += w;
  }
}

// odd-multiple table {1P, 3P, ..., (2k-1)P}
static void ge_odd_table(const ge* p, ge* tbl, int k) {
  ge p2;
  ge_dbl(&p2, p);
  tbl[0] = *p;
  for (int i = 1; i < k; ++i) ge_add(&tbl[i], &tbl[i - 1], &p2);
}

static void ge_wnaf_accum(ge* acc, const int8_t* naf, const ge* tbl,
                          int idx) {
  int d = naf[idx];
  if (d > 0) {
    ge_add(acc, acc, &tbl[(d - 1) >> 1]);
  } else if (d < 0) {
    ge neg;
    ge_neg_pt(&neg, &tbl[(-d - 1) >> 1]);
    ge_add(acc, acc, &neg);
  }
}

// out[i] = s[i] * P[i]  (wNAF-5; scalars (n,4) u64 LE rows)
void ge_scalar_mul_vec(const uint8_t* coords, const u64* scalars,
                       uint8_t* out, i64 n) {
  int8_t naf[257];
  ge tbl[8];
  for (i64 i = 0; i < n; ++i) {
    ge p;
    ge_frombytes_raw(&p, coords + 128 * i);
    sc_wnaf((const uint8_t*)(scalars + 4 * i), 5, naf);
    int top = 256;
    while (top >= 0 && naf[top] == 0) --top;
    ge acc;
    ge_ident(&acc);
    if (top >= 0) {
      ge_odd_table(&p, tbl, 8);
      for (int j = top; j >= 0; --j) {
        if (j != top) ge_dbl(&acc, &acc);
        ge_wnaf_accum(&acc, naf, tbl, j);
      }
    }
    ge_tobytes_raw(out + 128 * i, &acc);
  }
}

// out[i] = cL * L[i] + cR * R[i]  (the dalek IPP generator fold,
// interleaved wNAF-5 double-scalar multiplication per element)
void ge_fold_vec(const uint8_t* L, const uint8_t* R, const u64 cL[4],
                 const u64 cR[4], uint8_t* out, i64 n) {
  int8_t nafL[257], nafR[257];
  sc_wnaf((const uint8_t*)cL, 5, nafL);
  sc_wnaf((const uint8_t*)cR, 5, nafR);
  int top = 256;
  while (top >= 0 && nafL[top] == 0 && nafR[top] == 0) --top;
  ge tl[8], tr[8];
  for (i64 i = 0; i < n; ++i) {
    ge pl, pr, acc;
    ge_frombytes_raw(&pl, L + 128 * i);
    ge_frombytes_raw(&pr, R + 128 * i);
    ge_ident(&acc);
    if (top >= 0) {
      ge_odd_table(&pl, tl, 8);
      ge_odd_table(&pr, tr, 8);
      for (int j = top; j >= 0; --j) {
        if (j != top) ge_dbl(&acc, &acc);
        ge_wnaf_accum(&acc, nafL, tl, j);
        ge_wnaf_accum(&acc, nafR, tr, j);
      }
    }
    ge_tobytes_raw(out + 128 * i, &acc);
  }
}

// out[i] = sL[i] * L[i] + sR[i] * R[i]  (round-1 fold: the outer
// protocol's G/H factors make the fold scalars per-element)
void ge_fold_vec_var(const uint8_t* L, const uint8_t* R, const u64* sL,
                     const u64* sR, uint8_t* out, i64 n) {
  int8_t nafL[257], nafR[257];
  ge tl[8], tr[8];
  for (i64 i = 0; i < n; ++i) {
    sc_wnaf((const uint8_t*)(sL + 4 * i), 5, nafL);
    sc_wnaf((const uint8_t*)(sR + 4 * i), 5, nafR);
    int top = 256;
    while (top >= 0 && nafL[top] == 0 && nafR[top] == 0) --top;
    ge pl, pr, acc;
    ge_frombytes_raw(&pl, L + 128 * i);
    ge_frombytes_raw(&pr, R + 128 * i);
    ge_ident(&acc);
    if (top >= 0) {
      ge_odd_table(&pl, tl, 8);
      ge_odd_table(&pr, tr, 8);
      for (int j = top; j >= 0; --j) {
        if (j != top) ge_dbl(&acc, &acc);
        ge_wnaf_accum(&acc, nafL, tl, j);
        ge_wnaf_accum(&acc, nafR, tr, j);
      }
    }
    ge_tobytes_raw(out + 128 * i, &acc);
  }
}

// Pippenger MSM (the reference engine's window policy: dalek's
// size-picked windows).  scalars: (n, 4) u64 LE rows; out: one point.
void ge_msm(const u64* scalars, const uint8_t* coords, i64 n,
            uint8_t* out) {
  ge acc;
  ge_ident(&acc);
  if (n == 0) {
    ge_tobytes_raw(out, &acc);
    return;
  }
  int w = n < 32 ? 3 : (n < 500 ? 6 : (n < 800 ? 7 : 8));
  int nb = 1 << w;
  int nwin = (253 + w - 1) / w;
  ge* pts = new ge[n];
  for (i64 i = 0; i < n; ++i) ge_frombytes_raw(&pts[i], coords + 128 * i);
  ge* buckets = new ge[nb];
  for (int win = nwin - 1; win >= 0; --win) {
    if (win != nwin - 1)
      for (int j = 0; j < w; ++j) ge_dbl(&acc, &acc);
    for (int b = 1; b < nb; ++b) ge_ident(&buckets[b]);
    int shift = win * w;
    for (i64 i = 0; i < n; ++i) {
      const uint8_t* s = (const uint8_t*)(scalars + 4 * i);
      int d = 0;
      for (int j = 0; j < w && shift + j < 256; ++j)
        d |= sc_bit(s, shift + j) << j;
      if (d) ge_add(&buckets[d], &buckets[d], &pts[i]);
    }
    ge run, win_sum;
    ge_ident(&run);
    ge_ident(&win_sum);
    for (int b = nb - 1; b >= 1; --b) {
      ge_add(&run, &run, &buckets[b]);
      ge_add(&win_sum, &win_sum, &run);
    }
    ge_add(&acc, &acc, &win_sum);
  }
  delete[] pts;
  delete[] buckets;
  ge_tobytes_raw(out, &acc);
}

// point-add / double microbenchmark atoms (baseline roofline)
void ge_bench(i64 reps, uint8_t inout[128], int op) {
  ge p;
  ge_frombytes_raw(&p, inout);
  if (op == 0) {
    ge q = p;
    for (i64 i = 0; i < reps; ++i) ge_add(&p, &p, &q);
  } else {
    for (i64 i = 0; i < reps; ++i) ge_dbl(&p, &p);
  }
  ge_tobytes_raw(inout, &p);
}

}  // extern "C"
