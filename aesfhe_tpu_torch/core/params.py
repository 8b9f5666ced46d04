"""CKKS parameter sets (host numpy).  Counterpart of
`aesfhe_tpu/core/params.py`; the prime chains, digit groups and every table
equal the reference's.

The modulus chain is a list of NTT-friendly primes <= 2^30:

  primes[0]            ~2^30   decryption headroom prime
  primes[1..max_level] ~Delta  rescale primes, alternating above/below Delta
  special_primes       ~2^30   hybrid key-switch auxiliary modulus P
"""
from __future__ import annotations

import functools

import numpy as np

from . import ntt, rns


class CKKSParams:
    """Static parameter set + precomputed host tables (hash/eq by identity,
    so it can key caches)."""

    def __init__(self, n: int, max_level: int, scale_bits: int,
                 first_prime_bits: int = 30, special_prime_bits: int = 30,
                 num_special_primes: int = 2, alpha: int | None = None,
                 error_std: float = 3.2, secret_hamming: int | None = None):
        assert n & (n - 1) == 0
        self.n = n
        self.logn = n.bit_length() - 1
        self.slot_count = n // 2
        self.max_level = max_level
        self.scale_bits = scale_bits
        self.scale = float(2 ** scale_bits)
        self.error_std = error_std
        self.secret_hamming = secret_hamming
        two_n = 2 * n

        # scales above 2^29 use pairs of half-size primes per rescale
        self.rescale_primes = 1 if scale_bits <= 29 else 2
        r = self.rescale_primes
        assert scale_bits <= 58, "scale above 2^58 unsupported"
        half_bits = scale_bits if r == 1 else (scale_bits + 1) // 2
        first = rns.find_ntt_primes(first_prime_bits, two_n, r)
        rescale = rns.find_ntt_primes(half_bits, two_n, r * max_level,
                                      skip=tuple(first))
        specials = rns.find_ntt_primes(special_prime_bits, two_n,
                                       num_special_primes,
                                       skip=tuple(first) + tuple(rescale))
        self.q_primes = tuple(first + rescale)
        self.top_level = len(self.q_primes) - 1
        self.special_primes = tuple(specials)
        self.all_primes = self.q_primes + self.special_primes
        self.num_q = len(self.q_primes)
        self.num_special = len(self.special_primes)
        self.L_tot = len(self.all_primes)
        assert all(q <= (1 << 30) for q in self.all_primes)

        # digit groups of the hybrid key-switch; P must dominate each Qt_j
        alpha = num_special_primes if alpha is None else alpha
        self.alpha = alpha
        self.groups = [list(range(g0, min(g0 + alpha, self.num_q)))
                       for g0 in range(0, self.num_q, alpha)]
        self.dnum = len(self.groups)
        P = 1
        for p in self.special_primes:
            P *= p
        for grp in self.groups:
            qt = 1
            for i in grp:
                qt *= self.q_primes[i]
            assert qt < P, (
                "digit product exceeds special modulus P; "
                "increase num_special_primes or reduce alpha")

        self.tables = ntt.NTTTables(n, self.all_primes)

        qinv = np.zeros(self.L_tot, dtype=np.uint32)
        r2 = np.zeros(self.L_tot, dtype=np.uint32)
        magic = np.zeros(self.L_tot, dtype=np.uint32)
        rinv = np.zeros(self.L_tot, dtype=np.uint32)
        for i, q in enumerate(self.all_primes):
            qinv[i], r2[i] = rns.montgomery_consts(q)
            magic[i] = rns.barrett_magic(q)
            rinv[i] = rns.mont_rinv(q)
        self.q_arr = np.asarray(self.all_primes, dtype=np.uint32)
        self.qinv_arr = qinv
        self.r2_arr = r2
        self.magic_arr = magic
        self.rinv_arr = rinv

        # output slot i of the NTT holds the evaluation at psi^sigma[i]
        self.sigma = (2 * ntt.bit_reverse_perm(n) + 1).astype(np.int64)
        pos = np.zeros(two_n, dtype=np.int64)
        pos[self.sigma] = np.arange(n)
        self.pos_of_exp = pos
        # CKKS slot j lives at exponent 5^j mod 2N, its conjugate at 2N - 5^j
        slot_exp = np.zeros(self.slot_count, dtype=np.int64)
        e = 1
        for j in range(self.slot_count):
            slot_exp[j] = e
            e = (e * 5) % two_n
        self.slot_exp = slot_exp
        self.slot_pos = pos[slot_exp]
        self.conj_slot_pos = pos[(two_n - slot_exp) % two_n]

        # eval slots where X^(N/2) = -zeta4, and zeta4 = psi^(N/2) per prime
        self.xhalf_sign_neg = (self.sigma % 4) == 3
        zeta4 = np.zeros(self.L_tot, dtype=np.uint64)
        for i, q in enumerate(self.all_primes):
            zeta4[i] = pow(self.tables.psi[i], n // 2, q)
        self.zeta4 = zeta4

        k = np.arange(n)
        self.psi_c_pow = np.exp(1j * np.pi * k / n)
        self.psi_c_pow_inv = np.exp(-1j * np.pi * k / n)

        self._galois_perm_cache: dict[int, np.ndarray] = {}
        self._ks_tables_cache: dict[int, dict] = {}
        self._md_tables_cache: dict[int, dict] = {}

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    # ------------------------------------------------------------------
    def galois_perm(self, g: int) -> np.ndarray:
        """Eval-domain gather indices for X -> X^g: out[i] = in[perm[i]],
        perm[i] = pos[(sigma[i]*g) mod 2N]."""
        g = g % (2 * self.n)
        if g not in self._galois_perm_cache:
            tgt = (self.sigma * g) % (2 * self.n)
            self._galois_perm_cache[g] = self.pos_of_exp[tgt].astype(np.int32)
        return self._galois_perm_cache[g]

    def rot_galois_elt(self, steps: int) -> int:
        """Galois element with rotate(ct, steps) == np.roll(slots, steps)."""
        return pow(5, (-steps) % self.slot_count, 2 * self.n)

    @property
    def conj_galois_elt(self) -> int:
        return 2 * self.n - 1

    # ------------------------------------------------------------------
    def active_primes(self, level: int) -> tuple[int, ...]:
        return self.q_primes[:level + 1]

    def ks_tables(self, level: int) -> dict:
        """Per-level basis-extension constants of the hybrid key-switch: for
        each digit group j (its primes active at `level`), Qt_j = product of
        its primes, inv[j][i] = (Qt_j/q_i)^-1 mod q_i, conv[j][i][m] =
        (Qt_j/q_i) mod basis_m, basis = active q primes + specials."""
        if level in self._ks_tables_cache:
            return self._ks_tables_cache[level]
        basis = [self.all_primes[i] for i in range(level + 1)] + \
            list(self.special_primes)
        groups = [[i for i in grp if i <= level] for grp in self.groups]
        groups = [g for g in groups if g]
        out_groups = []
        for grp in groups:
            qt = 1
            for i in grp:
                qt *= self.q_primes[i]
            inv_w = np.zeros(len(grp), dtype=np.uint32)
            inv_sh = np.zeros(len(grp), dtype=np.uint32)
            conv_w = np.zeros((len(grp), len(basis)), dtype=np.uint32)
            conv_sh = np.zeros((len(grp), len(basis)), dtype=np.uint32)
            for a, i in enumerate(grp):
                qi = self.q_primes[i]
                hat = qt // qi
                w = pow(hat % qi, -1, qi)
                inv_w[a] = w
                inv_sh[a] = rns.shoup_precompute(w, qi)
                for m, qm in enumerate(basis):
                    hm = hat % qm
                    conv_w[a, m] = hm
                    conv_sh[a, m] = rns.shoup_precompute(hm, qm)
            out_groups.append(dict(limbs=grp, inv_w=inv_w, inv_sh=inv_sh,
                                   conv_w=conv_w, conv_sh=conv_sh))
        tabs = dict(basis=np.asarray(basis, dtype=np.uint32), groups=out_groups)
        self._ks_tables_cache[level] = tabs
        return tabs

    def md_tables(self, level: int) -> dict:
        """Per-level constants of the fused special-prime mod-down:
        inv[i] = (P/p_i)^-1 mod p_i, conv[i][m] = (P/p_i) mod q_m,
        pinv[m] = P^-1 mod q_m, pmod[m] = P mod q_m (with Shoup pairs)."""
        if level in self._md_tables_cache:
            return self._md_tables_cache[level]
        K = self.num_special
        lp1 = level + 1
        P = 1
        for p in self.special_primes:
            P *= p
        inv_w = np.zeros(K, dtype=np.uint32)
        inv_sh = np.zeros(K, dtype=np.uint32)
        conv_w = np.zeros((K, lp1), dtype=np.uint32)
        conv_sh = np.zeros((K, lp1), dtype=np.uint32)
        pinv_w = np.zeros(lp1, dtype=np.uint32)
        pinv_sh = np.zeros(lp1, dtype=np.uint32)
        pmod_w = np.zeros(lp1, dtype=np.uint32)
        pmod_sh = np.zeros(lp1, dtype=np.uint32)
        for i, p in enumerate(self.special_primes):
            hat = P // p
            w = pow(hat % p, -1, p)
            inv_w[i] = w
            inv_sh[i] = rns.shoup_precompute(w, p)
            for m in range(lp1):
                qm = self.q_primes[m]
                hm = hat % qm
                conv_w[i, m] = hm
                conv_sh[i, m] = rns.shoup_precompute(hm, qm)
        for m in range(lp1):
            qm = self.q_primes[m]
            w = pow(P % qm, -1, qm)
            pinv_w[m] = w
            pinv_sh[m] = rns.shoup_precompute(w, qm)
            pm = P % qm
            pmod_w[m] = pm
            pmod_sh[m] = rns.shoup_precompute(pm, qm)
        tabs = dict(inv_w=inv_w, inv_sh=inv_sh, conv_w=conv_w,
                    conv_sh=conv_sh, pinv_w=pinv_w, pinv_sh=pinv_sh,
                    pmod_w=pmod_w, pmod_sh=pmod_sh)
        self._md_tables_cache[level] = tabs
        return tabs


_PROFILES = dict(
    tiny=dict(n=1 << 10, max_level=8, scale_bits=26, num_special_primes=2),
    test=dict(n=1 << 12, max_level=16, scale_bits=26, num_special_primes=3),
    # small insecure ring with a long chain: full AES rounds without bootstrap
    deep=dict(n=1 << 12, max_level=48, scale_bits=28, num_special_primes=6),
    hp=dict(n=1 << 12, max_level=14, scale_bits=52, num_special_primes=3),
    prod=dict(n=1 << 16, max_level=35, scale_bits=27, num_special_primes=6),
    boot_tiny=dict(n=1 << 9, max_level=82, scale_bits=27,
                   first_prime_bits=30, num_special_primes=4,
                   secret_hamming=16),
    # the flagship's bootstrappable chain: N=2^16, 54 levels, dnum 7, h=192
    prod_boot=dict(n=1 << 16, max_level=54, scale_bits=27,
                   num_special_primes=8, secret_hamming=192),
    prod_hp=dict(n=1 << 16, max_level=24, scale_bits=52,
                 num_special_primes=6),
)


@functools.lru_cache(maxsize=None)
def get_params(profile: str = "test") -> CKKSParams:
    return CKKSParams(**_PROFILES[profile])
