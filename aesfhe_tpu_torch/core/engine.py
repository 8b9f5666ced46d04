"""The CKKS Engine on torch.  Counterpart of `aesfhe_tpu/core/engine.py`
(the part the AES pipelines and the bootstrap call).

Scale/level policy as in the reference: every multiply relinearizes (when a
relin key is given) and rescales, so `level` drops by one per depth; adds
align operand levels and scales with exact scale tracking.

The engine owns its device and a `numpy.random.Generator` (or a
`keys.OSEntropyRNG`), from which keygen and encryption noise are drawn in
the reference's order.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import dev_encoding, encoding, ops_impl, rns
from . import keys as keys_mod
from .ciphertext import Ciphertext, Plaintext, ScalarPlaintext
from .keys import GaloisKeySet, PublicKey, SecretKey, SwitchKey
from .params import CKKSParams, get_params

# A scale mismatch above _SCALE_TOL triggers an alignment (one level); one
# up to _SCALE_ACCEPT is a harmless value error at sites that cannot align.
_SCALE_TOL = 1e-7
_SCALE_ACCEPT = 1e-7


def resolve_device(device) -> torch.device:
    """The engine's device; CUDA unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def _encrypt_core(params, tabs, pk_b, pk_a, m_eval, v_eval, e0_eval, e1_eval):
    tr = ops_impl._q_tr(params, tabs, params.top_level)
    q = tr.q.reshape(-1, 1)
    ri = tr.rinv.reshape(-1, 1)
    v = v_eval.long()
    c0 = rns.add_mod(rns.add_mod(rns.mont_mul(v, pk_b.long(), q, ri),
                                 e0_eval.long(), q), m_eval.long(), q)
    c1 = rns.add_mod(rns.mont_mul(v, pk_a.long(), q, ri), e1_eval.long(), q)
    return torch.stack([c0, c1]).int()


def _decrypt_core(params, tabs, data, s_eval):
    """-> int32 coefficient residues [l+1, N] (standard domain)."""
    level = data.shape[1] - 1
    tr = ops_impl._q_tr(params, tabs, level)
    q = tr.q.reshape(-1, 1)
    ri = tr.rinv.reshape(-1, 1)
    s = s_eval[:level + 1].long()
    acc = data[0].long()
    spow = s
    for i in range(1, data.shape[0]):
        acc = rns.add_mod(acc, rns.mont_mul(data[i].long(), spow, q, ri), q)
        if i + 1 < data.shape[0]:
            spow = rns.mont_mul(spow, s, q, ri)
    return ops_impl.intt_rows(acc, tr, from_mont=True, out_dtype=torch.int32)


def _encode_core(params, tabs, residues, level: int):
    """Plain residues int64 [L, N] -> Montgomery eval int32."""
    tr = ops_impl._q_tr(params, tabs, level)
    return ops_impl.ntt_rows(residues, tr, to_mont=True, out_dtype=torch.int32)


def _digits_batch_core(params, tabs, payloads, level: int):
    """Exact encode from base-2^22 digits, batched: payloads [K, 5, N]
    (four digit rows + a sign row each, encoding.coeffs_to_digits) ->
    Montgomery-eval plaintexts int32 [K, level+1, N]; per prime
    r_i = +-(sum_k d_k (2^(22k) mod q_i)) mod q_i, then Montgomery + NTT."""
    tr = ops_impl._q_tr(params, tabs, level)
    q = tr.q.reshape(1, -1, 1)
    primes = [int(p) for p in params.q_primes[:level + 1]]
    w = tabs.const(("digit_w", level),
                   lambda: [[pow(1 << 22, k, p) for p in primes]
                            for k in range(4)])                 # [4, L]
    pay = torch.as_tensor(np.asarray(payloads, dtype=np.int64),
                          device=tabs.device)
    acc = None
    for k in range(4):
        term = rns.shoup_mul(pay[:, k, None, :], w[k].reshape(1, -1, 1), q)
        acc = term if acc is None else rns.add_mod(acc, term, q)
    res = torch.where(pay[:, 4, None, :] != 0, rns.neg_mod(acc, q), acc)
    return ops_impl.ntt_rows(res, tr, to_mont=True, out_dtype=torch.int32)


def _digits_encode_core(params, tabs, payload, level: int):
    """One [5, N] digit payload -> Montgomery-eval plaintext [level+1, N]."""
    return _digits_batch_core(params, tabs, np.asarray(payload)[None],
                              level)[0]


class Engine:
    """Parameter-owning CKKS engine on one torch device."""

    def __init__(self, params: CKKSParams | None = None, *,
                 profile: str | None = None, device="cuda",
                 rng: np.random.Generator | None = None):
        if params is None:
            params = get_params(profile or "test")
        self.params = params
        self.device = resolve_device(device)
        self.rng = keys_mod.default_rng() if rng is None else rng
        self.tabs = ops_impl.DeviceTables(params, self.device)
        # the bootstrap's phase times and the bit-sliced round's stage
        # times in ns, added while a profiler records
        # (bootstrap._PhaseTimer, trace.stage)
        self.counters = {k: 0 for k in
                         ("ct_mul", "pt_mul", "scalar_mul", "add", "rescale",
                          "keyswitch", "rotate", "conjugate", "bootstrap",
                          "boot.cts_ns", "boot.evalmod_ns", "boot.stc_ns",
                          "aes.sub_bytes_ns", "aes.shift_mix_ns")}
        self._perm_cache: dict[int, torch.Tensor] = {}
        self._trivial_cache: dict = {}
        self._consts_cache: dict = {}

    def _perm_dev(self, g: int) -> torch.Tensor:
        p = self._perm_cache.get(g)
        if p is None:
            p = torch.as_tensor(self.params.galois_perm(g).astype(np.int64),
                                device=self.device)
            self._perm_cache[g] = p
        return p

    def reset_counters(self):
        for k in self.counters:
            self.counters[k] = 0

    def _count(self, key, n=1):
        self.counters[key] += n

    # ----- key-switch routing hooks ------------------------------------
    # Every key-switch of the engine (relinearize, rotate, conjugate, the
    # hoisted rotations, hence the bootstrap) goes through these four
    # methods; parallel.mesh_engine.MeshEngine overrides all four with the
    # digit-sharded collective versions.
    def _relin_data(self, data, key: SwitchKey):
        """Relinearize degree-2 data [3, l+1, N] -> [2, l+1, N]."""
        b, a = ops_impl.keyswitch(self.params, self.tabs, data[2], key.b,
                                  key.a, key.cap)
        q = ops_impl._q_tr(self.params, self.tabs,
                           data.shape[1] - 1).q.reshape(-1, 1)
        return torch.stack([rns.add_mod(data[0].long(), b.long(), q),
                            rns.add_mod(data[1].long(), a.long(), q)]).int()

    def _galois_data(self, data, g: int, key: SwitchKey):
        """Apply automorphism g to degree-1 data and switch back under s."""
        perm = self._perm_dev(g)
        p0 = data[0][..., perm]
        b, a = ops_impl.keyswitch(self.params, self.tabs, data[1][..., perm],
                                  key.b, key.a, key.cap)
        q = ops_impl._q_tr(self.params, self.tabs,
                           data.shape[1] - 1).q.reshape(-1, 1)
        return torch.stack([rns.add_mod(p0.long(), b.long(), q).int(), a])

    def adopt_key(self, key):
        """What this engine keeps of a switch key: the key itself (a mesh
        engine keeps its rank's digit shard)."""
        return key

    def _hoist_decompose(self, c1):
        """Shared key-switch digit decomposition of a c1 polynomial."""
        return ops_impl.ks_decompose(self.params, self.tabs, c1)

    def _hoist_apply(self, data, d_eval, g: int, key: SwitchKey):
        """One Galois application given the shared decomposition d_eval."""
        return ops_impl.hoisted_rotate(self.params, self.tabs, data, d_eval,
                                       self._perm_dev(g), key.b, key.a,
                                       key.cap)

    # ------------------------------------------------------------------
    @property
    def slot_count(self) -> int:
        return self.params.slot_count

    @property
    def max_level(self) -> int:
        return self.params.max_level

    # ----- key generation ---------------------------------------------
    def create_secret_key(self) -> SecretKey:
        return keys_mod.gen_secret_key(self.params, self.tabs, self.rng)

    def create_public_key(self, sk: SecretKey) -> PublicKey:
        return keys_mod.gen_public_key(self.params, self.tabs, sk, self.rng)

    def create_relinearization_key(self, sk: SecretKey) -> SwitchKey:
        return keys_mod.gen_relin_key(self.params, self.tabs, sk, self.rng)

    def create_conjugation_key(self, sk: SecretKey) -> SwitchKey:
        return keys_mod.gen_galois_key(self.params, self.tabs, sk,
                                       self.params.conj_galois_elt, self.rng)

    def create_rotation_key(self, sk: SecretKey) -> GaloisKeySet:
        return keys_mod.gen_rotation_keys(self.params, self.tabs, sk, self.rng)

    def create_fixed_rotation_key(self, sk: SecretKey,
                                  steps: Sequence[int]) -> GaloisKeySet:
        return keys_mod.gen_rotation_keys(self.params, self.tabs, sk,
                                          self.rng, list(steps))

    def create_small_bootstrap_key(self, sk: SecretKey, rot=None,
                                   hi_prec: bool | None = None):
        from .. import bootstrap as _bs
        return _bs.create_bootstrap_key(self, sk, small=True, rot=rot,
                                        hi_prec=hi_prec)

    def create_bootstrap_key(self, sk: SecretKey, rot=None,
                             hi_prec: bool | None = None):
        from .. import bootstrap as _bs
        return _bs.create_bootstrap_key(self, sk, small=False, rot=rot,
                                        hi_prec=hi_prec)

    # ----- encode / encrypt / decrypt ---------------------------------
    def encode(self, vec, level: int | None = None,
               scale: float | None = None, device: bool = False) -> Plaintext:
        """device=True runs the embedding on the engine's device (c64 FFT,
        core/dev_encoding.py); the default host path is exact (f64 FFT and
        the digit-CRT reduction)."""
        level = self.params.top_level if level is None else level
        scale = self.params.scale if scale is None else scale
        if device:
            data = dev_encoding.encode_eval_dev(self.params, self.tabs, vec,
                                                level, scale)
            return Plaintext(data=data, scale=scale)
        data = _digits_encode_core(self.params, self.tabs,
                                   self.encode_payload(vec, scale), level)
        return Plaintext(data=data, scale=scale)

    def encode_payload(self, vec, scale: float) -> np.ndarray:
        """Host half of the exact encode: embedding FFT + base-2^22 digit
        split -> [5, N] uint32 (4 digit rows + sign row)."""
        coeffs = encoding.slots_to_coeffs(np.asarray(vec), self.params, scale)
        digits, neg = encoding.coeffs_to_digits(coeffs)
        return np.concatenate([digits, neg[None].astype(np.uint32)])

    def payload_to_plaintext(self, payload: np.ndarray, level: int,
                             scale: float) -> Plaintext:
        """Device half of the exact encode: per-prime CRT of the digit
        payload + Montgomery + NTT."""
        return Plaintext(_digits_encode_core(self.params, self.tabs, payload,
                                             level), scale)

    def materialize_payloads(self, payloads, level: int) -> torch.Tensor:
        """[K, 5, N] digit payloads (a list or a stack) -> [K, level+1, N]
        Montgomery-eval plaintext stack, the input of fused_ptd_sum."""
        return _digits_batch_core(self.params, self.tabs, np.stack(payloads),
                                  level)

    def encrypt(self, data, pk: PublicKey, device: bool = False) -> Ciphertext:
        params = self.params
        arr = np.asarray(data)
        if device:
            m_eval = dev_encoding.encode_eval_dev(params, self.tabs, arr,
                                                  params.top_level,
                                                  params.scale)
        else:
            pt = encoding.slots_to_coeffs(arr, params, params.scale)
            m_res = encoding.coeffs_to_rns(pt, params.q_primes)
            m_eval = _encode_core(params, self.tabs,
                                  torch.as_tensor(m_res.astype(np.int64),
                                                  device=self.device),
                                  params.top_level)
        rows = np.arange(params.num_q)
        v = keys_mod._sample_ternary(self.rng, params.n)
        e0 = keys_mod._sample_gauss(self.rng, params.n, params.error_std)
        e1 = keys_mod._sample_gauss(self.rng, params.n, params.error_std)
        evals = [keys_mod._to_eval(params, self.tabs,
                                   keys_mod._int_to_rns(x, params.q_primes),
                                   rows) for x in (v, e0, e1)]
        data_dev = _encrypt_core(params, self.tabs, pk.b, pk.a, m_eval, *evals)
        return Ciphertext(data=data_dev, scale=params.scale)

    def decrypt(self, ct: Ciphertext, sk: SecretKey,
                device: bool = False) -> np.ndarray:
        params = self.params
        residues = _decrypt_core(params, self.tabs, ct.data, sk.s_eval)
        # the device decode (exact 2-limb Garner + c64 IFFT) holds while
        # |coeff| < q0*q1/2 and the f32 error stays below the decode
        # margin; a pre-rescale product breaks both and takes the host path
        if device and ct.level >= 1 and \
                ct.scale <= params.scale * (1.0 + 1e-6):
            ri = dev_encoding._decode_slots_dev(params, residues[:2],
                                                float(ct.scale)).cpu().numpy()
            return ri[0] + 1j * ri[1]
        res = residues.cpu().numpy().astype(np.uint64)
        vals = rns.crt_to_centered_float(res, params.active_primes(ct.level))
        return encoding.coeffs_to_slots(vals, params, ct.scale)

    # ----- level/scale alignment --------------------------------------
    def _drop(self, ct: Ciphertext, level: int) -> Ciphertext:
        if ct.level == level:
            return ct
        assert ct.level > level
        return Ciphertext(ops_impl.ct_drop_to(self.params, ct.data, level),
                          ct.scale)

    def _min_mul_level(self) -> int:
        # keep `rescale_primes` bottom primes for decryption headroom
        return 2 * self.params.rescale_primes - 1

    def _check_levels(self, lvl: int):
        if lvl < self._min_mul_level():
            raise RuntimeError("out of levels: bootstrap required")

    def _rescale(self, ct: Ciphertext) -> Ciphertext:
        """Drop one scale unit: one prime, or on paired-prime profiles the
        fused pair rescale."""
        if self.params.rescale_primes == 2:
            return self._rescale_pair(ct)
        self._count("rescale")
        ql = self.params.q_primes[ct.level]
        data = ops_impl.ct_rescale(self.params, self.tabs, ct.data)
        return Ciphertext(data, ct.scale / ql)

    def _rescale_pair(self, ct: Ciphertext) -> Ciphertext:
        """Drop two primes with one rounding (ops_impl.ct_rescale_pair): the
        rescale of every product of the bootstrap's hi-precision tier."""
        self._count("rescale")
        qa = float(self.params.q_primes[ct.level])
        qb = float(self.params.q_primes[ct.level - 1])
        data = ops_impl.ct_rescale_pair(self.params, self.tabs, ct.data)
        return Ciphertext(data, ct.scale / (qa * qb))

    def _scalar_mul_consts(self, value: complex, scale: float, level: int,
                           mont: bool) -> torch.Tensor:
        """Per-limb encodings of a slot-constant complex value: Shoup form
        [l+1, 4] (re_w, re_sh, imz_w, imz_sh) or Montgomery form [l+1, 2]
        (re_m, imz_m); cached per (value, scale, level, mont)."""
        ck = (complex(value), float(scale), level, mont)
        hit = self._consts_cache.get(ck)
        if hit is not None:
            return hit
        params = self.params
        re_i = int(round(value.real * scale))
        im_i = int(round(value.imag * scale))
        out = np.zeros((level + 1, 2 if mont else 4), dtype=np.uint32)
        for i in range(level + 1):
            q = params.q_primes[i]
            re_q = re_i % q
            imz_q = (im_i * int(params.zeta4[i])) % q
            if mont:
                out[i, 0] = (re_q << 32) % q
                out[i, 1] = (imz_q << 32) % q
            else:
                out[i, 0] = re_q
                out[i, 1] = rns.shoup_precompute(re_q, q)
                out[i, 2] = imz_q
                out[i, 3] = rns.shoup_precompute(imz_q, q)
        dev = rns.narrow(torch.as_tensor(out.astype(np.int64),
                                         device=self.device))
        self._consts_cache[ck] = dev
        while len(self._consts_cache) > 4096:
            self._consts_cache.pop(next(iter(self._consts_cache)))
        return dev

    def _adjust_scale(self, ct: Ciphertext, target_scale: float) -> Ciphertext:
        """Multiply by 1.0 encoded at sigma so the rescaled scale is ~target
        (one level); the returned scale is the true one,
        ct.scale * round(sigma) / q (see _true_sigma)."""
        self._check_levels(ct.level)
        qprod = 1.0
        for i in range(self.params.rescale_primes):
            qprod *= self.params.q_primes[ct.level - i]
        sigma = target_scale * qprod / ct.scale
        consts = self._scalar_mul_consts(1.0 + 0j, sigma, ct.level, mont=False)
        data = ops_impl.ct_mul_scalar_pt(self.params, self.tabs, ct.data,
                                         consts)
        return self._rescale(Ciphertext(data, ct.scale * round(sigma)))

    def _align_add(self, a: Ciphertext, b: Ciphertext):
        lvl = min(a.level, b.level)
        a = self._drop(a, lvl)
        b = self._drop(b, lvl)
        if abs(a.scale - b.scale) / max(a.scale, b.scale) > _SCALE_TOL:
            if a.scale > b.scale:
                a = self._adjust_scale(a, b.scale)
                b = self._drop(b, a.level)
            else:
                b = self._adjust_scale(b, a.scale)
                a = self._drop(a, b.level)
        return a, b

    # ----- arithmetic --------------------------------------------------
    def add(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Ciphertext):
            a, b = self._align_add(a, b)
            if a.degree != b.degree:
                if a.degree < b.degree:
                    a, b = b, a
                pad = torch.zeros((a.degree - b.degree,) + b.data.shape[1:],
                                  dtype=b.data.dtype, device=b.data.device)
                b = Ciphertext(torch.cat([b.data, pad]), b.scale)
            return Ciphertext(ops_impl.ct_add(self.params, self.tabs,
                                              a.data, b.data), a.scale)
        if isinstance(b, Plaintext):
            return self._add_dense_pt(a, b.data[:a.level + 1], b.scale)
        if isinstance(b, ScalarPlaintext):
            return self._add_scalar(a, b.value, b.scale)
        if np.isscalar(b):
            return self._add_scalar(a, complex(b), a.scale)
        pt = self.encode(np.asarray(b), level=a.level, scale=a.scale)
        return self._add_dense_pt(a, pt.data, pt.scale)

    def _add_dense_pt(self, a: Ciphertext, pt_data, pt_scale) -> Ciphertext:
        if abs(a.scale - pt_scale) / max(a.scale, pt_scale) > _SCALE_ACCEPT:
            raise ValueError("plaintext scale mismatch in add")
        q = ops_impl._q_tr(self.params, self.tabs,
                           a.level).q.reshape(-1, 1)
        out = a.data.clone()
        out[0] = rns.add_mod(a.data[0].long(),
                             pt_data[:a.level + 1].long(), q).int()
        return Ciphertext(out, a.scale)

    def _add_scalar(self, a: Ciphertext, value: complex,
                    scale: float) -> Ciphertext:
        consts = self._scalar_mul_consts(value, a.scale, a.level, mont=True)
        return Ciphertext(ops_impl.ct_add_scalar_pt(self.params, self.tabs,
                                                    a.data, consts), a.scale)

    def add_plain(self, ct: Ciphertext, val) -> Ciphertext:
        return self.add(ct, val)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._align_add(a, b)
        return Ciphertext(ops_impl.ct_sub(self.params, self.tabs,
                                          a.data, b.data), a.scale)

    def negate(self, a: Ciphertext) -> Ciphertext:
        return Ciphertext(ops_impl.ct_negate(self.params, self.tabs, a.data),
                          a.scale)

    def multiply(self, a, b, relin_key: SwitchKey | None = None) -> Ciphertext:
        if isinstance(a, Ciphertext) and isinstance(b, Ciphertext):
            return self._mul_ct_ct(a, b, relin_key)
        if isinstance(a, Ciphertext):
            return self._mul_ct_pt(a, b)
        if isinstance(b, Ciphertext):
            return self._mul_ct_pt(b, a)
        raise TypeError("multiply requires at least one Ciphertext")

    def _mul_ct_ct(self, a: Ciphertext, b: Ciphertext,
                   relin_key: SwitchKey | None) -> Ciphertext:
        lvl = min(a.level, b.level)
        self._check_levels(lvl)
        a = self._drop(a, lvl)
        b = self._drop(b, lvl)
        if a.degree != 1 or b.degree != 1:
            raise RuntimeError("multiply expects degree-1 (relinearized) inputs")
        self._count("ct_mul")
        ct = Ciphertext(ops_impl.ct_tensor(self.params, self.tabs, a.data,
                                           b.data), a.scale * b.scale)
        if relin_key is not None:
            self._count("keyswitch")
            ct = Ciphertext(self._relin_data(ct.data, relin_key), ct.scale)
        return self._rescale(ct)

    def multiply_pair(self, a: Ciphertext, b: Ciphertext,
                      relin_key: SwitchKey | None = None) -> Ciphertext:
        """ct*ct multiply that drops a prime pair with the fused two-prime
        rescale: multiply() plus one more _rescale, in one rounding."""
        lvl = min(a.level, b.level)
        self._check_levels(lvl - 1)          # the pair drop needs 2 limbs
        a = self._drop(a, lvl)
        b = self._drop(b, lvl)
        if a.degree != 1 or b.degree != 1:
            raise RuntimeError("multiply expects degree-1 (relinearized) inputs")
        self._count("ct_mul")
        ct = Ciphertext(ops_impl.ct_tensor(self.params, self.tabs, a.data,
                                           b.data), a.scale * b.scale)
        if relin_key is not None:
            self._count("keyswitch")
            ct = Ciphertext(self._relin_data(ct.data, relin_key), ct.scale)
        return self._rescale_pair(ct)

    def _mul_ct_pt(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Plaintext):
            self._check_levels(a.level)
            self._count("pt_mul")
            data = ops_impl.ct_mul_dense_pt(self.params, self.tabs, a.data,
                                            b.data[:a.level + 1])
            return self._rescale(Ciphertext(data, a.scale * b.scale))
        if isinstance(b, ScalarPlaintext):
            return self._mul_scalar(a, b.value, b.scale)
        if np.isscalar(b):
            return self._mul_scalar(a, complex(b), self.params.scale)
        b = np.asarray(b)
        if b.ndim == 0:
            return self._mul_scalar(a, complex(b), self.params.scale)
        return self._mul_ct_pt(a, self.encode(b, level=a.level,
                                              scale=self.params.scale))

    @staticmethod
    def _true_sigma(value: complex, scale: float) -> float:
        """The scale at which round(value*scale) represents `value` exactly:
        for axis-real or axis-imaginary scalars track m / value instead of
        claiming `scale` (the rounding would otherwise compound through
        squaring ladders)."""
        if value.imag == 0 and value.real != 0:
            return round(value.real * scale) / value.real
        if value.real == 0 and value.imag != 0:
            return round(value.imag * scale) / value.imag
        return scale

    def _mul_scalar(self, a: Ciphertext, value: complex,
                    scale: float) -> Ciphertext:
        self._check_levels(a.level)
        self._count("scalar_mul")
        consts = self._scalar_mul_consts(value, scale, a.level, mont=False)
        data = ops_impl.ct_mul_scalar_pt(self.params, self.tabs, a.data,
                                         consts)
        sigma = self._true_sigma(complex(value), scale)
        return self._rescale(Ciphertext(data, a.scale * sigma))

    def multiply_plain(self, ct: Ciphertext, val) -> Ciphertext:
        return self._mul_ct_pt(ct, val)

    def multiply_renorm(self, ct: Ciphertext, value: complex,
                        target_scale: float | None = None) -> Ciphertext:
        """Scalar multiply whose encode scale makes the rescaled result land
        on target_scale (default Delta): resets a squaring chain's scale
        drift without an extra level."""
        target = self.params.scale if target_scale is None else target_scale
        qd = 1.0
        for i in range(self.params.rescale_primes):
            qd *= float(self.params.q_primes[ct.level - i])
        return self._mul_scalar(ct, complex(value), target * qd / ct.scale)

    def multiply_i(self, ct: Ciphertext) -> Ciphertext:
        """Exact slot-wise multiply by i (zeta4 encoded at scale 1): no
        rescale, no level."""
        self._count("scalar_mul")
        consts = self._scalar_mul_consts(1j, 1.0, ct.level, mont=False)
        return Ciphertext(ops_impl.ct_mul_scalar_pt(self.params, self.tabs,
                                                    ct.data, consts),
                          ct.scale)

    def relinearize(self, ct: Ciphertext, relin_key: SwitchKey) -> Ciphertext:
        if ct.degree != 2:
            raise RuntimeError("Ciphertext should have 3 polynomials")
        return Ciphertext(self._relin_data(ct.data, relin_key), ct.scale)

    # ----- Galois ------------------------------------------------------
    def rotate(self, ct: Ciphertext, rot_keys: GaloisKeySet,
               steps: int) -> Ciphertext:
        """Decrypted slots equal np.roll(slots, steps)."""
        steps = steps % self.params.slot_count
        if steps == 0:
            return ct
        if ct.degree != 1:
            raise RuntimeError("rotate expects a degree-1 ciphertext")
        g_direct = self.params.rot_galois_elt(steps)
        if g_direct in rot_keys.keys:
            return self._apply_galois(ct, g_direct, rot_keys.keys[g_direct])
        out = ct
        remaining = steps
        p2 = 1
        while remaining:
            if remaining & 1:
                g = self.params.rot_galois_elt(p2)
                if g not in rot_keys.keys:
                    raise KeyError(f"no rotation key for step {p2}")
                out = self._apply_galois(out, g, rot_keys.keys[g])
            remaining >>= 1
            p2 <<= 1
        return out

    def hoisted_rotations(self, ct: Ciphertext, rot_keys: GaloisKeySet,
                          steps: Sequence[int]) -> list[Ciphertext]:
        """Rotate `ct` by each step sharing ONE digit decomposition; every
        step needs a direct key."""
        if ct.degree != 1:
            raise RuntimeError("rotate expects a degree-1 ciphertext")
        sc = self.params.slot_count
        d_eval = self._hoist_decompose(ct.data[1])
        out = []
        for s in steps:
            s = s % sc
            if s == 0:
                out.append(ct)
                continue
            g = self.params.rot_galois_elt(s)
            if g not in rot_keys.keys:
                raise KeyError(f"no rotation key for step {s}")
            key = rot_keys.keys[g]
            data = self._hoist_apply(ct.data, d_eval, g, key)
            self._count("keyswitch")
            self._count("rotate")
            out.append(Ciphertext(data, ct.scale))
        return out

    def conjugate(self, ct: Ciphertext, conj_key: SwitchKey) -> Ciphertext:
        return self._apply_galois(ct, self.params.conj_galois_elt, conj_key)

    def _apply_galois(self, ct: Ciphertext, g: int,
                      key: SwitchKey) -> Ciphertext:
        self._count("keyswitch")
        self._count("conjugate" if g == self.params.conj_galois_elt
                    else "rotate")
        return Ciphertext(self._galois_data(ct.data, g, key), ct.scale)

    # ----- polynomial helpers -----------------------------------------
    def make_power_basis(self, ct: Ciphertext, degree: int,
                         relin_key: SwitchKey,
                         normalize: bool = True) -> list[Ciphertext]:
        """[ct^1, ..., ct^degree] (index i -> power i+1) from a binary-depth
        ladder, ct^k = ct^(k//2) * ct^(k - k//2).

        With normalize=True every power is brought to one common (level,
        scale=Delta), so fused sums over the basis need no per-term scale
        juggling: ladder depths divide by different primes, and the tracked
        scales drift apart by ~q_i/q_j until one scalar multiply per power
        squashes the drift."""
        powers: dict[int, Ciphertext] = {1: ct}
        for k in range(2, degree + 1):
            lo = k // 2
            powers[k] = self._mul_ct_ct(powers[lo], powers[k - lo], relin_key)
        out = [powers[i] for i in range(1, degree + 1)]
        if normalize and degree > 1:
            target = self.params.scale
            adjusted = []
            for p in out:
                if abs(p.scale - target) / target > _SCALE_TOL:
                    p = self._adjust_scale(p, target)
                adjusted.append(p)
            lmin = min(p.level for p in adjusted)
            out = [self._drop(p, lmin) for p in adjusted]
        return out

    def evaluate_polynomial(self, ct: Ciphertext, coeffs,
                            relin_key: SwitchKey) -> Ciphertext:
        """sum_k coeffs[k] * ct^k with complex coefficients, term by term
        over a normalized power basis."""
        coeffs = [complex(c) for c in np.asarray(coeffs).tolist()]
        deg = len(coeffs) - 1
        basis = self.make_power_basis(ct, deg, relin_key)
        acc = None
        for k in range(1, deg + 1):
            c = coeffs[k]
            if c == 0:
                continue
            term = self._mul_scalar(basis[k - 1], c, self.params.scale)
            acc = term if acc is None else self.add(acc, term)
        if acc is None:
            acc = self._mul_scalar(ct, 0.0, self.params.scale)
        if coeffs[0] != 0:
            acc = self._add_scalar(acc, coeffs[0], acc.scale)
        return acc

    def trivial_ct(self, val=1.0, level: int | None = None,
                   scale: float | None = None) -> Ciphertext:
        """Noise-free trivial ciphertext (b = encode(val), a = 0); scalar
        values are cached per (val, level, scale)."""
        if np.isscalar(val):
            ck = (complex(val), level, scale)
            hit = self._trivial_cache.pop(ck, None)
            if hit is not None:
                self._trivial_cache[ck] = hit
                return hit
            pt = self.encode(np.full(self.params.slot_count, complex(val)),
                             level=level, scale=scale)
            out = Ciphertext(torch.stack([pt.data, torch.zeros_like(pt.data)]),
                             pt.scale)
            self._trivial_cache[ck] = out
            while len(self._trivial_cache) > 128:
                self._trivial_cache.pop(next(iter(self._trivial_cache)))
            return out
        pt = self.encode(val, level=level, scale=scale)
        return Ciphertext(torch.stack([pt.data, torch.zeros_like(pt.data)]),
                          pt.scale)

    # ----- fused reductions -------------------------------------------
    def linear_combination(self, cts: Sequence[Ciphertext],
                           coeffs: Sequence,
                           constant: complex = 0.0,
                           coeff_scale: float | None = None,
                           target_scale: float | None = None) -> Ciphertext:
        """sum_k coeffs[k] * cts[k] (+ constant) with ONE rescale.

        Coefficients are complex scalars, Plaintexts (per-slot weights at
        one scale, Delta unless the caller steers the output's scale) or
        numpy vectors (encoded on the fly).  `coeff_scale`
        sets the encode scale of scalar coefficients; `target_scale` derives
        it so the output lands exactly on that scale.  Both need all-scalar
        coefficients."""
        dense_pairs = []
        scalar_list = []
        for ct, c in zip(cts, coeffs):
            if isinstance(c, Plaintext):
                dense_pairs.append((ct, c))
            elif isinstance(c, np.ndarray) and c.ndim > 0:
                dense_pairs.append((ct, self.encode(c, level=ct.level)))
            else:
                scalar_list.append((ct, complex(c)))
        if dense_pairs:
            assert coeff_scale is None and target_scale is None, (
                "coeff_scale/target_scale require all-scalar coefficients")
            return self._linear_combination_mixed(dense_pairs, scalar_list,
                                                  constant)
        assert coeff_scale is None or target_scale is None
        target = self.params.scale if coeff_scale is None else coeff_scale
        pairs = [(ct, complex(c)) for ct, c in zip(cts, coeffs) if c != 0]
        if not pairs:
            z = self._mul_scalar(cts[0], 0.0, self.params.scale)
            if constant != 0:
                z = self._add_scalar(z, complex(constant), z.scale)
            return z
        lvl = min(ct.level for ct, _ in pairs)
        aligned = [self._drop(ct, lvl) for ct, _ in pairs]
        # each coefficient is encoded at its own scale so that every term
        # lands on base_scale * target
        base_scale = max(ct.scale for ct in aligned)
        self._check_levels(lvl)
        if target_scale is not None:
            qd = 1.0
            for i in range(self.params.rescale_primes):
                qd *= float(self.params.q_primes[lvl - i])
            target = target_scale * qd / base_scale
        deg = max(ct.degree for ct in aligned)
        stack = torch.stack([self._pad(ct.data, deg) for ct in aligned])
        consts = torch.stack([
            self._scalar_mul_consts(c, target * base_scale / ct.scale, lvl,
                                    mont=False)
            for ct, (_, c) in zip(aligned, pairs)])
        data = ops_impl.ct_linear_combo(self.params, self.tabs, stack, consts)
        out = Ciphertext(data, base_scale * target)
        if constant != 0:
            out = self._add_scalar(out, complex(constant), out.scale)
        return self._rescale(out)

    @staticmethod
    def _pad(d, deg: int):
        """Zero-pad ciphertext data to degree `deg`."""
        if d.shape[0] - 1 < deg:
            z = torch.zeros((deg + 1 - d.shape[0],) + d.shape[1:],
                            dtype=d.dtype, device=d.device)
            d = torch.cat([d, z])
        return d

    def _linear_combination_mixed(self, dense_pairs, scalar_pairs,
                                  constant) -> Ciphertext:
        """linear_combination with per-slot (Plaintext) coefficients plus an
        optional scalar group; one fused sum each, ONE rescale.  Dense
        plaintexts share one scale (Delta, or one that steers the output's
        scale), at which the scalar coefficients are encoded too."""
        all_cts = [p[0] for p in dense_pairs] + [p[0] for p in scalar_pairs]
        lvl = min(ct.level for ct in all_cts)
        lvl = min(lvl, min(p[1].level for p in dense_pairs))
        self._check_levels(lvl)
        base_scale = all_cts[0].scale
        for ct in all_cts:
            if abs(ct.scale - base_scale) / base_scale > _SCALE_ACCEPT:
                raise ValueError("linear_combination input scales differ")
        target = dense_pairs[0][1].scale
        for _, pt in dense_pairs:
            if abs(pt.scale - target) / target > _SCALE_ACCEPT:
                raise ValueError("dense coefficient plaintexts must share "
                                 "one scale")
        deg = max(ct.degree for ct in all_cts)
        stack_d = torch.stack([self._pad(ct.data[:, :lvl + 1], deg)
                               for ct, _ in dense_pairs])
        pts = torch.stack([pt.data[:lvl + 1] for _, pt in dense_pairs])
        data = ops_impl.ct_linear_combo_dense(self.params, self.tabs,
                                              stack_d, pts)
        scalar_pairs = [(ct, c) for ct, c in scalar_pairs if c != 0]
        if scalar_pairs:
            stack_s = torch.stack([self._pad(ct.data[:, :lvl + 1], deg)
                                   for ct, _ in scalar_pairs])
            consts = torch.stack([
                self._scalar_mul_consts(c, target, lvl, mont=False)
                for _, c in scalar_pairs])
            data_s = ops_impl.ct_linear_combo(self.params, self.tabs,
                                              stack_s, consts)
            data = ops_impl.ct_add(self.params, self.tabs, data, data_s)
        out = Ciphertext(data, base_scale * target)
        if isinstance(constant, np.ndarray) and constant.ndim > 0:
            pt = self.encode(constant, level=lvl, scale=out.scale)
            out = self._add_dense_pt(out, pt.data, pt.scale)
        elif constant != 0:
            out = self._add_scalar(out, complex(constant), out.scale)
        return self._rescale(out)

    def _rescale_sum(self, out: Ciphertext, rescales: int) -> Ciphertext:
        if rescales == 2 and self.params.rescale_primes == 1:
            return self._rescale_pair(out)
        for _ in range(rescales):
            out = self._rescale(out)
        return out

    def fused_pt_sum(self, pairs: Sequence[tuple],
                     rescales: int = 1) -> Ciphertext:
        """sum_k ct_k * pt_k in one pass, rescaled once after the sum
        (rescales=2: the fused pair drop of the hi-precision tier).  The cts
        share (level, scale), and so do the pts."""
        cts = [p[0] for p in pairs]
        pts = [p[1] for p in pairs]
        lvl = min(min(ct.level for ct in cts), min(pt.level for pt in pts))
        self._check_levels(lvl)
        base = cts[0].scale
        ps = pts[0].scale
        for ct in cts:
            if abs(ct.scale - base) / base > _SCALE_ACCEPT:
                raise ValueError("fused_pt_sum ct scales differ")
        for pt in pts:
            if abs(pt.scale - ps) / ps > _SCALE_ACCEPT:
                raise ValueError("fused_pt_sum pt scales differ")
        self._count("pt_mul", len(pairs))
        stack = torch.stack([ct.data[:, :lvl + 1] for ct in cts])
        ptd = torch.stack([pt.data[:lvl + 1] for pt in pts])
        data = ops_impl.ct_linear_combo_dense(self.params, self.tabs, stack,
                                              ptd)
        return self._rescale_sum(Ciphertext(data, base * ps), rescales)

    def fused_ptd_sum(self, cts: Sequence[Ciphertext], ptd: torch.Tensor,
                      pt_scale: float, rescales: int = 1) -> Ciphertext:
        """fused_pt_sum against a materialized plaintext stack ptd
        [K, >= lvl+1, N] (materialize_payloads)."""
        lvl = min(ct.level for ct in cts)
        self._check_levels(lvl)
        if len(cts) != ptd.shape[0]:
            raise ValueError(f"fused_ptd_sum: {len(cts)} ciphertexts vs "
                             f"{ptd.shape[0]} plaintext rows")
        if ptd.shape[1] < lvl + 1:
            raise ValueError(
                f"fused_ptd_sum: plaintext stack has {ptd.shape[1]} limb "
                f"rows but the ciphertexts sit at level {lvl}")
        base = cts[0].scale
        for ct in cts:
            if abs(ct.scale - base) / base > _SCALE_ACCEPT:
                raise ValueError("fused_ptd_sum ct scales differ")
        self._count("pt_mul", len(cts))
        stack = torch.stack([ct.data[:, :lvl + 1] for ct in cts])
        data = ops_impl.ct_linear_combo_dense(self.params, self.tabs, stack,
                                              ptd[:, :lvl + 1])
        return self._rescale_sum(Ciphertext(data, base * pt_scale), rescales)

    def fused_payload_sum(self, cts: Sequence[Ciphertext], payloads,
                          pt_scale: float, rescales: int = 1) -> Ciphertext:
        """fused_ptd_sum whose plaintexts arrive as host digit payloads,
        materialized in one batch."""
        if len(cts) != len(payloads):
            raise ValueError(f"fused_payload_sum: {len(cts)} ciphertexts vs "
                             f"{len(payloads)} payloads")
        lvl = min(ct.level for ct in cts)
        return self.fused_ptd_sum(cts, self.materialize_payloads(payloads,
                                                                 lvl),
                                  pt_scale, rescales)

    def inner_product(self, lhs: Sequence[Ciphertext],
                      rhs: Sequence[Ciphertext],
                      relin_key: SwitchKey) -> Ciphertext:
        """sum_k lhs[k] * rhs[k] with ONE relinearization + ONE rescale."""
        assert len(lhs) == len(rhs) and lhs
        lvl = min(min(ct.level for ct in lhs), min(ct.level for ct in rhs))
        self._check_levels(lvl)
        la = [self._drop(ct, lvl) for ct in lhs]
        rb = [self._drop(ct, lvl) for ct in rhs]
        scale_a = la[0].scale
        scale_b = rb[0].scale
        for cts, s, side in ((la, scale_a, "lhs"), (rb, scale_b, "rhs")):
            for ct in cts:
                if abs(ct.scale - s) / s > _SCALE_ACCEPT:
                    raise ValueError(f"inner_product {side} scales differ")
        d = ops_impl.ct_tensor_sum(self.params, self.tabs,
                                   torch.stack([ct.data for ct in la]),
                                   torch.stack([ct.data for ct in rb]))
        self._count("keyswitch")
        data = self._relin_data(d, relin_key)
        return self._rescale(Ciphertext(data, scale_a * scale_b))

    # ----- bootstrap (delegated) --------------------------------------
    def bootstrap(self, ct: Ciphertext, relin_key: SwitchKey,
                  conj_key: SwitchKey, bootstrap_key) -> Ciphertext:
        from .. import bootstrap as _bs
        return _bs.bootstrap(self, ct, relin_key, conj_key, bootstrap_key)
