"""The plain AES-128 against FIPS-197 Appendix C.1 (AES-128, key
000102..0f), round by round, and its partial and inverse rounds."""
import numpy as np
import pytest

from fhebench.reference import aes

KEY = bytes(range(16))
PT = bytes.fromhex("00112233445566778899aabbccddeeff")
CT = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
# FIPS-197 C.1: round[r].start is the state entering round r (after the
# previous round's AddRoundKey); round[1].m_col is the state after round 1
# without its AddRoundKey
C1 = {
    "round1_start": "00102030405060708090a0b0c0d0e0f0",
    "round1_m_col": "5f72641557f5bc92f7be3b291db9f91a",
    "round1_k_sch": "d6aa74fdd2af72fadaa678f1d6ab76fe",
    "round2_start": "89d810e8855ace682d1843d8cb128fe4",
    "round10_start": "bd6e7c3df2b5779e0b61216e8b10b689",
    "round10_k_sch": "13111d7fe3944a17f307a78b4d2b30c5",
}


def hexs(a) -> str:
    return np.asarray(a, dtype=np.uint8).tobytes().hex()


def test_fips197_c1_cipher_and_inverse():
    assert hexs(aes.encrypt(PT, KEY)) == CT.hex()
    assert hexs(aes.decrypt(CT, KEY)) == PT.hex()


def test_fips197_c1_round_by_round():
    rk = aes.expand_key(KEY)
    assert hexs(aes.encrypt(PT, KEY, 0)) == C1["round1_start"]
    assert hexs(aes.round_state(PT, KEY, 1)) == C1["round1_m_col"]
    assert hexs(rk[1]) == C1["round1_k_sch"]
    assert hexs(aes.encrypt(PT, KEY, 1)) == C1["round2_start"]
    assert hexs(aes.encrypt(PT, KEY, 9)) == C1["round10_start"]
    assert hexs(rk[10]) == C1["round10_k_sch"]
    assert hexs(aes.round_state(PT, KEY, 10)) == CT.hex()


@pytest.mark.parametrize("rounds", range(11))
def test_partial_rounds_invert_and_chain(rounds):
    rng = np.random.default_rng(rounds)
    pt = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    ct = aes.encrypt(pt, key, rounds)
    assert np.array_equal(aes.decrypt(ct, key, rounds), pt)
    if 0 < rounds < 10:
        # a run that stops after round r ends with AddRoundKey(rk_r)
        rk = aes.expand_key(key)
        assert np.array_equal(aes.round_state(pt, key, rounds) ^ rk[rounds],
                              ct)


def test_sbox_is_fips197s():
    # FIPS-197 Figure 7: S(0x00) = 0x63, S(0x53) = 0xed, and the inverse
    assert aes.SBOX[0x00] == 0x63 and aes.SBOX[0x53] == 0xED
    assert np.array_equal(aes.INV_SBOX[aes.SBOX], np.arange(256))


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        aes.encrypt(PT, KEY, 11)
    with pytest.raises(ValueError):
        aes.expand_key(bytes(15))
    with pytest.raises(ValueError):
        aes.encrypt(bytes(17), KEY)
