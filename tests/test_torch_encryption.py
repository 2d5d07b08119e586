"""The port's AES (csrc/codecs.cc through native.py: AES-NI rounds,
PCLMULQDQ GHASH) and its parquet/encryption.py against the
`cryptography` package, the NIST SP 800-38D / FIPS-197 vectors and the
JAX package's parquet/encryption.py: AES-CTR and AES-GCM at every key
size over lengths 0 to past 1 MiB and AADs of 0 to 40 bytes, the
encrypted frames byte for byte with a fixed nonce, every module AAD,
the footer signature, the properties, and the refusals (a tag that does
not hold, truncated frames, bad keys) in both packages."""
import os

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from arrow_go_tpu.compute.errors import ArrowInvalid as jArrowInvalid
from arrow_go_tpu.parquet import encryption as je
from arrow_go_tpu_torch import native
from arrow_go_tpu_torch.compute.errors import (ArrowInvalid as tArrowInvalid,
                                               ArrowNotImplemented)
from arrow_go_tpu_torch.parquet import encryption as te

KEY_SIZES = (16, 24, 32)
LENGTHS = (0, 1, 15, 16, 17, 129, (1 << 20) + 5)
AAD_LENGTHS = (0, 1, 16, 40)


def _rng(*seed):
    return np.random.default_rng(list(seed))


@pytest.mark.parametrize("aad_len", AAD_LENGTHS)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("key_len", KEY_SIZES)
def test_gcm_matches_cryptography(key_len, n, aad_len):
    rng = _rng(key_len, n, aad_len)
    key, nonce = rng.bytes(key_len), rng.bytes(12)
    aad, data = rng.bytes(aad_len), rng.bytes(n)
    want = AESGCM(key).encrypt(nonce, data, aad)
    got = native.aes_gcm_encrypt(key, nonce, data, aad)
    assert bytes(got) == want
    assert bytes(native.aes_gcm_decrypt(key, nonce, want, aad)) == data


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("key_len", KEY_SIZES)
def test_ctr_matches_cryptography(key_len, n):
    rng = _rng(key_len, n, 7)
    key, data = rng.bytes(key_len), rng.bytes(n)
    iv = rng.bytes(12) + b"\x00\x00\x00\x01"
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    want = enc.update(data) + enc.finalize()
    assert bytes(native.aes_ctr(key, iv, data)) == want
    assert bytes(native.aes_ctr(key, iv, want)) == data


def test_ctr_counter_is_32_bit_big_endian():
    """Past 0xffffffff the count wraps in its four bytes and leaves the
    nonce as it is (GCM's inc32)."""
    key = bytes(range(16))
    nonce = bytes(range(100, 112))
    iv = nonce + b"\xff\xff\xff\xff"
    got = bytes(native.aes_ctr(key, iv, bytes(32)))
    ecb = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
    want = ecb.update(iv + nonce + b"\x00\x00\x00\x00") + ecb.finalize()
    assert got == want


# FIPS-197 appendix C: one block of 00112233...eeff under the keys
# 000102..., and SP 800-38D's GCM test cases (96-bit IVs)
FIPS197 = [
    ("000102030405060708090a0b0c0d0e0f", "69c4e0d86a7b0430d8cdb78070b4c55a"),
    ("000102030405060708090a0b0c0d0e0f1011121314151617",
     "dda97ca4864cdfe06eaf70a0ec0d7191"),
    ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
     "8ea2b7ca516745bfeafc49904b496089"),
]

_P3 = ("d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
       "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
_C3 = ("42831ec2217774244b7221b784d0d49ce3aa212f2c02a4e035c17e2329aca12e"
       "21d514b25466931c7d8f6a5aac84aa051ba30b396a0aac973d58e091473f5985")
GCM_VECTORS = [
    # key, iv, plaintext, aad, ciphertext, tag
    ("00" * 16, "00" * 12, "", "", "", "58e2fccefa7e3061367f1d57a4e7455a"),
    ("00" * 16, "00" * 12, "00" * 16, "", "0388dace60b6a392f328c2b971b2fe78",
     "ab6e47d42cec13bdf53a67b21257bddf"),
    ("feffe9928665731c6d6a8f9467308308", "cafebabefacedbaddecaf888", _P3, "",
     _C3, "4d5c2af327cd64a62cf35abd2ba6fab4"),
    ("feffe9928665731c6d6a8f9467308308", "cafebabefacedbaddecaf888",
     _P3[:120], "feedfacedeadbeeffeedfacedeadbeefabaddad2", _C3[:120],
     "5bc94fbc3221a5db94fae95ae7121a47"),
    ("00" * 24, "00" * 12, "", "", "", "cd33b28ac773f74ba00ed1f312572435"),
    ("00" * 24, "00" * 12, "00" * 16, "", "98e7247c07f0fe411c267e4384b0f600",
     "2ff58d80033927ab8ef4d4587514f0fb"),
    ("00" * 32, "00" * 12, "", "", "", "530f8afbc74536b9a963b4f1c4cb738b"),
    ("00" * 32, "00" * 12, "00" * 16, "", "cea7403d4d606b6e074ec5d3baf39d18",
     "d0d1c8a799996bf0265b98b5d48ab919"),
]


@pytest.mark.parametrize("key,ct", FIPS197)
def test_fips197_block(key, ct):
    # the keystream of counter block P is E(K, P): CTR over zeros
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert bytes(native.aes_ctr(bytes.fromhex(key), pt, bytes(16))).hex() \
        == ct


@pytest.mark.parametrize("case", range(len(GCM_VECTORS)))
def test_sp800_38d_vectors(case):
    key, iv, pt, aad, ct, tag = (bytes.fromhex(x) for x in GCM_VECTORS[case])
    got = bytes(native.aes_gcm_encrypt(key, iv, pt, aad))
    assert got == ct + tag
    assert bytes(native.aes_gcm_decrypt(key, iv, got, aad)) == pt


@pytest.mark.parametrize("where", ["ciphertext", "tag", "aad", "key",
                                   "nonce"])
def test_gcm_tag_mismatch_raises(where):
    rng = _rng(3)
    key, nonce, aad = rng.bytes(16), rng.bytes(12), rng.bytes(9)
    ct = bytearray(AESGCM(key).encrypt(nonce, rng.bytes(40), aad))
    if where == "ciphertext":
        ct[3] ^= 1
    elif where == "tag":
        ct[-1] ^= 0x80
    elif where == "aad":
        aad = aad[:-1]
    elif where == "key":
        key = bytes(16)
    else:
        nonce = bytes(12)
    with pytest.raises(tArrowInvalid, match="tag mismatch"):
        native.aes_gcm_decrypt(key, nonce, bytes(ct), aad)


def test_bad_inputs_raise():
    with pytest.raises(tArrowInvalid, match="16/24/32"):
        native.aes_gcm_encrypt(bytes(15), bytes(12), b"x")
    with pytest.raises(tArrowInvalid, match="16/24/32"):
        native.aes_ctr(bytes(33), bytes(16), b"x")
    with pytest.raises(tArrowInvalid, match="12 bytes"):
        native.aes_gcm_encrypt(bytes(16), bytes(16), b"x")
    with pytest.raises(tArrowInvalid, match="block is 16 bytes"):
        native.aes_ctr(bytes(16), bytes(12), b"x")
    with pytest.raises(tArrowInvalid, match="shorter than its tag"):
        native.aes_gcm_decrypt(bytes(16), bytes(12), bytes(15))


def test_no_aes_instructions_raise_and_nothing_falls_back():
    """The library's no-CPU code raises ArrowNotImplemented; the source
    holds no S-box table to fall back to."""
    with pytest.raises(ArrowNotImplemented, match="AES-NI"):
        native._aes_check(native._AES_NO_CPU)
    src = native.SOURCE.read_text()
    aes = src[src.index("AES (FIPS-197)"):]
    assert "__builtin_cpu_supports(\"aes\")" in aes
    assert "0x63, 0x7c" not in aes.lower()      # the S-box's first bytes


# ---------------------------------------------------------------------------
# parquet/encryption.py against the JAX module
# ---------------------------------------------------------------------------

MODULES = range(10)


@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("rg,col,page", [(0, 0, 0), (3, 7, 11),
                                         (32767, 1, 32767), (-1, -1, -1)])
def test_module_aad_matches_jax(module, rg, col, page):
    file_aad = b"prefix" + bytes(range(8))
    assert te.module_aad(file_aad, module, rg, col, page) == \
        je.module_aad(file_aad, module, rg, col, page)
    assert te.footer_aad(file_aad) == je.footer_aad(file_aad)


@pytest.mark.parametrize("gcm", [True, False])
@pytest.mark.parametrize("n", [0, 1, 16, 33, 70000])
@pytest.mark.parametrize("key_len", KEY_SIZES)
def test_encrypt_module_is_the_jax_frame(key_len, n, gcm):
    rng = _rng(key_len, n, gcm)
    key, nonce, aad = rng.bytes(key_len), rng.bytes(12), rng.bytes(23)
    data = rng.bytes(n)
    frame = te.encrypt_module(key, aad, data, gcm, nonce)
    assert frame == je.encrypt_module(key, aad, data, gcm, nonce)
    pad = b"\x07" * 5
    got, used = te.decrypt_module(key, aad, pad + frame, len(pad), gcm)
    want, jused = je.decrypt_module(key, aad, pad + frame, len(pad), gcm)
    assert bytes(got) == want == data and used == jused == len(frame)


def test_random_nonces_differ():
    key = bytes(16)
    assert te.encrypt_module(key, b"", b"abc") != \
        te.encrypt_module(key, b"", b"abc")
    props = [te.FileEncryptionProperties(footer_key=key) for _ in range(2)]
    assert props[0].aad_file_unique != props[1].aad_file_unique
    assert len(props[0].aad_file_unique) == 8


@pytest.mark.parametrize("n", [0, 5, 300])
def test_footer_signature_matches_jax(n):
    rng = _rng(n, 11)
    key, nonce, aad, footer = (rng.bytes(32), rng.bytes(12), rng.bytes(14),
                               rng.bytes(n))
    sig = te.sign_footer(key, aad, footer, nonce)
    assert sig == je.sign_footer(key, aad, footer, nonce)
    assert len(sig) == te.NONCE_LEN + te.TAG_LEN
    assert te.verify_footer_signature(key, aad, footer, sig)
    assert je.verify_footer_signature(key, aad, footer, sig)
    bad = footer + b"!"
    assert not te.verify_footer_signature(key, aad, bad, sig)
    assert not je.verify_footer_signature(key, aad, bad, sig)


def _tampered(frame: bytes, how: str) -> bytes:
    b = bytearray(frame)
    if how == "flip_body":
        b[20] ^= 1
    elif how == "flip_tag":
        b[-1] ^= 1
    elif how == "truncated":
        return bytes(b[:-3])
    elif how == "no_length":
        return bytes(b[:3])
    return bytes(b)


@pytest.mark.parametrize("how", ["flip_body", "flip_tag", "truncated",
                                 "no_length", "wrong_key", "wrong_aad"])
def test_bad_frames_raise_in_both(how):
    rng = _rng(5)
    key, nonce, aad = rng.bytes(16), rng.bytes(12), b"aad"
    frame = je.encrypt_module(key, aad, rng.bytes(64), True, nonce)
    frame = _tampered(frame, how)
    if how == "wrong_key":
        key = bytes(16)
    if how == "wrong_aad":
        aad = b"aae"
    with pytest.raises(tArrowInvalid):
        te.decrypt_module(key, aad, frame)
    with pytest.raises(jArrowInvalid):
        je.decrypt_module(key, aad, frame)


@pytest.mark.parametrize("how", ["truncated", "no_length"])
def test_bad_ctr_frames_raise_in_both(how):
    key, nonce = bytes(range(16)), bytes(12)
    frame = _tampered(je.encrypt_module(key, b"", bytes(64), False, nonce),
                      how)
    with pytest.raises(tArrowInvalid):
        te.decrypt_module(key, b"", frame, gcm=False)
    with pytest.raises(jArrowInvalid):
        je.decrypt_module(key, b"", frame, gcm=False)


@pytest.mark.parametrize("kw", [
    {},
    {"aad_prefix": b"abc"},
    {"aad_prefix": b"abc", "store_aad_prefix": False},
    {"algorithm": "AES_GCM_CTR_V1", "aad_prefix": b"xyz"},
    {"column_keys": {"a": bytes(range(16)), "b.c": bytes(range(32))}},
])
def test_file_properties_match_jax(kw):
    key = bytes(range(24))
    tp = te.FileEncryptionProperties(footer_key=key, **kw)
    jp = je.FileEncryptionProperties(footer_key=key, **kw)
    jp.aad_file_unique = tp.aad_file_unique
    assert tp.file_aad == jp.file_aad
    assert tp.store_aad_prefix == jp.store_aad_prefix
    ts, js = tp.algorithm_struct(), jp.algorithm_struct()
    for name in ("AES_GCM_V1", "AES_GCM_CTR_V1"):
        a, b = getattr(ts, name), getattr(js, name)
        assert (a is None) == (b is None)
        if a is not None:
            for f in ("aad_prefix", "aad_file_unique", "supply_aad_prefix"):
                assert getattr(a, f) == getattr(b, f)
    for path in ("a", "b.c", "d"):
        assert tp.column_setup(path) == jp.column_setup(path)


def test_properties_refuse_like_jax():
    for mod, err in ((te, tArrowInvalid), (je, jArrowInvalid)):
        with pytest.raises(err, match="unknown cipher"):
            mod.FileEncryptionProperties(footer_key=bytes(16),
                                         algorithm="AES_CBC")
        with pytest.raises(err, match="16/24/32"):
            mod.ColumnEncryptionProperties(bytes(17))
        dec = mod.FileDecryptionProperties()
        with pytest.raises(err, match="no footer key"):
            dec.footer_key_for(b"")
        with pytest.raises(err, match="no key for encrypted column"):
            dec.column_key_for("a", b"")
        dec = mod.FileDecryptionProperties(
            key_retriever=lambda m: bytes(16) if m == b"k" else bytes(3))
        assert dec.footer_key_for(b"k") == bytes(16)
        with pytest.raises(err, match="16/24/32"):
            dec.column_key_for("a", b"other")


def test_ciphers_run_on_large_inputs_without_a_copy_back():
    """A frame's ciphertext is written into the frame; a page's plaintext
    comes back as a view of one buffer."""
    key = os.urandom(32)
    data = os.urandom(3 << 20)
    frame = te.encrypt_module(key, b"a", data)
    pt, used = te.decrypt_module(key, b"a", frame)
    assert isinstance(pt, memoryview) and pt == data and used == len(frame)
