"""Parquet Modular Encryption (AES_GCM_V1 / AES_GCM_CTR_V1).

The port's copy of arrow_go_tpu/parquet/encryption.py (reference
parquet/internal/encryption/aes.go: module AAD construction aes.go:309,
frame layout aes.go:123: u32-LE length || 12-byte nonce || ciphertext
[|| 16-byte GCM tag]; parquet/encryption_properties.go: the file and
column properties and the key retriever). The cipher is the port's own
AES-CTR and AES-GCM in the host codec library (native.py, csrc/
codecs.cc: AES-NI and PCLMULQDQ).

Encrypted-footer files end with [FileCryptoMetaData][encrypted
FileMetaData][u32 combined length]["PARE"]; plaintext-footer files keep
"PAR1" and append a 28-byte nonce+tag footer signature.

Nonces and `aad_file_unique` come from os.urandom: a nonce repeated
under one key breaks GCM, so none is ever drawn from a seeded
generator.
"""
from __future__ import annotations

import hmac
import os
import struct
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .. import native
from ..compute.errors import ArrowInvalid
from . import format as fmt

NONCE_LEN = 12
TAG_LEN = 16
SIZE_LEN = 4

# module types (reference aes.go:49, order significant)
FOOTER_MODULE = 0
COLUMN_META_MODULE = 1
DATA_PAGE_MODULE = 2
DICT_PAGE_MODULE = 3
DATA_PAGE_HEADER_MODULE = 4
DICT_PAGE_HEADER_MODULE = 5
COLUMN_INDEX_MODULE = 6
OFFSET_INDEX_MODULE = 7
BLOOM_HEADER_MODULE = 8
BLOOM_BITSET_MODULE = 9

AES_GCM_V1 = "AES_GCM_V1"
AES_GCM_CTR_V1 = "AES_GCM_CTR_V1"


def module_aad(file_aad: bytes, module_type: int, row_group: int = -1,
               column: int = -1, page: int = -1) -> bytes:
    """The AAD of one module (reference aes.go CreateModuleAad): the file
    AAD, the module type byte, then (but for the footer) the int16-LE
    row group and column, and for data pages and their headers the
    int16-LE page ordinal."""
    out = bytearray(file_aad)
    out.append(module_type & 0xFF)
    if module_type == FOOTER_MODULE:
        return bytes(out)
    out += struct.pack("<h", row_group)
    out += struct.pack("<h", column)
    if module_type in (DATA_PAGE_MODULE, DATA_PAGE_HEADER_MODULE):
        out += struct.pack("<h", page)
    return bytes(out)


def footer_aad(file_aad: bytes) -> bytes:
    return module_aad(file_aad, FOOTER_MODULE)


def _ctr_iv(nonce) -> bytes:
    # CTR IV = 12-byte nonce || 0x00000001 (reference aes.go:160)
    return bytes(nonce) + b"\x00\x00\x00\x01"


def encrypt_module(key: bytes, aad: bytes, plaintext, gcm: bool = True,
                   nonce: Optional[bytes] = None) -> bytes:
    """One encrypted frame: u32-LE length || nonce || ciphertext[|| tag],
    the ciphertext written straight into the frame."""
    nonce = nonce if nonce is not None else os.urandom(NONCE_LEN)
    n = len(plaintext)
    body = NONCE_LEN + n + (TAG_LEN if gcm else 0)
    frame = np.empty(SIZE_LEN + body, np.uint8)
    frame[:SIZE_LEN] = np.frombuffer(struct.pack("<I", body), np.uint8)
    frame[SIZE_LEN:SIZE_LEN + NONCE_LEN] = np.frombuffer(nonce, np.uint8)
    out = frame[SIZE_LEN + NONCE_LEN:]
    if gcm:
        native.aes_gcm_encrypt(key, nonce, plaintext, aad, out=out)
    elif n:
        native.aes_ctr(key, _ctr_iv(nonce), plaintext, out=out)
    return frame.tobytes()


def decrypt_module(key: bytes, aad: bytes, data, pos: int = 0,
                   gcm: bool = True) -> Tuple[memoryview, int]:
    """Decrypt the frame at data[pos:]; returns (plaintext, bytes
    consumed). A GCM tag that does not hold raises ArrowInvalid."""
    if len(data) - pos < SIZE_LEN:
        raise ArrowInvalid("encrypted frame missing length prefix")
    (blen,) = struct.unpack_from("<I", data, pos)
    frame = memoryview(data)[pos + SIZE_LEN: pos + SIZE_LEN + blen]
    if len(frame) != blen:
        raise ArrowInvalid("truncated encrypted frame")
    if blen < NONCE_LEN + (TAG_LEN if gcm else 0):
        raise ArrowInvalid("encrypted frame shorter than its nonce and tag")
    nonce, ct = frame[:NONCE_LEN], frame[NONCE_LEN:]
    if gcm:
        pt = native.aes_gcm_decrypt(key, nonce, ct, aad)
    else:
        pt = native.aes_ctr(key, _ctr_iv(nonce), ct)  # decrypt == encrypt
    return pt, SIZE_LEN + blen


def sign_footer(key: bytes, aad: bytes, footer,
                nonce: Optional[bytes] = None) -> bytes:
    """Plaintext-footer signature: nonce || GCM tag over the footer bytes
    (reference aesEncryptor.SignedFooterEncrypt keeps only nonce+tag)."""
    nonce = nonce if nonce is not None else os.urandom(NONCE_LEN)
    ct = native.aes_gcm_encrypt(key, nonce, footer, aad)
    return bytes(nonce) + bytes(ct[-TAG_LEN:])


def verify_footer_signature(key: bytes, aad: bytes, footer,
                            signature) -> bool:
    nonce, tag = bytes(signature[:NONCE_LEN]), bytes(signature[NONCE_LEN:])
    ct = native.aes_gcm_encrypt(key, nonce, footer, aad)
    return hmac.compare_digest(bytes(ct[-TAG_LEN:]), tag)


def _check_key(key: bytes) -> bytes:
    key = bytes(key)
    if len(key) not in (16, 24, 32):
        raise ArrowInvalid("AES keys must be 16/24/32 bytes")
    return key


class ColumnEncryptionProperties:
    """Per-column key (reference encryption_properties.go
    ColumnEncryptionProperties)."""

    def __init__(self, key: bytes, key_metadata: bytes = b""):
        self.key = _check_key(key)
        self.key_metadata = bytes(key_metadata)


class FileEncryptionProperties:
    """Write-side encryption configuration.

    column_keys: {leaf path (dotted) -> ColumnEncryptionProperties or raw
    key bytes}. When empty, every column is encrypted with the footer key
    (uniform encryption). When given, listed columns use their own keys and
    UNLISTED COLUMNS STAY PLAINTEXT (reference encryptedColumns semantics).
    """

    def __init__(self, footer_key: bytes, footer_key_metadata: bytes = b"",
                 column_keys: Optional[Dict[str, object]] = None,
                 plaintext_footer: bool = False,
                 algorithm: str = AES_GCM_V1,
                 aad_prefix: bytes = b"", store_aad_prefix: bool = True):
        if algorithm not in (AES_GCM_V1, AES_GCM_CTR_V1):
            raise ArrowInvalid(f"unknown cipher {algorithm}")
        self.footer_key = _check_key(footer_key)
        self.footer_key_metadata = bytes(footer_key_metadata)
        self.plaintext_footer = plaintext_footer
        self.algorithm = algorithm
        self.aad_prefix = bytes(aad_prefix)
        self.store_aad_prefix = store_aad_prefix and bool(aad_prefix)
        self.column_keys: Dict[str, ColumnEncryptionProperties] = {}
        for path, v in (column_keys or {}).items():
            if not isinstance(v, ColumnEncryptionProperties):
                v = ColumnEncryptionProperties(v)
            self.column_keys[path] = v
        self.aad_file_unique = os.urandom(8)

    @property
    def file_aad(self) -> bytes:
        return self.aad_prefix + self.aad_file_unique

    def algorithm_struct(self) -> fmt.EncryptionAlgorithm:
        kw = dict(aad_file_unique=self.aad_file_unique)
        if self.store_aad_prefix:
            kw["aad_prefix"] = self.aad_prefix
        elif self.aad_prefix:
            kw["supply_aad_prefix"] = True
        if self.algorithm == AES_GCM_V1:
            return fmt.EncryptionAlgorithm(AES_GCM_V1=fmt.AesGcmV1(**kw))
        return fmt.EncryptionAlgorithm(AES_GCM_CTR_V1=fmt.AesGcmCtrV1(**kw))

    def column_setup(self, path: str):
        """-> (key bytes or None if plaintext, key_metadata, uses_footer_key)."""
        if not self.column_keys:
            return self.footer_key, b"", True
        if path in self.column_keys:
            c = self.column_keys[path]
            return c.key, c.key_metadata, False
        return None, b"", False


class FileDecryptionProperties:
    """Read-side keys (reference FileDecryptionProperties +
    DecryptionKeyRetriever). key_retriever: key_metadata bytes -> key."""

    def __init__(self, footer_key: Optional[bytes] = None,
                 column_keys: Optional[Dict[str, bytes]] = None,
                 key_retriever: Optional[Callable[[bytes], bytes]] = None,
                 aad_prefix: bytes = b"",
                 check_plaintext_footer_integrity: bool = True):
        self.footer_key = _check_key(footer_key) if footer_key else None
        self.column_keys = {k: _check_key(v)
                            for k, v in (column_keys or {}).items()}
        self.key_retriever = key_retriever
        self.aad_prefix = bytes(aad_prefix)
        self.check_plaintext_footer_integrity = check_plaintext_footer_integrity

    def footer_key_for(self, key_metadata: bytes) -> bytes:
        if self.footer_key is not None:
            return self.footer_key
        if self.key_retriever is not None:
            return _check_key(self.key_retriever(key_metadata or b""))
        raise ArrowInvalid("no footer key: supply footer_key or key_retriever")

    def column_key_for(self, path: str, key_metadata: bytes) -> bytes:
        if path in self.column_keys:
            return self.column_keys[path]
        if self.key_retriever is not None:
            return _check_key(self.key_retriever(key_metadata or b""))
        raise ArrowInvalid(f"no key for encrypted column {path!r}")


class _ColumnCryptoContext:
    """Resolved per-chunk crypto state shared by reader and writer paths."""

    __slots__ = ("key", "file_aad", "rg", "col", "gcm_pages")

    def __init__(self, key: bytes, file_aad: bytes, rg: int, col: int,
                 gcm_pages: bool):
        self.key = key
        self.file_aad = file_aad
        self.rg = rg
        self.col = col
        self.gcm_pages = gcm_pages  # False for AES_GCM_CTR_V1 page payloads

    def aad(self, module: int, page: int = -1) -> bytes:
        return module_aad(self.file_aad, module, self.rg, self.col, page)
