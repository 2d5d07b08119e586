"""Parquet key-management tools: envelope encryption with a KMS.

The interop-standard "PKMT1" key-material JSON (parquet-mr / parquet-cpp
key tools; reference arrow-go has no keytools package — this follows the
cross-implementation format so files are mutually decryptable with
pyarrow's pyarrow.parquet.encryption.CryptoFactory):

- single wrapping: the data encryption key (DEK) is wrapped by the KMS
  directly (``wrap_key(DEK, master_key_id)``).
- double wrapping: DEKs are wrapped locally with a key-encryption key
  (KEK); only the KEK is wrapped by the KMS. Local wrap = AES-GCM with
  AAD = the base64 KEK id, serialized base64(nonce || ciphertext || tag).

Key material is stored internally (inside key_metadata) in this
implementation.

The port's copy of arrow_go_tpu/parquet/keytools.py, its local key wrap
on the port's own AES-GCM (native.py) and only the standard library's
json and base64 besides.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Callable, Dict, List, Optional

from .. import native
from ..compute.errors import ArrowInvalid
from .encryption import (AES_GCM_V1, ColumnEncryptionProperties,
                         FileDecryptionProperties, FileEncryptionProperties,
                         _check_key)

KEY_MATERIAL_TYPE = "PKMT1"


class KmsClient:
    """Interface for a key-management service (mirrors
    pyarrow.parquet.encryption.KmsClient)."""

    def wrap_key(self, key_bytes: bytes, master_key_identifier: str) -> str:
        raise NotImplementedError

    def unwrap_key(self, wrapped_key: str,
                   master_key_identifier: str) -> bytes:
        raise NotImplementedError


class KmsConnectionConfig:
    def __init__(self, kms_instance_id: str = "DEFAULT",
                 kms_instance_url: str = "DEFAULT",
                 key_access_token: str = "DEFAULT",
                 custom_kms_conf: Optional[Dict[str, str]] = None):
        self.kms_instance_id = kms_instance_id
        self.kms_instance_url = kms_instance_url
        self.key_access_token = key_access_token
        self.custom_kms_conf = custom_kms_conf or {}


class EncryptionConfiguration:
    """Mirrors pyarrow.parquet.encryption.EncryptionConfiguration.
    column_keys: {master_key_id: [column, ...]}."""

    def __init__(self, footer_key: str,
                 column_keys: Optional[Dict[str, List[str]]] = None,
                 uniform_encryption: bool = False,
                 encryption_algorithm: str = AES_GCM_V1,
                 plaintext_footer: bool = False,
                 double_wrapping: bool = True,
                 data_key_length_bits: int = 128):
        self.footer_key = footer_key
        self.column_keys = column_keys or {}
        self.uniform_encryption = uniform_encryption
        self.encryption_algorithm = encryption_algorithm
        self.plaintext_footer = plaintext_footer
        self.double_wrapping = double_wrapping
        self.data_key_length_bits = data_key_length_bits
        if not uniform_encryption and not self.column_keys:
            raise ArrowInvalid("either uniform_encryption or column_keys "
                               "must be configured")


class DecryptionConfiguration:
    def __init__(self, cache_lifetime: Optional[float] = None):
        self.cache_lifetime = cache_lifetime


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _encrypt_key_locally(key: bytes, wrapping_key: bytes, aad: bytes) -> str:
    """parquet-cpp KeyToolkit::EncryptKeyLocally: base64(nonce||ct||tag)."""
    nonce = os.urandom(12)
    ct = native.aes_gcm_encrypt(wrapping_key, nonce, key, aad)
    return _b64(nonce + bytes(ct))


def _decrypt_key_locally(enc: str, wrapping_key: bytes, aad: bytes) -> bytes:
    raw = _unb64(enc)
    return bytes(native.aes_gcm_decrypt(wrapping_key, raw[:12], raw[12:],
                                        aad))


class _KeyWrapper:
    """Builds PKMT1 key material (reference parquet-cpp FileKeyWrapper)."""

    def __init__(self, kms: KmsClient, kms_config: KmsConnectionConfig,
                 double_wrapping: bool):
        self.kms = kms
        self.config = kms_config
        self.double_wrapping = double_wrapping
        self._keks: Dict[str, tuple] = {}  # master id -> (kek_id_b64, kek)

    def _kek_for(self, master_id: str) -> tuple:
        if master_id not in self._keks:
            kek = os.urandom(16)
            kek_id = _b64(os.urandom(16))
            wrapped_kek = self.kms.wrap_key(kek, master_id)
            self._keks[master_id] = (kek_id, kek, wrapped_kek)
        return self._keks[master_id]

    def wrap(self, dek: bytes, master_id: str, is_footer: bool) -> bytes:
        material = {
            "keyMaterialType": KEY_MATERIAL_TYPE,
            "internalStorage": True,
            "isFooterKey": is_footer,
            "doubleWrapping": self.double_wrapping,
            "masterKeyID": master_id,
        }
        if is_footer:
            material["kmsInstanceID"] = self.config.kms_instance_id
            material["kmsInstanceURL"] = self.config.kms_instance_url
        if self.double_wrapping:
            kek_id, kek, wrapped_kek = self._kek_for(master_id)
            material["keyEncryptionKeyID"] = kek_id
            material["wrappedKEK"] = wrapped_kek
            # AAD is the RAW kek id bytes (parquet-cpp FileKeyWrapper)
            material["wrappedDEK"] = _encrypt_key_locally(
                dek, kek, _unb64(kek_id))
        else:
            material["wrappedDEK"] = self.kms.wrap_key(dek, master_id)
        return json.dumps(material).encode()


class _KeyUnwrapper:
    """Parses PKMT1 key material from key_metadata and unwraps the DEK
    (reference parquet-cpp FileKeyUnwrapper)."""

    def __init__(self, kms: KmsClient):
        self.kms = kms
        self._kek_cache: Dict[str, bytes] = {}

    def __call__(self, key_metadata: bytes) -> bytes:
        try:
            material = json.loads(key_metadata.decode())
        except (ValueError, UnicodeDecodeError):
            raise ArrowInvalid("key metadata is not PKMT1 key material")
        if material.get("keyMaterialType") != KEY_MATERIAL_TYPE:
            raise ArrowInvalid(
                f"unsupported key material {material.get('keyMaterialType')}")
        master_id = material["masterKeyID"]
        if material.get("doubleWrapping"):
            kek_id = material["keyEncryptionKeyID"]
            if kek_id not in self._kek_cache:
                self._kek_cache[kek_id] = self.kms.unwrap_key(
                    material["wrappedKEK"], master_id)
            return _decrypt_key_locally(material["wrappedDEK"],
                                        self._kek_cache[kek_id],
                                        _unb64(kek_id))
        return self.kms.unwrap_key(material["wrappedDEK"], master_id)


class CryptoFactory:
    """Mirrors pyarrow.parquet.encryption.CryptoFactory: turns a KMS client
    factory + configs into File{En,De}cryptionProperties."""

    def __init__(self, kms_client_factory: Callable[[KmsConnectionConfig],
                                                    KmsClient]):
        self.kms_client_factory = kms_client_factory

    def file_encryption_properties(
            self, kms_config: KmsConnectionConfig,
            config: EncryptionConfiguration) -> FileEncryptionProperties:
        kms = self.kms_client_factory(kms_config)
        wrapper = _KeyWrapper(kms, kms_config, config.double_wrapping)
        klen = config.data_key_length_bits // 8
        footer_dek = os.urandom(klen)
        footer_meta = wrapper.wrap(footer_dek, config.footer_key, True)
        column_keys = {}
        if not config.uniform_encryption:
            for master_id, cols in config.column_keys.items():
                for col in cols:
                    dek = os.urandom(klen)
                    meta = wrapper.wrap(dek, master_id, False)
                    column_keys[col.strip()] = ColumnEncryptionProperties(
                        dek, meta)
        return FileEncryptionProperties(
            footer_key=_check_key(footer_dek),
            footer_key_metadata=footer_meta,
            column_keys=column_keys,
            plaintext_footer=config.plaintext_footer,
            algorithm=config.encryption_algorithm)

    def file_decryption_properties(
            self, kms_config: KmsConnectionConfig,
            config: Optional[DecryptionConfiguration] = None
            ) -> FileDecryptionProperties:
        kms = self.kms_client_factory(kms_config)
        return FileDecryptionProperties(key_retriever=_KeyUnwrapper(kms))
