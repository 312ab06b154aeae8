"""Encryption at rest: counter-mode cipher over data files.

Counterpart of ``yugabyte_db_tpu/utils/encryption.py``: the same
envelopes, keystreams and key registry, so either package opens the
other's encrypted files.

Reference: BlockAccessCipherStream (src/yb/encryption/cipher_stream.h)
wraps files in an AES-CTR cipher; the master's UniverseKeyManager
(src/yb/encryption/universe_key_manager.cc, master/encryption_manager.cc)
distributes universe keys.  This implementation keeps the same seams —
a keystream cipher with random-access XOR semantics and a registry of
versioned universe keys.

Cipher selection: AES-CTR through the `cryptography` provider when it
is importable (the reference's cipher, matching its EVP AES-CTR use),
with the original BLAKE2b keystream as a documented fallback for
images without a crypto provider.  The file envelope is format-
versioned: v2 records the cipher id, so files written under either
cipher (and either format) stay readable across rotations and
provider availability changes.
"""
from __future__ import annotations

import hashlib
import secrets
from typing import Dict, Optional

_BLOCK = 64  # blake2b keystream block size (digest size)

MAGIC = b"YBTPUENC"       # legacy v1 envelope: blake2b keystream only
MAGIC_V2 = b"YBTPUEN2"    # v2 envelope: + cipher id byte

CIPHER_BLAKE2B = 1
CIPHER_AES_CTR = 2


def aes_available() -> bool:
    try:
        from cryptography.hazmat.primitives.ciphers import (  # noqa: F401
            Cipher,
        )
        return True
    except ImportError:
        return False


class CipherStream:
    """Random-access XOR keystream: byte i uses block i//64 of
    blake2b(key, nonce || counter).  Fallback cipher (no provider)."""

    def __init__(self, key: bytes, nonce: bytes):
        self.key = key
        self.nonce = nonce

    def _block(self, counter: int) -> bytes:
        return hashlib.blake2b(
            self.nonce + counter.to_bytes(8, "big"),
            key=self.key, digest_size=_BLOCK).digest()

    def xor(self, data: bytes, offset: int = 0) -> bytes:
        import numpy as np
        first = offset // _BLOCK
        last = (offset + len(data) - 1) // _BLOCK if data else first
        stream = b"".join(self._block(c) for c in range(first, last + 1))
        start = offset % _BLOCK
        ks = np.frombuffer(stream, np.uint8)[start:start + len(data)]
        return (np.frombuffer(data, np.uint8) ^ ks).tobytes()


class AesCtrStream:
    """AES-256-CTR with random-access XOR semantics (reference:
    encryption/cipher_stream.h BlockAccessCipherStream over EVP
    AES-CTR).  The 16-byte nonce is the initial counter block; a read
    at `offset` seeks by advancing the counter offset//16 blocks and
    discarding offset%16 keystream bytes."""

    def __init__(self, key: bytes, nonce: bytes):
        assert len(nonce) == 16
        self.key = key
        self.nonce = nonce

    def xor(self, data: bytes, offset: int = 0) -> bytes:
        from cryptography.hazmat.primitives.ciphers import (
            Cipher, algorithms, modes,
        )
        ctr0 = (int.from_bytes(self.nonce, "big")
                + offset // 16) % (1 << 128)
        enc = Cipher(algorithms.AES(self.key),
                     modes.CTR(ctr0.to_bytes(16, "big"))).encryptor()
        skip = offset % 16
        if skip:
            enc.update(b"\x00" * skip)
        return enc.update(data)


def _stream_for(cipher_id: int, key: bytes, nonce: bytes):
    if cipher_id == CIPHER_AES_CTR:
        if not aes_available():
            raise ValueError(
                "file is AES-CTR encrypted but no crypto provider is "
                "importable on this host")
        return AesCtrStream(key, nonce)
    if cipher_id == CIPHER_BLAKE2B:
        return CipherStream(key, nonce)
    raise ValueError(f"unknown cipher id {cipher_id}")


class UniverseKeyManager:
    """Versioned key registry (key rotation keeps old versions
    readable).  New files use AES-CTR when the provider exists;
    `force_cipher` pins one (tests, mixed-host clusters)."""

    def __init__(self):
        self.keys: Dict[str, bytes] = {}
        self.active: Optional[str] = None
        self.force_cipher: Optional[int] = None

    def generate_key(self, version: Optional[str] = None) -> str:
        version = version or f"k{len(self.keys)}"
        self.keys[version] = secrets.token_bytes(32)
        self.active = version
        return version

    def add_key(self, version: str, key: bytes, activate: bool = True):
        self.keys[version] = key
        if activate:
            self.active = version

    def _write_cipher(self) -> int:
        if self.force_cipher is not None:
            return self.force_cipher
        return CIPHER_AES_CTR if aes_available() else CIPHER_BLAKE2B

    def encrypt_file_bytes(self, data: bytes) -> bytes:
        """v2 envelope: MAGIC_V2 + cipher + key version + nonce + ct."""
        if self.active is None:
            return data
        nonce = secrets.token_bytes(16)
        ver = self.active.encode()
        cipher_id = self._write_cipher()
        stream = _stream_for(cipher_id, self.keys[self.active], nonce)
        return (MAGIC_V2 + bytes([cipher_id, len(ver)]) + ver + nonce
                + stream.xor(data))

    def decrypt_file_bytes(self, data: bytes) -> bytes:
        if data.startswith(MAGIC_V2):
            cipher_id = data[len(MAGIC_V2)]
            vlen = data[len(MAGIC_V2) + 1]
            pos = len(MAGIC_V2) + 2
        elif data.startswith(MAGIC):
            cipher_id = CIPHER_BLAKE2B   # legacy v1: blake2b only
            vlen = data[len(MAGIC)]
            pos = len(MAGIC) + 1
        else:
            return data          # unencrypted file (mixed clusters)
        ver = data[pos:pos + vlen].decode()
        pos += vlen
        nonce = data[pos:pos + 16]
        pos += 16
        key = self.keys.get(ver)
        if key is None:
            raise ValueError(f"universe key {ver} not available")
        return _stream_for(cipher_id, key, nonce).xor(data[pos:])


# Process-wide manager; tablet servers receive keys from the master via
# heartbeat responses (round-2 wiring) or local config.
KEY_MANAGER = UniverseKeyManager()
