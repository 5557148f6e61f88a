"""At-rest encryption (counterpart of ``fire_tpu.gallery.crypto``),
byte-compatible with it: a file written by either package decrypts in
the other.

Format, per blob: ``salt(16) ‖ Fernet token``.  The key is
``urlsafe_b64(PBKDF2-HMAC-SHA256(password, salt, 610_000, 32))``; its
first 16 bytes sign and its last 16 encrypt.  The token is the urlsafe
base64 of ``0x80 ‖ 8-byte big-endian time ‖ 16-byte IV ‖
AES-128-CBC(PKCS7)`` followed by the HMAC-SHA256 of all of that.

The JAX package takes Fernet from the ``cryptography`` package, which
the card's machine does not have.  Here PBKDF2, HMAC, base64 and the
random bytes come from Python's standard library, and AES-128-CBC is
hand-written C++ (``fire_tpu_torch/csrc/aes128_cbc.cpp``), compiled for
the host CPU at first use with the host C++ compiler into
``fire_tpu_torch/_build/`` (named by the hash of the source, the flags
and the host CPU) and bound with ``ctypes``.  A failed build raises;
there is no fallback to any package.  Decryption checks the HMAC
(``hmac.compare_digest``) before it decrypts and raises
:class:`InvalidToken` on a wrong password or a changed byte.

Every call derives its key anew at ``PBKDF2_ITERATIONS`` (as the JAX
package does; caching keys would change the format's security).  The
constant is read at each call, so tests can lower it.
"""

from __future__ import annotations

import base64
import binascii
import ctypes
import hashlib
import hmac
import logging
import os
import struct
import time
from typing import Optional, Sequence

from fire_tpu_torch.runtime import build as hostbuild

log = logging.getLogger(__name__)

PBKDF2_ITERATIONS = 610_000
KEY_LENGTH = 32
SALT_BYTES = 16

SOURCE = os.path.join(hostbuild.CSRC, "aes128_cbc.cpp")
CXX_FLAGS = hostbuild.CXX_FLAGS

_VERSION = 0x80
_HEADER = 1 + 8 + 16  # version, timestamp, IV
_MAC = 32

_libs = {}


class InvalidToken(Exception):
    """A blob that does not decrypt: wrong password, changed or
    truncated bytes."""


def library_path(extra_flags: Sequence[str] = ()) -> str:
    """The library's path, named by the hash of the source, the flags and
    the host CPU."""
    return hostbuild.library_path(SOURCE, "libaes128_cbc", (*CXX_FLAGS, *extra_flags))


def build(extra_flags: Sequence[str] = ()) -> str:
    """Compile the library unless this source and these flags have one.
    ``extra_flags`` (``-DFIRE_AES_TTABLE``) select the portable T-table
    implementation where the CPU has AES-NI.  Returns the path."""
    return hostbuild.build(SOURCE, "libaes128_cbc", (*CXX_FLAGS, *extra_flags))


def library(extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    key = tuple(extra_flags)
    lib = _libs.get(key)
    if lib is None:
        lib = ctypes.CDLL(build(extra_flags))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.fire_aes128_cbc_encrypt, lib.fire_aes128_cbc_decrypt):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, i64, i32, ptr]
            fn.restype = i64
        lib.fire_aes_backend.argtypes = []
        lib.fire_aes_backend.restype = i32
        _libs[key] = lib
    return lib


def backend(extra_flags: Sequence[str] = ()) -> str:
    """``"aes-ni"`` or ``"t-tables"``: what the library was built with."""
    return "aes-ni" if library(extra_flags).fire_aes_backend() else "t-tables"


def _buffer(n: int):
    buf = bytearray(n)
    return buf, (ctypes.c_char * max(n, 1)).from_buffer(buf) if n else None


def aes128_cbc_encrypt(key: bytes, iv: bytes, data: bytes, pkcs7: bool = True,
                       extra_flags: Sequence[str] = ()) -> bytes:
    """AES-128-CBC of ``data``, PKCS7-padded unless ``pkcs7`` is False
    (then ``len(data)`` must be a multiple of 16)."""
    if len(key) != 16 or len(iv) != 16:
        raise ValueError("AES-128-CBC takes a 16-byte key and a 16-byte IV")
    n = len(data)
    out, c_out = _buffer((n // 16 + 1) * 16 if pkcs7 else n)
    got = library(extra_flags).fire_aes128_cbc_encrypt(key, iv, bytes(data), n, int(pkcs7), c_out)
    if got < 0:
        raise ValueError(f"AES-128-CBC: {n} bytes is not a whole number of blocks")
    return bytes(out)


def aes128_cbc_decrypt(key: bytes, iv: bytes, data: bytes, pkcs7: bool = True,
                       extra_flags: Sequence[str] = ()) -> bytes:
    """Inverse of :func:`aes128_cbc_encrypt`; raises :class:`InvalidToken`
    on a length that is not whole blocks or a bad pad."""
    if len(key) != 16 or len(iv) != 16:
        raise ValueError("AES-128-CBC takes a 16-byte key and a 16-byte IV")
    n = len(data)
    out, c_out = _buffer(n)
    got = library(extra_flags).fire_aes128_cbc_decrypt(key, iv, bytes(data), n, int(pkcs7), c_out)
    if got < 0:
        raise InvalidToken("bad ciphertext length" if got == -1 else "bad padding")
    return bytes(memoryview(out)[:got])


def derive_key(password: bytes, salt: bytes) -> bytes:
    """The Fernet key of ``password`` and ``salt``: urlsafe base64 of 32
    PBKDF2-HMAC-SHA256 bytes."""
    raw = hashlib.pbkdf2_hmac("sha256", password, salt, PBKDF2_ITERATIONS, KEY_LENGTH)
    return base64.urlsafe_b64encode(raw)


def fernet_encrypt(key: bytes, data: bytes, now: Optional[int] = None,
                   iv: Optional[bytes] = None) -> bytes:
    """A Fernet token of ``data`` under ``key`` (urlsafe base64 of 32
    bytes); ``now`` and ``iv`` default to the clock and fresh random
    bytes."""
    raw = base64.urlsafe_b64decode(key)
    if len(raw) != 32:
        raise ValueError("a Fernet key is 32 bytes in urlsafe base64")
    sign, enc = raw[:16], raw[16:]
    iv = os.urandom(16) if iv is None else iv
    stamp = int(time.time()) if now is None else now
    body = (bytes([_VERSION]) + struct.pack(">Q", stamp) + iv
            + aes128_cbc_encrypt(enc, iv, data))
    return base64.urlsafe_b64encode(body + hmac.new(sign, body, hashlib.sha256).digest())


def fernet_decrypt(key: bytes, token: bytes) -> bytes:
    """The plaintext of a Fernet token; the signature is checked first.
    The token's time is not checked (the JAX package gives no TTL)."""
    raw = base64.urlsafe_b64decode(key)
    sign, enc = raw[:16], raw[16:]
    try:
        data = base64.urlsafe_b64decode(token)
    except (TypeError, binascii.Error) as e:
        raise InvalidToken("token is not urlsafe base64") from e
    if len(data) < _HEADER + _MAC or data[0] != _VERSION:
        raise InvalidToken("not a Fernet token")
    body, mac = data[:-_MAC], data[-_MAC:]
    if not hmac.compare_digest(hmac.new(sign, body, hashlib.sha256).digest(), mac):
        raise InvalidToken("signature does not match: wrong password or changed bytes")
    return aes128_cbc_decrypt(enc, body[9:_HEADER], body[_HEADER:])


class Encryptor:
    """Password-based encryption of bytes and files, in the JAX
    package's format."""

    def __init__(self, password: str):
        self._password = password.encode()

    def _key(self, salt: bytes) -> bytes:
        return derive_key(self._password, salt)

    def encrypt_data(self, data: bytes) -> bytes:
        salt = os.urandom(SALT_BYTES)
        return salt + fernet_encrypt(self._key(salt), data)

    def decrypt_data(self, blob: bytes) -> bytes:
        salt, token = blob[:SALT_BYTES], blob[SALT_BYTES:]
        return fernet_decrypt(self._key(salt), token)

    def encrypt_and_write(self, path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(self.encrypt_data(data))
        log.info("Encrypted and saved data to %s.", path)

    def read_and_decrypt(self, path: str) -> bytes:
        with open(path, "rb") as f:
            blob = f.read()
        data = self.decrypt_data(blob)
        log.info("Decrypted and loaded data from %s.", path)
        return data
