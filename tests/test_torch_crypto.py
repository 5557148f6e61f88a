"""At-rest encryption of the port against ``fire_tpu.gallery.crypto``
(which takes Fernet from the ``cryptography`` package).

* AES-128 in both builds of ``csrc/aes128_cbc.cpp`` (AES-NI where the CPU
  has it, and the portable T-tables): the FIPS-197 C.1 block, the
  SP 800-38A F.2.1 / F.2.2 CBC vectors, and ``cryptography``'s AES-CBC
  on ragged lengths.
* Blobs cross both ways between the two ``Encryptor``s for payloads of
  0, 1, 15, 16, 17 bytes and 1 MB; a token made from the same time and
  IV is byte-identical to Fernet's.
* A wrong password raises, and so does any changed byte.

PBKDF2 runs at 1,000 iterations here (both modules read the constant at
each call); the default is checked to equal the JAX package's 610,000.
"""

import base64
import os

import pytest
from cryptography.fernet import Fernet
from cryptography.fernet import InvalidToken as FernetInvalidToken
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

import fire_tpu.gallery.crypto as JC
from fire_tpu_torch.gallery import crypto as TC

BUILDS = {"native": (), "t-tables": ("-DFIRE_AES_TTABLE",)}
SIZES = [0, 1, 15, 16, 17, 1 << 20]


@pytest.fixture(autouse=True)
def _fast_kdf(monkeypatch):
    monkeypatch.setattr(JC, "PBKDF2_ITERATIONS", 1000)
    monkeypatch.setattr(TC, "PBKDF2_ITERATIONS", 1000)


DEFAULT_ITERATIONS = (TC.PBKDF2_ITERATIONS, JC.PBKDF2_ITERATIONS)  # before the fixture lowers them


def test_format_constants_equal_jax():
    assert DEFAULT_ITERATIONS == (610_000, 610_000)
    assert (TC.KEY_LENGTH, TC.SALT_BYTES) == (JC.KEY_LENGTH, JC.SALT_BYTES) == (32, 16)


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_fips197_c1(build):
    key = bytes(range(16))
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = TC.aes128_cbc_encrypt(key, bytes(16), block, pkcs7=False, extra_flags=BUILDS[build])
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    assert TC.aes128_cbc_decrypt(key, bytes(16), ct, pkcs7=False,
                                 extra_flags=BUILDS[build]) == block


SP_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
SP_IV = bytes(range(16))
SP_PLAIN = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
SP_CIPHER = bytes.fromhex(
    "7649abac8119b246cee98e9b12e9197d5086cb9b507219ee95db113a917678b2"
    "73bed6b8e3c1743b7116e69e222295163ff1caa1681fac09120eca307586e1a7")


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_sp800_38a_f21_cbc_encrypt(build):
    assert TC.aes128_cbc_encrypt(SP_KEY, SP_IV, SP_PLAIN, pkcs7=False,
                                 extra_flags=BUILDS[build]) == SP_CIPHER


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_sp800_38a_f22_cbc_decrypt(build):
    assert TC.aes128_cbc_decrypt(SP_KEY, SP_IV, SP_CIPHER, pkcs7=False,
                                 extra_flags=BUILDS[build]) == SP_PLAIN


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 63, 64, 65, 4099])
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_cbc_pkcs7_equals_cryptography(build, n):
    rng = os.urandom
    key, iv, data = rng(16), rng(16), rng(n)
    pad = 16 - n % 16
    enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
    want = enc.update(data + bytes([pad]) * pad) + enc.finalize()
    got = TC.aes128_cbc_encrypt(key, iv, data, extra_flags=BUILDS[build])
    assert got == want
    assert TC.aes128_cbc_decrypt(key, iv, got, extra_flags=BUILDS[build]) == data


def test_backends_name_their_build():
    assert TC.backend(BUILDS["t-tables"]) == "t-tables"
    assert TC.backend() in ("aes-ni", "t-tables")
    assert TC.library_path() != TC.library_path(BUILDS["t-tables"])


def test_bad_lengths_and_pads_raise():
    key, iv = bytes(16), bytes(16)
    with pytest.raises(ValueError):
        TC.aes128_cbc_encrypt(key, iv, b"x" * 15, pkcs7=False)
    with pytest.raises(TC.InvalidToken):
        TC.aes128_cbc_decrypt(key, iv, b"x" * 15)
    with pytest.raises(TC.InvalidToken):  # a block whose last byte is no pad
        TC.aes128_cbc_decrypt(key, iv, TC.aes128_cbc_encrypt(key, iv, bytes(16), pkcs7=False))


def test_failed_build_raises(monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="C\\+\\+ build failed"):
        TC.build(("-DFIRE_NO_SUCH_LIBRARY_YET",))


def test_fernet_token_is_byte_identical():
    key = Fernet.generate_key()
    iv = os.urandom(16)
    for data in (b"", b"hello", os.urandom(1000)):
        assert TC.fernet_encrypt(key, data, now=1_700_000_000, iv=iv) == \
            Fernet(key)._encrypt_from_parts(data, 1_700_000_000, iv)


def test_key_derivation_equals_jax():
    salt = os.urandom(16)
    assert TC.derive_key(b"pw", salt) == JC.Encryptor("pw")._key(salt)


@pytest.mark.parametrize("n", SIZES)
def test_blobs_cross_both_ways(n):
    data = os.urandom(n)
    j, t = JC.Encryptor("secret"), TC.Encryptor("secret")
    from_jax, from_port = j.encrypt_data(data), t.encrypt_data(data)
    assert t.decrypt_data(from_jax) == data
    assert j.decrypt_data(from_port) == data
    assert len(from_port) == len(from_jax)  # salt + token of the same length
    assert from_port[:16] != from_jax[:16]  # a fresh salt each time


def test_files_cross_both_ways(tmp_path):
    data = os.urandom(5000)
    TC.Encryptor("pw").encrypt_and_write(str(tmp_path / "a"), data)
    assert JC.Encryptor("pw").read_and_decrypt(str(tmp_path / "a")) == data
    JC.Encryptor("pw").encrypt_and_write(str(tmp_path / "b"), data)
    assert TC.Encryptor("pw").read_and_decrypt(str(tmp_path / "b")) == data


def test_wrong_password_raises():
    blob = JC.Encryptor("right").encrypt_data(b"faces")
    with pytest.raises(TC.InvalidToken):
        TC.Encryptor("wrong").decrypt_data(blob)
    with pytest.raises(FernetInvalidToken):
        JC.Encryptor("wrong").decrypt_data(TC.Encryptor("right").encrypt_data(b"faces"))


@pytest.mark.parametrize("where", ["salt", "version", "time", "iv", "ciphertext", "mac",
                                   "truncated", "not base64"])
def test_a_changed_byte_raises(where):
    enc = TC.Encryptor("pw")
    blob = bytearray(enc.encrypt_data(os.urandom(100)))
    token = base64.urlsafe_b64decode(bytes(blob[16:]))
    raw = bytearray(token)
    pos = {"version": 0, "time": 3, "iv": 12, "ciphertext": 40, "mac": len(raw) - 1}
    if where == "salt":
        blob[0] ^= 1
    elif where == "truncated":
        blob = blob[:-5]
    elif where == "not base64":
        blob[20] = ord("*")
    else:
        raw[pos[where]] ^= 1
        blob = blob[:16] + bytearray(base64.urlsafe_b64encode(bytes(raw)))
    with pytest.raises(TC.InvalidToken):
        enc.decrypt_data(bytes(blob))
