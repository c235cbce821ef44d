"""AES-256-GCM of chunk data. The JAX package's ``util/cipher.py``: a
fresh random key per chunk (kept in the filer's metadata,
``FileChunk.cipher_key``), a random 12-byte nonce prepended, the 16-byte
tag appended, so volume servers only ever hold ciphertext.

One path: OpenSSL's EVP interface through ctypes (``libcrypto``, which
every Python with ``ssl`` links). Where libcrypto cannot be loaded,
``encrypt`` and ``decrypt`` raise ``CipherError``."""

from __future__ import annotations

import ctypes
import ctypes.util
import os

from .locks import make_lock

KEY_SIZE = 32
NONCE_SIZE = 12
TAG_SIZE = 16

_EVP_CTRL_GCM_SET_IVLEN = 0x9
_EVP_CTRL_GCM_GET_TAG = 0x10
_EVP_CTRL_GCM_SET_TAG = 0x11

_lib = None
_lib_lock = make_lock("torch.cipher._lib_lock")


class CipherError(Exception):
    pass


def _crypto():
    global _lib
    with _lib_lock:
        if _lib is None:
            name = ctypes.util.find_library("crypto") or "libcrypto.so"
            try:
                lib = ctypes.CDLL(name)
            except OSError as e:
                raise CipherError(f"libcrypto not found: {e}") from None
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib):
    vp, i, ip, cp = (ctypes.c_void_p, ctypes.c_int,
                     ctypes.POINTER(ctypes.c_int), ctypes.c_char_p)
    for name, res, args in (
            ("EVP_CIPHER_CTX_new", vp, []),
            ("EVP_CIPHER_CTX_free", None, [vp]),
            ("EVP_aes_256_gcm", vp, []),
            ("EVP_CIPHER_CTX_ctrl", i, [vp, i, i, vp]),
            ("EVP_EncryptInit_ex", i, [vp, vp, vp, cp, cp]),
            ("EVP_DecryptInit_ex", i, [vp, vp, vp, cp, cp]),
            ("EVP_EncryptUpdate", i, [vp, vp, ip, cp, i]),
            ("EVP_DecryptUpdate", i, [vp, vp, ip, cp, i]),
            ("EVP_EncryptFinal_ex", i, [vp, vp, ip]),
            ("EVP_DecryptFinal_ex", i, [vp, vp, ip])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def _context(lib, key: bytes, nonce: bytes, encrypt: bool):
    ctx = ctypes.c_void_p(lib.EVP_CIPHER_CTX_new())
    if not ctx:
        raise CipherError("EVP_CIPHER_CTX_new failed")
    init = lib.EVP_EncryptInit_ex if encrypt else lib.EVP_DecryptInit_ex
    if init(ctx, ctypes.c_void_p(lib.EVP_aes_256_gcm()), None, None,
            None) != 1 or \
            lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_SET_IVLEN,
                                    len(nonce), None) != 1 or \
            init(ctx, None, None, key, nonce) != 1:
        lib.EVP_CIPHER_CTX_free(ctx)
        raise CipherError("EVP init failed")
    return ctx


def _seal(key: bytes, nonce: bytes, plain: bytes) -> bytes:
    lib = _crypto()
    ctx = _context(lib, key, nonce, encrypt=True)
    try:
        outl = ctypes.c_int(0)
        out = ctypes.create_string_buffer(len(plain) + TAG_SIZE)
        if lib.EVP_EncryptUpdate(ctx, out, ctypes.byref(outl), plain,
                                 len(plain)) != 1:
            raise CipherError("EVP encrypt failed")
        total = outl.value
        if lib.EVP_EncryptFinal_ex(ctx, ctypes.addressof(out) + total,
                                   ctypes.byref(outl)) != 1:
            raise CipherError("EVP encrypt final failed")
        total += outl.value
        tag = ctypes.create_string_buffer(TAG_SIZE)
        if lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_GCM_GET_TAG, TAG_SIZE,
                                   ctypes.addressof(tag)) != 1:
            raise CipherError("EVP get tag failed")
        return out.raw[:total] + tag.raw
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


def _open(key: bytes, nonce: bytes, sealed: bytes) -> bytes:
    ct, tag = sealed[:-TAG_SIZE], sealed[-TAG_SIZE:]
    lib = _crypto()
    ctx = _context(lib, key, nonce, encrypt=False)
    try:
        outl = ctypes.c_int(0)
        out = ctypes.create_string_buffer(max(len(ct), 1))
        ok = lib.EVP_DecryptUpdate(ctx, out, ctypes.byref(outl), ct,
                                   len(ct)) == 1
        total = outl.value
        ok = ok and lib.EVP_CIPHER_CTX_ctrl(
            ctx, _EVP_CTRL_GCM_SET_TAG, TAG_SIZE, tag) == 1
        ok = ok and lib.EVP_DecryptFinal_ex(
            ctx, ctypes.addressof(out) + total, ctypes.byref(outl)) == 1
        if not ok:
            raise CipherError("decryption failed (wrong key or corrupt "
                              "ciphertext)")
        return out.raw[:total + outl.value]
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


def gen_key() -> bytes:
    return os.urandom(KEY_SIZE)


def encrypt(plain: bytes, key: bytes = None) -> tuple:
    """(nonce || ciphertext || tag, key); a fresh key when none is
    given."""
    if key is None:
        key = gen_key()
    if len(key) != KEY_SIZE:
        raise CipherError(f"key must be {KEY_SIZE} bytes, got {len(key)}")
    nonce = os.urandom(NONCE_SIZE)
    return nonce + _seal(bytes(key), nonce, bytes(plain)), key


def decrypt(blob: bytes, key: bytes) -> bytes:
    if len(key) != KEY_SIZE:
        raise CipherError(f"key must be {KEY_SIZE} bytes, got {len(key)}")
    if len(blob) < NONCE_SIZE + TAG_SIZE:
        raise CipherError("ciphertext too short")
    blob = bytes(blob)
    return _open(bytes(key), blob[:NONCE_SIZE], blob[NONCE_SIZE:])
