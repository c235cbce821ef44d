"""HS256 JSON web tokens that authorize a write to one file id. The JAX
package's ``security/jwt.py``: the master mints a token bound to the fid
it assigns (``GenJwt``, ``exp`` ten seconds on), and a volume server
holding the same key verifies it before a write or a delete. The wire
form is the standard one (base64url header.payload.signature)."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional


class VerifyError(Exception):
    pass


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def encode_jwt(key: str, claims: dict) -> str:
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"},
                             separators=(",", ":")).encode())
    payload = _b64(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(key.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64(sig)}"


def decode_jwt(key: str, token: str) -> dict:
    """The claims of a token signed with ``key``; VerifyError for a
    malformed, forged or expired one."""
    try:
        header, payload, sig = token.split(".")
    except ValueError:
        raise VerifyError("malformed token") from None
    signing_input = f"{header}.{payload}".encode()
    want = hmac.new(key.encode(), signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(want, _unb64(sig)):
        raise VerifyError("bad signature")
    claims = json.loads(_unb64(payload))
    exp = claims.get("exp")
    if exp is not None and time.time() > exp:
        raise VerifyError("token expired")
    return claims


def GenJwt(key: str, fid: str, expires_seconds: int = 10) -> str:
    """A write token bound to ``fid``."""
    return encode_jwt(key, {"fid": fid,
                            "exp": int(time.time()) + expires_seconds})


def verify_fid_jwt(key: str, token: str, fid: str) -> None:
    claims = decode_jwt(key, token)
    if claims.get("fid") != fid:
        raise VerifyError(f"token not valid for {fid}")


def jwt_from_request(headers, query: dict) -> Optional[str]:
    """The token of ``Authorization: Bearer <t>``, else of ``?jwt=``."""
    auth = headers.get("Authorization", "")
    if auth.startswith("Bearer "):
        return auth[len("Bearer "):].strip()
    return query.get("jwt") or None
