"""Google Pub/Sub publisher over the REST API (no SDK): the JAX
package's ``notification/google_pub_sub.py``, with its own DER, PEM and
RSA code.

Reference weed/notification/google_pub_sub/google_pub_sub.go (the
official cloud client): publish each filer metadata event to a topic
with the path in the `key` attribute. This build talks to the same
surface from scratch:

  * service-account auth: the OAuth2 JWT-bearer grant
    (RFC 7523) — a JWT over the SA's client_email/scope, signed
    RS256 with the SA's private key, exchanged at token_uri for a
    bearer token (cached until ~expiry);
  * RS256 itself is implemented here: minimal DER/ASN.1 parsing of
    the PKCS#8/PKCS#1 private key and EMSA-PKCS1-v1_5 + SHA-256 with
    plain modular exponentiation (python ints are fine at this rate:
    one signature per ~55-minute token refresh);
  * publish: POST v1/projects/{p}/topics/{t}:publish with base64
    message data + attributes {"key": <path>}, like the reference.

`endpoint`/`token_uri` overrides exist so the in-process fake in
the tests (which VERIFIES the RSA signature with the
key's public half) can stand in for the real service — the same
treatment every external protocol gets here (kafka/SQS/mysql/redis).
"""

from __future__ import annotations

import base64
import hashlib
import json
import time
from typing import List, Optional, Tuple

from .queues import Publisher, _post_with_retries, register

# -- minimal DER (ASN.1) reader ---------------------------------------------


def _der_read(buf: bytes, pos: int) -> Tuple[int, bytes, int]:
    """One TLV: returns (tag, value, next_pos)."""
    tag = buf[pos]
    pos += 1
    first = buf[pos]
    pos += 1
    if first & 0x80:
        nlen = first & 0x7F
        length = int.from_bytes(buf[pos:pos + nlen], "big")
        pos += nlen
    else:
        length = first
    return tag, buf[pos:pos + length], pos + length


def _der_ints(seq: bytes, count: int) -> List[int]:
    out, pos = [], 0
    while len(out) < count and pos < len(seq):
        tag, val, pos = _der_read(seq, pos)
        if tag != 0x02:
            raise ValueError(f"expected DER INTEGER, got tag {tag:#x}")
        out.append(int.from_bytes(val, "big"))
    if len(out) < count:
        raise ValueError("truncated RSA key")
    return out


def _pem_body(pem: str, kinds) -> Tuple[str, bytes]:
    for kind in kinds:
        begin, end = f"-----BEGIN {kind}-----", f"-----END {kind}-----"
        if begin in pem:
            body = pem.split(begin, 1)[1].split(end, 1)[0]
            return kind, base64.b64decode("".join(body.split()))
    raise ValueError(f"no {'/'.join(kinds)} block in PEM")


class RsaPrivateKey:
    """n, e, d from a PKCS#8 ("PRIVATE KEY", what Google issues) or
    PKCS#1 ("RSA PRIVATE KEY") PEM."""

    def __init__(self, n: int, e: int, d: int):
        self.n, self.e, self.d = n, e, d
        self.size = (n.bit_length() + 7) // 8

    @classmethod
    def from_pem(cls, pem: str) -> "RsaPrivateKey":
        kind, der = _pem_body(pem, ("PRIVATE KEY", "RSA PRIVATE KEY"))
        tag, seq, _ = _der_read(der, 0)
        if tag != 0x30:
            raise ValueError("bad DER: outer SEQUENCE missing")
        if kind == "PRIVATE KEY":
            # PKCS#8: version, AlgorithmIdentifier, OCTET STRING(PKCS#1)
            pos = 0
            _, _version, pos = _der_read(seq, pos)
            _, _alg, pos = _der_read(seq, pos)
            tag, inner, pos = _der_read(seq, pos)
            if tag != 0x04:
                raise ValueError("bad PKCS#8: key OCTET STRING missing")
            tag, seq, _ = _der_read(inner, 0)
            if tag != 0x30:
                raise ValueError("bad PKCS#1 inside PKCS#8")
        # PKCS#1 RSAPrivateKey: version, n, e, d, ...
        version, n, e, d = _der_ints(seq, 4)
        return cls(n, e, d)


# SHA-256 DigestInfo prefix (RFC 8017 §9.2 note 1)
_SHA256_PREFIX = bytes.fromhex(
    "3031300d060960864801650304020105000420")


def rs256_sign(key: RsaPrivateKey, data: bytes) -> bytes:
    """RSASSA-PKCS1-v1_5 with SHA-256."""
    digest = hashlib.sha256(data).digest()
    t = _SHA256_PREFIX + digest
    ps = b"\xff" * (key.size - len(t) - 3)
    em = int.from_bytes(b"\x00\x01" + ps + b"\x00" + t, "big")
    return pow(em, key.d, key.n).to_bytes(key.size, "big")


def _b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


@register
class GooglePubSubPublisher(Publisher):
    """`notification.toml [notification.google_pub_sub]` analog:
    google_application_credentials (SA json path), project_id, topic;
    endpoint/token_uri overrides for tests/self-hosted emulators."""

    name = "google_pub_sub"

    SCOPE = "https://www.googleapis.com/auth/pubsub"

    def initialize(self, google_application_credentials: str = "",
                   project_id: str = "", topic: str = "seaweedfs_filer",
                   endpoint: str = "https://pubsub.googleapis.com",
                   token_uri: str = "", timeout: float = 10.0,
                   retries: int = 3, **options):
        if not google_application_credentials:
            raise ValueError(
                "google_pub_sub needs google_application_credentials "
                "(service-account json path)")
        with open(google_application_credentials) as f:
            sa = json.load(f)
        self._email = sa["client_email"]
        self._key = RsaPrivateKey.from_pem(sa["private_key"])
        self._token_uri = token_uri or sa.get(
            "token_uri", "https://oauth2.googleapis.com/token")
        self.project_id = project_id or sa.get("project_id", "")
        if not self.project_id:
            raise ValueError("google_pub_sub needs a project_id")
        self.topic = topic
        self.endpoint = endpoint.rstrip("/")
        self.timeout = float(timeout)
        self.retries = max(1, int(retries))
        self._token: Optional[str] = None
        self._token_exp = 0.0

    # -- oauth2 jwt-bearer grant (RFC 7523) --------------------------------

    def _jwt_assertion(self, now: float) -> str:
        header = _b64url(json.dumps(
            {"alg": "RS256", "typ": "JWT"}).encode())
        claims = _b64url(json.dumps({
            "iss": self._email, "scope": self.SCOPE,
            "aud": self._token_uri,
            "iat": int(now), "exp": int(now) + 3600}).encode())
        signing_input = f"{header}.{claims}".encode()
        sig = _b64url(rs256_sign(self._key, signing_input))
        return f"{header}.{claims}.{sig}"

    def _bearer(self) -> str:
        now = time.time()
        if self._token and now < self._token_exp - 300:
            return self._token
        from urllib.parse import urlencode
        body = urlencode({
            "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
            "assertion": self._jwt_assertion(now)}).encode()
        # the token endpoint gets the same centralized retry
        # discipline as every publisher POST: a blip at the
        # ~55-minute refresh boundary must not drop the event
        raw = _post_with_retries(
            self._token_uri, body,
            {"Content-Type": "application/x-www-form-urlencoded"},
            self.timeout, self.retries, "google_pub_sub token grant")
        tok = json.loads(raw)
        self._token = tok["access_token"]
        self._token_exp = now + float(tok.get("expires_in", 3600))
        return self._token

    # -- publish ------------------------------------------------------------

    def send(self, key: str, event: dict) -> None:
        body = json.dumps({"messages": [{
            "data": base64.b64encode(
                json.dumps(event).encode()).decode(),
            "attributes": {"key": key},
        }]}).encode()
        url = (f"{self.endpoint}/v1/projects/{self.project_id}"
               f"/topics/{self.topic}:publish")
        try:
            _post_with_retries(
                url, body,
                {"Content-Type": "application/json",
                 "Authorization": f"Bearer {self._bearer()}"},
                self.timeout, self.retries, "google_pub_sub")
        except RuntimeError as e:
            # a 401 with ~55 minutes left on the cached token means the
            # server revoked it (key rotation, emulator restart):
            # re-auth once instead of dropping every event until local
            # expiry (the reference's google-auth client refreshes on
            # 401 the same way)
            from ..server.http_util import HttpError
            cause = e.__cause__
            if not (isinstance(cause, HttpError)
                    and cause.status == 401):
                raise
            self._token = None
            _post_with_retries(
                url, body,
                {"Content-Type": "application/json",
                 "Authorization": f"Bearer {self._bearer()}"},
                self.timeout, self.retries, "google_pub_sub")
