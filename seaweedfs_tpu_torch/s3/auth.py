"""AWS request signatures and the gateway's identities. The JAX
package's ``s3/auth.py``:

- ``Iam`` / ``Identity`` (``Iam.from_config`` reads the reference's
  ``{"identities": [{name, credentials: [{accessKey, secretKey}],
  actions}]}``); an action is global (``Write``) or scoped to a bucket
  (``Write:bucket``), ``Admin`` covers all;
- verification of SigV4 by header (``verify_v4``: the payload hash, a
  15-minute clock window) and presigned (``verify_v4_presigned``:
  ``X-Amz-Expires``), and of SigV2; ``authenticate`` picks by style;
- ``decode_aws_chunked``, the STREAMING-AWS4-HMAC-SHA256-PAYLOAD
  framing, each chunk's signature checked along the chain;
- the client side: ``authorization_header_v4`` (every lowercase header
  signed: the tier backend's), ``sign_request_v4`` and
  ``presign_url_v4``.

The canonical request uses the path exactly as sent on the wire, as the
S3 SDKs sign it (no second encoding).
"""

from __future__ import annotations

import base64
import calendar
import hashlib
import hmac
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_ADMIN = "Admin"
ACTION_LIST = "List"

UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"


class S3AuthError(Exception):
    def __init__(self, status: int, code: str, message: str = ""):
        super().__init__(message or code)
        self.status = status
        self.code = code


class Identity:
    def __init__(self, name: str, access_key: str, secret_key: str,
                 actions: Optional[List[str]] = None):
        self.name = name
        self.access_key = access_key
        self.secret_key = secret_key
        self.actions = actions or [ACTION_ADMIN]

    def can(self, action: str, bucket: str) -> bool:
        """Actions may be global ("Write") or bucket-scoped
        ("Write:bucketname") — reference auth_credentials.go canDo."""
        for a in self.actions:
            if a == ACTION_ADMIN or a == f"{ACTION_ADMIN}:{bucket}":
                return True
            if a == action or a == f"{action}:{bucket}":
                return True
        return False


class Iam:
    """Identity store (reference s3api IdentityAccessManagement)."""

    def __init__(self, identities: Optional[List[Identity]] = None):
        self.identities = identities or []

    @property
    def enabled(self) -> bool:
        return bool(self.identities)

    def lookup(self, access_key: str) -> Optional[Identity]:
        for ident in self.identities:
            if ident.access_key == access_key:
                return ident
        return None

    @classmethod
    def from_config(cls, cfg: dict) -> "Iam":
        """Parse the reference's s3 config JSON shape
        ({"identities": [{name, credentials: [{accessKey, secretKey}],
        actions: [...]}]})."""
        idents = []
        for i in cfg.get("identities", []):
            for cred in i.get("credentials", []):
                idents.append(Identity(
                    i.get("name", cred["accessKey"]),
                    cred["accessKey"], cred["secretKey"],
                    i.get("actions")))
        return cls(idents)


# -- SigV4 core -------------------------------------------------------------

def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def derive_signing_key(secret: str, date: str, region: str,
                       service: str = "s3") -> bytes:
    k = _hmac(b"AWS4" + secret.encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-._~" if encode_slash else "-._~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query_pairs: List[Tuple[str, str]],
                    skip: Tuple[str, ...] = ()) -> str:
    pairs = sorted((k, v) for k, v in query_pairs if k not in skip)
    return "&".join(f"{_uri_encode(k)}={_uri_encode(v)}"
                    for k, v in pairs)


def canonical_request(method: str, path: str,
                      query_pairs: List[Tuple[str, str]],
                      headers: Dict[str, str], signed_headers: List[str],
                      payload_hash: str,
                      skip_query: Tuple[str, ...] = ()) -> str:
    """`path` must be the request path exactly as sent on the wire
    (already percent-encoded). For S3, SigV4 uses it as-is — re-encoding
    here would double-encode keys with spaces etc. and break real AWS
    clients (SDKs sign with UriEscapePath=false for S3)."""
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    return "\n".join([
        method,
        path or "/",
        canonical_query(query_pairs, skip=skip_query),
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canon_req.encode()).hexdigest()])


def authorization_header_v4(method: str, path: str,
                            headers: Dict[str, str], payload_hash: str,
                            access_key: str, secret_key: str,
                            region: str, service: str = "s3",
                            amz_date: str = None) -> str:
    """The Authorization value of a request whose lowercase ``headers``
    (host, x-amz-date and x-amz-content-sha256 among them) are all
    signed; ``path`` exactly as sent, no query."""
    amz_date = amz_date or headers["x-amz-date"]
    date = amz_date[:8]
    signed = sorted(headers)
    canon = canonical_request(method, path, [], headers, signed,
                              payload_hash)
    scope = f"{date}/{region}/{service}/aws4_request"
    sig = _hmac(derive_signing_key(secret_key, date, region, service),
                string_to_sign(amz_date, scope, canon)).hex()
    return (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")


def _parse_auth_header(auth: str) -> Tuple[str, str, str, List[str], str]:
    """-> (access_key, date, region, signed_headers, signature)"""
    if not auth.startswith("AWS4-HMAC-SHA256"):
        raise S3AuthError(400, "AuthorizationHeaderMalformed")
    fields: Dict[str, str] = {}
    for part in auth[len("AWS4-HMAC-SHA256"):].split(","):
        part = part.strip()
        if "=" in part:
            k, v = part.split("=", 1)
            fields[k.strip()] = v.strip()
    try:
        cred = fields["Credential"].split("/")
        access_key, date, region = cred[0], cred[1], cred[2]
        signed = fields["SignedHeaders"].split(";")
        sig = fields["Signature"]
    except (KeyError, IndexError):
        raise S3AuthError(400, "AuthorizationHeaderMalformed") from None
    return access_key, date, region, signed, sig


def _check_date_window(amz_date: str, window_s: int = 15 * 60):
    """Reject requests signed outside the ±15-minute skew window
    (AWS RequestTimeTooSkewed; the reference enforces it in
    auth_signature_v4.go). Presigned requests expire via
    X-Amz-Expires instead."""
    try:
        ts = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        raise S3AuthError(403, "AccessDenied",
                          f"bad x-amz-date {amz_date!r}") from None
    if abs(time.time() - ts) > window_s:
        raise S3AuthError(403, "RequestTimeTooSkewed",
                          "request signature timestamp outside the "
                          "allowed window")


def verify_v4(iam: Iam, method: str, path: str,
              query_pairs: List[Tuple[str, str]], headers: Dict[str, str],
              body: bytes) -> Identity:
    """Header-based SigV4 check (reference doesSignatureMatch)."""
    lower = {k.lower(): v for k, v in headers.items()}
    access_key, date, region, signed, given_sig = \
        _parse_auth_header(lower.get("authorization", ""))
    ident = iam.lookup(access_key)
    if ident is None:
        raise S3AuthError(403, "InvalidAccessKeyId")
    payload_hash = lower.get("x-amz-content-sha256", UNSIGNED_PAYLOAD)
    if payload_hash not in (UNSIGNED_PAYLOAD,) and \
            not payload_hash.startswith(STREAMING_PAYLOAD):
        actual = hashlib.sha256(body).hexdigest()
        if actual != payload_hash:
            raise S3AuthError(403, "XAmzContentSHA256Mismatch")
    amz_date = lower.get("x-amz-date", "")
    _check_date_window(amz_date)
    scope = f"{date}/{region}/s3/aws4_request"
    canon = canonical_request(method, path, query_pairs, lower, signed,
                              payload_hash)
    sts = string_to_sign(amz_date, scope, canon)
    key = derive_signing_key(ident.secret_key, date, region)
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, given_sig):
        raise S3AuthError(403, "SignatureDoesNotMatch")
    return ident


def verify_v4_presigned(iam: Iam, method: str, path: str,
                        query_pairs: List[Tuple[str, str]],
                        headers: Dict[str, str]) -> Identity:
    """Query-string SigV4 (reference doesPresignedSignatureMatch)."""
    q = dict(query_pairs)
    try:
        cred = q["X-Amz-Credential"].split("/")
        access_key, date, region = cred[0], cred[1], cred[2]
        signed = q["X-Amz-SignedHeaders"].split(";")
        given_sig = q["X-Amz-Signature"]
        amz_date = q["X-Amz-Date"]
    except (KeyError, IndexError):
        raise S3AuthError(400, "AuthorizationQueryParametersError") \
            from None
    expires = int(q.get("X-Amz-Expires", "900"))
    t0 = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
    if time.time() - t0 > expires:
        raise S3AuthError(403, "AccessDenied", "request expired")
    ident = iam.lookup(access_key)
    if ident is None:
        raise S3AuthError(403, "InvalidAccessKeyId")
    lower = {k.lower(): v for k, v in headers.items()}
    scope = f"{date}/{region}/s3/aws4_request"
    canon = canonical_request(method, path, query_pairs, lower, signed,
                              UNSIGNED_PAYLOAD,
                              skip_query=("X-Amz-Signature",))
    sts = string_to_sign(amz_date, scope, canon)
    key = derive_signing_key(ident.secret_key, date, region)
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, given_sig):
        raise S3AuthError(403, "SignatureDoesNotMatch")
    return ident


def verify_v2(iam: Iam, method: str, path: str, headers: Dict[str, str],
              ) -> Identity:
    """Legacy SigV2 (reference auth_signature_v2.go): HMAC-SHA1 over
    method/md5/type/date/canonicalized-amz-headers+resource."""
    lower = {k.lower(): v for k, v in headers.items()}
    auth = lower.get("authorization", "")
    if not auth.startswith("AWS "):
        raise S3AuthError(400, "AuthorizationHeaderMalformed")
    try:
        access_key, given = auth[4:].split(":", 1)
    except ValueError:
        raise S3AuthError(400, "AuthorizationHeaderMalformed") from None
    ident = iam.lookup(access_key)
    if ident is None:
        raise S3AuthError(403, "InvalidAccessKeyId")
    amz = sorted((k, v) for k, v in lower.items()
                 if k.startswith("x-amz-"))
    canon_amz = "".join(f"{k}:{v}\n" for k, v in amz)
    sts = (f"{method}\n{lower.get('content-md5', '')}\n"
           f"{lower.get('content-type', '')}\n{lower.get('date', '')}\n"
           f"{canon_amz}{path}")
    want = base64.b64encode(
        hmac.new(ident.secret_key.encode(), sts.encode(),
                 hashlib.sha1).digest()).decode()
    if not hmac.compare_digest(want, given):
        raise S3AuthError(403, "SignatureDoesNotMatch")
    return ident


def authenticate(iam: Iam, method: str, path: str,
                 query_pairs: List[Tuple[str, str]],
                 headers: Dict[str, str], body: bytes) -> Optional[Identity]:
    """Dispatch on auth style; None = anonymous allowed (iam disabled)."""
    if not iam.enabled:
        return None
    lower = {k.lower(): v for k, v in headers.items()}
    q = dict(query_pairs)
    auth = lower.get("authorization", "")
    if auth.startswith("AWS4-HMAC-SHA256"):
        return verify_v4(iam, method, path, query_pairs, headers, body)
    if "X-Amz-Signature" in q:
        return verify_v4_presigned(iam, method, path, query_pairs, headers)
    if auth.startswith("AWS "):
        return verify_v2(iam, method, path, headers)
    raise S3AuthError(403, "AccessDenied", "no credentials")


# -- streaming aws-chunked payload (reference chunked_reader_v4.go) ---------

def decode_aws_chunked(body: bytes, *, secret_key: str = "",
                       seed_signature: str = "", scope: str = "",
                       amz_date: str = "", verify: bool = False) -> bytes:
    """Decode STREAMING-AWS4-HMAC-SHA256-PAYLOAD framing:
    <hex-size>;chunk-signature=<sig>\r\n<data>\r\n ... 0;chunk-signature=...
    With verify=True, each chunk signature is checked against the rolling
    chunk string-to-sign chain."""
    if verify and scope.count("/") < 3:
        # sigv2 / presigned auth cannot carry a chunk-signature chain —
        # AWS requires header-based SigV4 for streaming payloads
        raise S3AuthError(403, "AccessDenied",
                          "streaming chunked payload requires "
                          "header-based SigV4 authentication")
    out = bytearray()
    pos = 0
    prev_sig = seed_signature
    while pos < len(body):
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise S3AuthError(400, "IncompleteBody", "bad chunk header")
        header = body[pos:nl].decode("ascii", "replace")
        size_s, _, ext = header.partition(";")
        try:
            size = int(size_s, 16)
        except ValueError:
            raise S3AuthError(400, "IncompleteBody",
                              f"bad chunk size {size_s!r}") from None
        data = body[nl + 2:nl + 2 + size]
        if len(data) < size:
            raise S3AuthError(400, "IncompleteBody", "short chunk")
        if verify:
            sig = ext.partition("chunk-signature=")[2]
            sts = "\n".join([
                "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev_sig,
                hashlib.sha256(b"").hexdigest(),
                hashlib.sha256(data).hexdigest()])
            date, region = scope.split("/")[0:2]
            key = derive_signing_key(secret_key, date, region)
            want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, sig):
                raise S3AuthError(403, "SignatureDoesNotMatch",
                                  "chunk signature mismatch")
            prev_sig = sig
        out += data
        pos = nl + 2 + size + 2  # skip trailing \r\n
        if size == 0:
            break
    return bytes(out)


# -- client-side signer (tests + S3 replication sink) -----------------------

def sign_request_v4(method: str, url: str, headers: Dict[str, str],
                    body: bytes, access_key: str, secret_key: str,
                    region: str = "us-east-1",
                    amz_time: Optional[float] = None) -> Dict[str, str]:
    """Sign; returns the headers dict with Authorization et al added."""
    parsed = urllib.parse.urlparse(url)
    now = time.gmtime(amz_time if amz_time is not None else time.time())
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    date = amz_date[:8]
    payload_hash = hashlib.sha256(body).hexdigest()
    headers = dict(headers)
    headers["Host"] = parsed.netloc
    headers["X-Amz-Date"] = amz_date
    headers["X-Amz-Content-Sha256"] = payload_hash
    lower = {k.lower(): v for k, v in headers.items()}
    signed = sorted(lower)
    query_pairs = urllib.parse.parse_qsl(parsed.query,
                                         keep_blank_values=True)
    scope = f"{date}/{region}/s3/aws4_request"
    canon = canonical_request(method, parsed.path or "/", query_pairs,
                              lower, signed, payload_hash)
    sts = string_to_sign(amz_date, scope, canon)
    key = derive_signing_key(secret_key, date, region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


def presign_url_v4(method: str, url: str, access_key: str,
                   secret_key: str, expires: int = 900,
                   region: str = "us-east-1",
                   amz_time: Optional[float] = None) -> str:
    parsed = urllib.parse.urlparse(url)
    now = time.gmtime(amz_time if amz_time is not None else time.time())
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    q = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    q += [("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
          ("X-Amz-Credential", f"{access_key}/{scope}"),
          ("X-Amz-Date", amz_date),
          ("X-Amz-Expires", str(expires)),
          ("X-Amz-SignedHeaders", "host")]
    headers = {"host": parsed.netloc}
    canon = canonical_request(method, parsed.path or "/", q, headers,
                              ["host"], UNSIGNED_PAYLOAD)
    sts = string_to_sign(amz_date, scope, canon)
    key = derive_signing_key(secret_key, date, region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    q.append(("X-Amz-Signature", sig))
    return urllib.parse.urlunparse(parsed._replace(
        query=urllib.parse.urlencode(q)))
