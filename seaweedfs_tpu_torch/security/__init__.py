"""security — the master's per-fid write tokens and the IP whitelist.

The JAX package's ``security/``: ``jwt`` mints HS256 tokens bound to one
file id (the master hands one out with each assign; a volume server with
the key refuses a write or delete without it), and ``guard.Guard``
answers whether a caller's IP is on the whitelist. Mutual TLS is not
ported."""

from .guard import Guard  # noqa: F401
from .jwt import (GenJwt, VerifyError, decode_jwt,  # noqa: F401
                  encode_jwt, jwt_from_request, verify_fid_jwt)
