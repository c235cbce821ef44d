"""s3 — the S3 REST gateway over the filer (``s3_server.S3ApiServer``)
and AWS request signing (``auth``: SigV4 by header and presigned, SigV2,
the aws-chunked stream, IAM identities). Only ``auth`` is imported here:
the tier backend signs through it without pulling the gateway in."""

from .auth import Iam, Identity, S3AuthError, sign_request_v4  # noqa: F401
