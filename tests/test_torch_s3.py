"""The port's S3 gateway and signatures against the JAX package's.

- SigV4 by header and presigned, and SigV2: what one package signs the
  other verifies (and refuses when tampered, expired or signed with the
  wrong secret, with the same error code); ``authorization_header_v4``
  and ``sign_request_v4`` are byte-equal on a fixed clock.
- ``decode_aws_chunked``: a chunk-signed stream built with one package's
  signing key decodes through the other with every chunk signature
  checked; a tampered chunk fails in both.
- The gateway flows on both stacks (master, volume server, filer and
  S3ApiServer each; 4 KiB chunks): buckets, seeded objects, an
  aws-chunked streaming PUT, multipart (initiate, three parts, list
  uploads and parts, complete; another aborted), CopyObject,
  ListObjects v1 and v2 with prefix, delimiter, max-keys and the
  continuation token, HEAD, a ranged GET across a chunk edge,
  DeleteObjects, a deleted key's 404 NoSuchKey, the filer's own GET of
  an object, BucketNotEmpty, a wrong and a missing signature, and a
  presigned GET. Statuses, the headers that matter and the XML must be
  equal once dates and upload ids are normalized; bodies byte-equal.
  The flows run against the in-process gateway and against a standalone
  one over ``FilerClient``, in each package.
- A degraded S3 GET: on the port's stack one volume of the bucket's
  collection is EC-encoded through the shell, a shard that the objects
  cross is removed and unmounted, and every object read through S3 (the
  degraded engine on the plain K1 version, on the CPU) must equal the
  JAX stack's bytes.

Tolerances: none.
"""

import hashlib
import hmac
import http.client
import os
import random
import re
import time
import urllib.parse

import pytest

from conftest import wait_until

AK, SK = "AKIDPORTTEST", "port/secret+key"
CHUNK = 4096
SEED = 20


def _auth(kind):
    if kind == "ref":
        from seaweedfs_tpu.s3 import auth
    else:
        from seaweedfs_tpu_torch.s3 import auth
    return auth


# -- signatures ---------------------------------------------------------------

@pytest.mark.parametrize("signer,verifier", [("ref", "port"),
                                             ("port", "ref")])
def test_signatures_cross_verify(signer, verifier):
    s, v = _auth(signer), _auth(verifier)
    iam = v.Iam([v.Identity("t", AK, SK, ["Read:b", "Write:b"])])
    for method, url, body in (
            ("PUT", "http://x.test/b/k.txt", b"data"),
            ("GET", "http://x.test/b/a%20b?partNumber=2&uploadId=u", b""),
            ("POST", "http://x.test/b?delete=", b"<Delete/>")):
        signed = s.sign_request_v4(method, url, {"Content-Type": "x/y"},
                                   body, AK, SK)
        p = urllib.parse.urlparse(url)
        pairs = urllib.parse.parse_qsl(p.query, keep_blank_values=True)
        assert v.authenticate(iam, method, p.path, pairs, signed,
                              body).name == "t"
        with pytest.raises(v.S3AuthError) as e:
            v.verify_v4(iam, method, p.path, pairs, signed, body + b"!")
        assert e.value.code == "XAmzContentSHA256Mismatch"
        bad = s.sign_request_v4(method, url, {}, body, AK, "wrong")
        with pytest.raises(v.S3AuthError) as e:
            v.verify_v4(iam, method, p.path, pairs, bad, body)
        assert e.value.code == "SignatureDoesNotMatch"
    url = s.presign_url_v4("GET", "http://x.test/b/k", AK, SK, expires=60)
    p = urllib.parse.urlparse(url)
    pairs = urllib.parse.parse_qsl(p.query, keep_blank_values=True)
    assert v.authenticate(iam, "GET", p.path, pairs, {"Host": "x.test"},
                          b"").name == "t"
    old = s.presign_url_v4("GET", "http://x.test/b/k", AK, SK, expires=5,
                           amz_time=1_000_000.0)
    p = urllib.parse.urlparse(old)
    with pytest.raises(v.S3AuthError):
        v.authenticate(iam, "GET", p.path, urllib.parse.parse_qsl(p.query),
                       {"Host": "x.test"}, b"")
    # SigV2, signed by hand with the same recipe
    import base64
    headers = {"Date": "Sat, 17 Oct 2026 10:00:00 GMT",
               "Content-Type": "text/plain", "x-amz-meta-a": "1"}
    sts = ("GET\n\ntext/plain\nSat, 17 Oct 2026 10:00:00 GMT\n"
           "x-amz-meta-a:1\n/b/k")
    sig = base64.b64encode(hmac.new(SK.encode(), sts.encode(),
                                    hashlib.sha1).digest()).decode()
    headers["Authorization"] = f"AWS {AK}:{sig}"
    assert v.authenticate(iam, "GET", "/b/k", [], headers, b"").name == "t"


def test_signing_byte_equal_on_a_fixed_clock():
    r, p = _auth("ref"), _auth("port")
    headers = {"host": "h:1", "x-amz-date": "20261018T010203Z",
               "x-amz-content-sha256": r.UNSIGNED_PAYLOAD}
    args = ("PUT", "/b/a%2Bb", headers, r.UNSIGNED_PAYLOAD, AK, SK,
            "eu-west-1", "s3", "20261018T010203Z")
    assert p.authorization_header_v4(*args) == \
        r.authorization_header_v4(*args)
    for m in (r, p):
        assert m.derive_signing_key(SK, "20261018", "us-east-1") == \
            r.derive_signing_key(SK, "20261018", "us-east-1")
    url = "http://h:1/b/k?x=1&a=%20"
    assert p.sign_request_v4("GET", url, {}, b"z", AK, SK,
                             amz_time=1.76e9) == \
        r.sign_request_v4("GET", url, {}, b"z", AK, SK, amz_time=1.76e9)
    assert p.presign_url_v4("GET", url, AK, SK, amz_time=1.76e9) == \
        r.presign_url_v4("GET", url, AK, SK, amz_time=1.76e9)
    cfg = {"identities": [{"name": "n", "actions": ["Read"],
                           "credentials": [{"accessKey": "a",
                                            "secretKey": "s"},
                                           {"accessKey": "b",
                                            "secretKey": "t"}]}]}
    assert [vars(i) for i in p.Iam.from_config(cfg).identities] == \
        [vars(i) for i in r.Iam.from_config(cfg).identities]


def _aws_chunked(auth, chunks, seed, scope, amz_date):
    date, region = scope.split("/")[0:2]
    key = auth.derive_signing_key(SK, date, region)
    prev, out = seed, b""
    for d in list(chunks) + [b""]:
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev,
                         hashlib.sha256(b"").hexdigest(),
                         hashlib.sha256(d).hexdigest()])
        prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        out += f"{len(d):x};chunk-signature={prev}\r\n".encode() + d + \
            b"\r\n"
    return out


@pytest.mark.parametrize("signer,decoder", [("ref", "port"),
                                            ("port", "ref")])
def test_aws_chunked_cross(signer, decoder):
    s, d = _auth(signer), _auth(decoder)
    scope = "20261018/us-east-1/s3/aws4_request"
    parts = [b"a" * 100, os.urandom(70000), b"tail"]
    body = _aws_chunked(s, parts, "seed" * 16, scope, "20261018T000000Z")
    kw = dict(secret_key=SK, seed_signature="seed" * 16, scope=scope,
              amz_date="20261018T000000Z", verify=True)
    assert d.decode_aws_chunked(body, **kw) == b"".join(parts)
    assert d.decode_aws_chunked(body) == b"".join(parts)
    bad = body.replace(b"tail", b"tall")
    for m in (s, d):
        with pytest.raises(m.S3AuthError) as e:
            m.decode_aws_chunked(bad, **kw)
        assert e.value.code == "SignatureDoesNotMatch"
    for m in (s, d):
        with pytest.raises(m.S3AuthError) as e:
            m.decode_aws_chunked(b"zz;chunk-signature=a\r\nx\r\n")
        assert e.value.code == "IncompleteBody"


# -- the gateway ----------------------------------------------------------------

class Stack:
    """A master, a volume server and a filer of one package, and its S3
    gateway: in the filer's process, or standalone over FilerClient."""

    def __init__(self, kind, root, standalone=False, chunk=CHUNK):
        self.kind = kind
        if kind == "ref":
            from seaweedfs_tpu.filer.filer_client import FilerClient
            from seaweedfs_tpu.s3.auth import Iam, Identity
            from seaweedfs_tpu.s3.s3_server import S3ApiServer
            from seaweedfs_tpu.server.filer_server import FilerServer
            from seaweedfs_tpu.server.master import MasterServer
            from seaweedfs_tpu.server.volume_server import VolumeServer
            self.master = MasterServer(port=0, volume_size_limit_mb=64,
                                       pulse_seconds=1).start()
            self.vs = VolumeServer(port=0, directories=[str(root / "r-v")],
                                   master_url=self.master.url,
                                   pulse_seconds=1, max_volume_counts=[20],
                                   ec_backend="numpy", fast_port=-1).start()
        else:
            from seaweedfs_tpu_torch.filer.filer_client import FilerClient
            from seaweedfs_tpu_torch.s3.auth import Iam, Identity
            from seaweedfs_tpu_torch.s3.s3_server import S3ApiServer
            from seaweedfs_tpu_torch.server.filer_server import FilerServer
            from seaweedfs_tpu_torch.server.master import MasterServer
            from seaweedfs_tpu_torch.server.volume_server import \
                VolumeServer
            self.master = MasterServer(port=0, volume_size_limit_mb=64,
                                       pulse_seconds=1,
                                       repair_interval=0).start()
            self.vs = VolumeServer(port=0, directories=[str(root / "p-v")],
                                   master_url=self.master.url,
                                   pulse_seconds=1, max_volume_counts=[20],
                                   device="cpu", fast_port=-1).start()
        self.filer = FilerServer(port=0, master_url=self.master.url).start()
        meta = FilerClient(self.filer.url) if standalone \
            else self.filer.filer
        self.s3 = S3ApiServer(meta, self.master.url, port=0,
                              iam=Iam([Identity("t", AK, SK)]),
                              chunk_size=chunk).start()

    def stop(self):
        for s in (self.s3, self.filer, self.vs, self.master):
            s.stop()


def _s3(stack, method, path, body=b"", headers=None, sign=True):
    """(status, headers that matter, body) of a request signed with the
    port's signer."""
    from seaweedfs_tpu_torch.s3.auth import sign_request_v4
    url = f"http://{stack.s3.url}{path}"
    h = dict(headers or {})
    if sign:
        h = sign_request_v4(method, url, h, body, AK, SK)
    conn = http.client.HTTPConnection(stack.s3.url, timeout=60)
    try:
        conn.request(method, path, body=body or None, headers=h)
        r = conn.getresponse()
        data = r.read()
        keep = {k: r.getheader(k) for k in (
            "Content-Type", "Content-Length", "Content-Range", "ETag",
            "Location") if r.getheader(k) is not None}
        return r.status, keep, data
    finally:
        conn.close()


_XML_NORM = [(re.compile(rb"<(LastModified|CreationDate|Initiated)>"
                         rb"[^<]*</\1>"), rb"<\1>T</\1>"),
             (re.compile(rb"<UploadId>[0-9a-f]{32}</UploadId>"),
              rb"<UploadId>U</UploadId>"),
             (re.compile(rb"\.uploads/[0-9a-f]{32}"), rb".uploads/U")]


def _norm(data):
    for rx, sub in _XML_NORM:
        data = rx.sub(sub, data)
    return data


def _objects(seed, n=8):
    rng = random.Random(seed)
    keys = ["a/1.bin", "a/2.bin", "a/b/3.bin", "c/4.txt", "top.bin",
            "a/b/c/5.bin", "space key.bin", "z.bin"]
    return [(keys[i], rng.randbytes(rng.randrange(1, 5 * CHUNK)))
            for i in range(n)]


def _streaming_put(stack, path, data):
    from seaweedfs_tpu_torch.s3 import auth
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    payload = auth.STREAMING_PAYLOAD
    headers = {"host": stack.s3.url, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload,
               "x-amz-decoded-content-length": str(len(data))}
    authz = auth.authorization_header_v4("PUT", path, headers, payload,
                                         AK, SK, "us-east-1")
    seed = authz.rpartition("Signature=")[2]
    scope = f"{amz_date[:8]}/us-east-1/s3/aws4_request"
    body = _aws_chunked(auth, [data[:3000], data[3000:]], seed, scope,
                        amz_date)
    headers["Authorization"] = authz
    conn = http.client.HTTPConnection(stack.s3.url, timeout=60)
    try:
        conn.request("PUT", path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.getheader("ETag"), r.read()
    finally:
        conn.close()


def _flow(stack):
    out = []

    def rec(label, *args, **kw):
        status, hdrs, data = _s3(stack, *args, **kw)
        out.append((label, status, hdrs, _norm(data)))
        return status, hdrs, data

    rec("create", "PUT", "/bkt")
    rec("create again", "PUT", "/bkt")
    rec("location", "GET", "/bkt?location")
    objs = _objects(SEED)
    for k, data in objs:
        rec(f"put {k}", "PUT", "/bkt/" + urllib.parse.quote(k), data,
            {"Content-Type": "application/octet-stream"})
    out.append(("streaming put",) + _streaming_put(
        stack, "/bkt/streamed.bin", objs[0][1] * 2))
    # multipart: three parts, composed without a copy
    _, _, body = rec("mpu init", "POST", "/bkt/mp.bin?uploads")
    uid = re.search(rb"<UploadId>([^<]+)", body).group(1).decode()
    parts = [objs[1][1] + objs[2][1], objs[3][1] * 2, b"last part"]
    for i, p in enumerate(parts, 1):
        rec(f"mpu part {i}", "PUT",
            f"/bkt/mp.bin?partNumber={i}&uploadId={uid}", p)
    rec("mpu list uploads", "GET", "/bkt?uploads")
    rec("mpu list parts", "GET", f"/bkt/mp.bin?uploadId={uid}")
    done = b"<CompleteMultipartUpload>" + b"".join(
        b"<Part><PartNumber>%d</PartNumber></Part>" % i
        for i in range(1, 4)) + b"</CompleteMultipartUpload>"
    rec("mpu complete", "POST", f"/bkt/mp.bin?uploadId={uid}", done)
    rec("mpu get", "GET", "/bkt/mp.bin")
    _, _, body = rec("mpu2 init", "POST", "/bkt/gone.bin?uploads")
    uid2 = re.search(rb"<UploadId>([^<]+)", body).group(1).decode()
    rec("mpu2 part", "PUT", f"/bkt/gone.bin?partNumber=1&uploadId={uid2}",
        b"x" * 10)
    rec("mpu2 abort", "DELETE", f"/bkt/gone.bin?uploadId={uid2}")
    rec("mpu2 parts after abort", "GET", f"/bkt/gone.bin?uploadId={uid2}")
    rec("copy", "PUT", "/bkt/copied/top.bin", b"",
        {"x-amz-copy-source": "/bkt/top.bin"})
    rec("list v2 prefix delimiter", "GET",
        "/bkt?list-type=2&prefix=a/&delimiter=/")
    rec("list v2 page 1", "GET", "/bkt?list-type=2&max-keys=3")
    rec("list v2 page 2", "GET",
        "/bkt?list-type=2&max-keys=3&continuation-token=a/b/c/5.bin")
    rec("list v1 marker", "GET", "/bkt?marker=c/4.txt")
    rec("list v1 delimiter", "GET", "/bkt?delimiter=/")
    rec("head", "HEAD", "/bkt/a/b/3.bin")
    big = next(d for _, d in objs if len(d) > CHUNK + 300)
    key = next(k for k, d in objs if d is big)
    rec("range across chunk edge", "GET", "/bkt/" + urllib.parse.quote(key),
        headers={"Range": f"bytes={CHUNK - 200}-{CHUNK + 199}"})
    rec("bad range", "GET", "/bkt/" + urllib.parse.quote(key),
        headers={"Range": "bytes=999999-"})
    rec("delete objects", "POST", "/bkt?delete",
        b"<Delete><Object><Key>a/1.bin</Key></Object><Object><Key>z.bin"
        b"</Key></Object></Delete>")
    rec("deleted get", "GET", "/bkt/a/1.bin")
    rec("missing bucket", "GET", "/nobucket/x")
    for k, data in objs:
        rec(f"get {k}", "GET", "/bkt/" + urllib.parse.quote(k))
    fstatus = http.client.HTTPConnection(stack.filer.url, timeout=30)
    fstatus.request("GET", "/buckets/bkt/a/b/3.bin")
    r = fstatus.getresponse()
    out.append(("filer get", r.status, r.read() == objs[2][1]))
    fstatus.close()
    rec("bucket not empty", "DELETE", "/bkt")
    rec("list buckets", "GET", "/")
    rec("unsigned", "GET", "/bkt/top.bin", sign=False)
    from seaweedfs_tpu_torch.s3.auth import presign_url_v4
    url = presign_url_v4("GET", f"http://{stack.s3.url}/bkt/top.bin",
                         AK, SK)
    p = urllib.parse.urlparse(url)
    out.append(("presigned",) + _s3(stack, "GET", f"{p.path}?{p.query}",
                                    sign=False))
    return out


@pytest.mark.parametrize("standalone", (False, True),
                         ids=("in_process", "filer_client"))
def test_gateway_flows_match_jax(tmp_path, standalone):
    got = {}
    for kind in ("ref", "port"):
        stack = Stack(kind, tmp_path / kind, standalone)
        try:
            got[kind] = _flow(stack)
        finally:
            stack.stop()
    ref, port = got["ref"], got["port"]
    assert [r[0] for r in port] == [r[0] for r in ref]
    for r, p in zip(ref, port):
        assert p == r, r[0]
    byname = {r[0]: r[1:] for r in port}
    assert byname["deleted get"][0] == 404 and \
        b"<Code>NoSuchKey</Code>" in byname["deleted get"][2]
    assert byname["mpu complete"][0] == 200 and \
        re.search(rb"<ETag>&quot;[0-9a-f]{32}-3&quot;</ETag>|"
                  rb'<ETag>"[0-9a-f]{32}-3"</ETag>',
                  byname["mpu complete"][2])
    assert byname["range across chunk edge"][0] == 206
    assert byname["filer get"] == (200, True)
    assert byname["unsigned"][0] == 403 and byname["presigned"][0] == 200
    objs = dict(_objects(SEED))
    assert byname["get top.bin"][2] == objs["top.bin"]
    assert byname["get top.bin"][1]["ETag"] == \
        f'"{hashlib.md5(objs["top.bin"]).hexdigest()}"'


def test_degraded_get_through_a_lost_shard(tmp_path):
    """An object on an EC volume whose shard under it is lost reads
    through S3 with the bytes the JAX stack returns."""
    from seaweedfs_tpu_torch.server.http_util import get_json
    objs = [(f"o{i}.bin", random.Random(i).randbytes(400 << 10))
            for i in range(14)]
    got = {}
    for kind in ("ref", "port"):
        stack = Stack(kind, tmp_path / kind, chunk=1 << 20)
        try:
            _s3(stack, "PUT", "/deg")
            for k, d in objs:
                assert _s3(stack, "PUT", f"/deg/{k}", d)[0] == 200
            if kind == "port":
                lost = _lose_a_shard(stack, objs)
            got[kind] = [_s3(stack, "GET", f"/deg/{k}")[2]
                         for k, _ in objs]
            if kind == "port":
                st = get_json(f"http://{stack.vs.url}/status")
                deg = st["ec_degraded"]
                assert deg["reads"] >= lost["crossing"] > 0
                assert deg["device_dispatches"] > 0
        finally:
            stack.stop()
    assert got["port"] == got["ref"] == [d for _, d in objs]


def _lose_a_shard(stack, objs):
    """ec.encode the volume holding the most objects, then remove and
    unmount the shard the most of its objects cross."""
    import io
    from collections import Counter
    from seaweedfs_tpu_torch.server.http_util import http_call
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.storage.types import parse_file_id
    fids = {k: stack.filer.filer.find_entry(f"/buckets/deg/{k}").chunks[0]
            for k, _ in objs}
    by_vid = Counter(parse_file_id(c.fid)[0] for c in fids.values())
    vid = by_vid.most_common(1)[0][0]
    out = io.StringIO()
    run_command(CommandEnv(stack.master.url, out=out),
                f"ec.encode -volumeId {vid}")
    ev = stack.vs.store.find_ec_volume(vid)
    assert ev is not None, out.getvalue()
    crossing = Counter()
    for c in fids.values():
        v, key, _ = parse_file_id(c.fid)
        if v != vid:
            continue
        for sid in {iv.block_index % 10
                    for iv in ev.locate_needle(key)[2]}:
            crossing[sid] += 1
    sid, n = crossing.most_common(1)[0]
    base = ev.base_name
    os.remove(base + f".ec{sid:02d}")
    http_call("POST", f"http://{stack.vs.url}/admin/ec/unmount?volume={vid}"
              f"&shards={sid}")
    assert wait_until(lambda: sid not in [
        s for s in stack.vs.store.find_ec_volume(vid).shard_ids()])
    return {"vid": vid, "sid": sid, "crossing": n}
