"""Minimal S3 filesystem: SigV4-signed HTTP client over urllib (stdlib only);
the port's own copy of ``dali_tpu/_s3.py``.

The analogue of the reference's AWS-SDK-based storage layer
(dali/util/s3_filesystem.cc, dali/operators/reader/loader/discover_files_s3.cc):
``s3://bucket/key`` URIs work anywhere readers take paths. Credentials and
endpoint come from the standard environment:

  AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / AWS_SESSION_TOKEN
  AWS_DEFAULT_REGION (default us-east-1)
  AWS_ENDPOINT_URL or S3_ENDPOINT_URL  (e.g. a MinIO/mock server; when set,
      path-style addressing is used — also how the tests run offline)
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple


def is_s3(path: str) -> bool:
    return isinstance(path, str) and path.startswith("s3://")


def parse_uri(uri: str) -> Tuple[str, str]:
    rest = uri[len("s3://"):]
    bucket, _, key = rest.partition("/")
    if not bucket:
        raise ValueError(f"Invalid S3 URI: {uri!r}")
    return bucket, key


class S3Client:
    def __init__(self, region: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 session_token: Optional[str] = None,
                 endpoint_url: Optional[str] = None):
        self.region = region or os.environ.get("AWS_DEFAULT_REGION", "us-east-1")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.session_token = session_token or os.environ.get("AWS_SESSION_TOKEN")
        self.endpoint_url = (endpoint_url or os.environ.get("AWS_ENDPOINT_URL")
                             or os.environ.get("S3_ENDPOINT_URL"))

    # -- SigV4 ---------------------------------------------------------------
    def _sign(self, method: str, host: str, path: str, query: str,
              payload_hash: str, now: datetime.datetime) -> dict:
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        signed = ";".join(sorted(headers))
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        canonical = "\n".join([method, path, query, canonical_headers, signed,
                               payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                             hashlib.sha256(canonical.encode()).hexdigest()])

        def hm(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = hm(("AWS4" + self.secret_key).encode(), datestamp)
        k = hm(k, self.region)
        k = hm(k, "s3")
        k = hm(k, "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        auth = (f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                f"SignedHeaders={signed}, Signature={sig}")
        out = {"Authorization": auth, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
        if self.session_token:
            out["x-amz-security-token"] = self.session_token
        return out

    def _request(self, bucket: str, key: str, query: dict,
                 range_header: Optional[str] = None) -> bytes:
        if self.endpoint_url:  # path-style (MinIO / mocks)
            base = self.endpoint_url.rstrip("/")
            host = urllib.parse.urlparse(base).netloc
            path = "/" + urllib.parse.quote(f"{bucket}/{key}" if key else bucket)
        else:  # virtual-hosted style
            host = f"{bucket}.s3.{self.region}.amazonaws.com"
            base = f"https://{host}"
            path = "/" + urllib.parse.quote(key)
        # RFC 3986 encoding (%20, not '+') — SigV4 canonicalization requires it
        qs = urllib.parse.urlencode(sorted(query.items()),
                                    quote_via=urllib.parse.quote)
        payload_hash = hashlib.sha256(b"").hexdigest()
        now = datetime.datetime.now(datetime.timezone.utc)
        headers = self._sign("GET", host, path, qs, payload_hash, now)
        if range_header:
            headers["Range"] = range_header
        url = f"{base}{path}" + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, headers=headers, method="GET")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()

    # -- public API -----------------------------------------------------------
    def get_object(self, bucket: str, key: str,
                   byte_range: Optional[Tuple[int, int]] = None) -> bytes:
        rng = f"bytes={byte_range[0]}-{byte_range[1] - 1}" if byte_range else None
        return self._request(bucket, key, {}, rng)

    def list_objects(self, bucket: str, prefix: str = "") -> List[Tuple[str, int]]:
        """All (key, size) under prefix (paginated ListObjectsV2)."""
        out: List[Tuple[str, int]] = []
        token = None
        while True:
            q = {"list-type": "2", "prefix": prefix}
            if token:
                q["continuation-token"] = token
            body = self._request(bucket, "", q)
            root = ET.fromstring(body)
            ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
            for c in root.findall(f"{ns}Contents"):
                k = c.find(f"{ns}Key").text
                sz = int(c.find(f"{ns}Size").text)
                out.append((k, sz))
            trunc = root.find(f"{ns}IsTruncated")
            if trunc is None or trunc.text != "true":
                break
            tok = root.find(f"{ns}NextContinuationToken")
            token = tok.text if tok is not None else None
            if not token:
                break
        return out


_default_client: Optional[S3Client] = None


def client() -> S3Client:
    global _default_client
    if _default_client is None:
        _default_client = S3Client()
    return _default_client


def reset_client():
    """Drop the cached client (tests switch endpoints via env vars)."""
    global _default_client
    _default_client = None


def read_bytes(uri: str) -> bytes:
    bucket, key = parse_uri(uri)
    return client().get_object(bucket, key)


def list_uris(root_uri: str) -> List[str]:
    """All object URIs under an s3://bucket/prefix root."""
    bucket, prefix = parse_uri(root_uri)
    if prefix and not prefix.endswith("/"):
        prefix += "/"
    return [f"s3://{bucket}/{k}" for k, _ in client().list_objects(bucket, prefix)]
