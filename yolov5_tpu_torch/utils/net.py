"""SSRF-hardened URL fetching for inference sources.

A copy of ``yolov5_tpu/utils/net.py`` (framework-free host code), tested
equal to it in ``tests/test_torch_sources.py``.

The reference's AutoShape validates URLs before fetching them
(the reference's models/common.py:817-840) and detect.py downloads URL
sources via check_file (utils/general.py). This module provides the same
surface with explicit server-side-request-forgery defenses:

- http/https schemes only
- every DNS resolution of the host must be a public unicast address
  (loopback, RFC1918, link-local, CGN, multicast, reserved all rejected)
- redirects are validated hop by hop with the same rules (no redirect
  smuggling into the internal network), bounded hop count
- response size capped

Zero-egress environments simply get a clean error from the socket layer;
the validation logic is unit-tested with a local loopback server (which is
exactly what it must refuse).
"""

from __future__ import annotations

import ipaddress
import socket
import urllib.parse
import urllib.request

MAX_REDIRECTS = 3
MAX_BYTES = 64 << 20  # 64 MB cap for fetched images/videos


class UnsafeURLError(ValueError):
    pass


def _addr_is_public(ip: str) -> bool:
    a = ipaddress.ip_address(ip)
    if a.version == 6 and a.ipv4_mapped is not None:
        a = a.ipv4_mapped  # ::ffff:10.0.0.1 must be judged as 10.0.0.1
    return a.is_global and not (a.is_multicast or a.is_reserved)


def validate_url(url: str, allow_private: bool = False) -> str:
    """Raise UnsafeURLError unless `url` is an http(s) URL whose host
    resolves exclusively to public addresses. Returns the normalized URL."""
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme not in ("http", "https"):
        raise UnsafeURLError(f"unsupported scheme {parsed.scheme!r} in {url}")
    host = parsed.hostname
    if not host:
        raise UnsafeURLError(f"no host in {url}")
    if parsed.username or parsed.password:
        raise UnsafeURLError(f"credentials in URL are not allowed: {url}")
    if allow_private:
        return url
    try:
        infos = socket.getaddrinfo(host, parsed.port or
                                   (443 if parsed.scheme == "https" else 80),
                                   proto=socket.IPPROTO_TCP)
    except socket.gaierror as e:
        raise UnsafeURLError(f"cannot resolve {host}: {e}") from e
    for info in infos:
        ip = info[4][0]
        if not _addr_is_public(ip):
            raise UnsafeURLError(
                f"{url} resolves to non-public address {ip} (SSRF blocked)")
    return url


def safe_url_fetch(url: str, max_bytes: int = MAX_BYTES,
                   allow_private: bool = False, timeout: float = 30.0) -> bytes:
    """Fetch `url` with per-hop SSRF validation and a size cap."""
    current = url
    for _ in range(MAX_REDIRECTS + 1):
        validate_url(current, allow_private=allow_private)

        class NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *a, **k):
                return None

        opener = urllib.request.build_opener(NoRedirect)
        req = urllib.request.Request(current, headers={"User-Agent": "yolov5_tpu"})
        try:
            with opener.open(req, timeout=timeout) as resp:
                data = resp.read(max_bytes + 1)
                if len(data) > max_bytes:
                    raise UnsafeURLError(f"{url}: response exceeds {max_bytes} bytes")
                return data
        except urllib.error.HTTPError as e:
            if e.code in (301, 302, 303, 307, 308):
                loc = e.headers.get("Location")
                if not loc:
                    raise UnsafeURLError(f"{url}: redirect without Location")
                current = urllib.parse.urljoin(current, loc)
                continue
            raise
    raise UnsafeURLError(f"{url}: too many redirects (> {MAX_REDIRECTS})")


def fetch_url_to_file(url: str, dest_dir=None, allow_private: bool = False) -> str:
    """Download a validated URL to a local file; returns the path
    (reference check_file URL branch, utils/general.py)."""
    import tempfile
    from pathlib import Path

    data = safe_url_fetch(url, allow_private=allow_private)
    name = Path(urllib.parse.urlparse(url).path).name or "download"
    dest_dir = Path(dest_dir) if dest_dir else Path(tempfile.mkdtemp(prefix="yolov5_tpu_"))
    dest_dir.mkdir(parents=True, exist_ok=True)
    out = dest_dir / name
    out.write_bytes(data)
    return str(out)
