"""Request framing for the port's model server — its own copy of
``HTTPError``, ``parse_request_head``, the ``HTTP_MAX_BODY_BYTES`` limit
and ``framed_body_length`` from ``kubeflow_tpu/web/http.py``, so the two
servers answer a badly framed request with the same status and words,
on either transport.
"""

import os


class HTTPError(Exception):
    def __init__(self, status, message):
        super().__init__(message)
        self.status = status
        self.message = message


def parse_request_head(head):
    """One HTTP/1.x request head (request line + header lines, WITHOUT
    the terminating blank line) → ``(method, target, headers)`` with
    header names lowercased. Malformed → ValueError. The async
    transport parses every request head through it."""
    try:
        text = head.decode("latin-1")
    except (UnicodeDecodeError, AttributeError):
        raise ValueError("undecodable request head")
    lines = text.split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise ValueError(f"malformed request line {lines[0]!r}")
    headers = {}
    for ln in lines[1:]:
        if not ln:
            continue
        name, sep, value = ln.partition(":")
        if not sep or not name or name != name.strip() or " " in name:
            raise ValueError(f"malformed header line {ln!r}")
        headers[name.lower()] = value.strip()
    return parts[0].upper(), parts[1], headers


def max_body_bytes():
    """``HTTP_MAX_BODY_BYTES`` (default 64 MiB): the largest body a
    single request may DECLARE, checked before any buffer is sized from
    the client's number. Read per request so operators can raise it
    live."""
    try:
        return int(os.environ.get("HTTP_MAX_BODY_BYTES", "")
                   or (64 << 20))
    except ValueError:
        return 64 << 20


def framed_body_length(method, get_header):
    """Request-body framing contract: the body must be length-framed.
    → Content-Length (0 when the method carries none); raises
    HTTPError otherwise:

    - 411 for ``Transfer-Encoding: chunked`` (reads are sized by
      Content-Length; treating the body as empty would desync the
      keep-alive connection),
    - 501 for any other Transfer-Encoding,
    - 411 for a body-carrying method (POST/PUT/PATCH) with no
      Content-Length at all,
    - 400 for a malformed/negative Content-Length,
    - 413 for a Content-Length past ``HTTP_MAX_BODY_BYTES``.

    ``get_header(name)`` abstracts the header container."""
    te = (get_header("Transfer-Encoding") or "").strip().lower()
    if te:
        if "chunked" in te:
            raise HTTPError(411, "chunked request bodies not "
                                 "supported; send Content-Length")
        raise HTTPError(501, f"Transfer-Encoding {te!r} not supported")
    raw = get_header("Content-Length")
    if raw is None or not str(raw).strip():
        if method.upper() in ("POST", "PUT", "PATCH"):
            raise HTTPError(411, "Content-Length required: request "
                                 "bodies must be length-framed")
        return 0
    try:
        length = int(str(raw).strip())
    except ValueError:
        raise HTTPError(400, f"malformed Content-Length {raw!r}") \
            from None
    if length < 0:
        raise HTTPError(400, f"negative Content-Length {raw!r}")
    limit = max_body_bytes()
    if length > limit:
        raise HTTPError(413, f"request body of {length} bytes "
                             f"exceeds the {limit}-byte limit "
                             f"(HTTP_MAX_BODY_BYTES)")
    return length
