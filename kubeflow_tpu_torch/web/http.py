"""Request-body framing for the port's model server — its own copy of
``HTTPError``, the ``HTTP_MAX_BODY_BYTES`` limit and
``framed_body_length`` from ``kubeflow_tpu/web/http.py``, so the two
servers answer a badly framed request with the same status and words.
"""

import os


class HTTPError(Exception):
    def __init__(self, status, message):
        super().__init__(message)
        self.status = status
        self.message = message


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
