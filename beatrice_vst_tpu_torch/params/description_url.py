"""Safe-URL validation for model/voice description text.

The reference auto-links URLs in model descriptions but only after a
security validation pass -- an RFC-3986 subset restricted to http(s) with
`$` rejected -- before handing anything to the OS
(`src/vst/description_url.cc:1-60`, IsSafeDescriptionUrl).
The framework surfaces model-card descriptions through its API/CLI, so the
same validation applies before any client is told a link is a link.

A copy of `beatrice_vst_tpu/params/description_url.py` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import re
import string

# RFC 3986 subset: scheme restricted to http/https; host/path/query/fragment
# limited to unreserved / sub-delims (minus '$') / percent-encoding.
_ALLOWED = set(
    string.ascii_letters + string.digits + "-._~:/?#[]@!&'()*+,;=%"
)
_URL_RE = re.compile(r"https?://[^\s<>\"']+")


def is_safe_description_url(url: str) -> bool:
    """http(s)-only, printable RFC-3986 subset, no `$`, sane length."""
    if not 8 <= len(url) <= 2048:
        return False
    if not (url.startswith("http://") or url.startswith("https://")):
        return False
    if "$" in url:
        return False
    if any(ch not in _ALLOWED for ch in url):
        return False
    # percent-encodings must be well-formed
    for m in re.finditer("%", url):
        tail = url[m.start() + 1: m.start() + 3]
        if len(tail) < 2 or not all(c in string.hexdigits for c in tail):
            return False
    host = url.split("://", 1)[1]
    return bool(host) and not host.startswith("/")


def extract_safe_urls(text: str) -> list[str]:
    """Find candidate URLs in description text, keeping only safe ones."""
    return [u for u in _URL_RE.findall(text) if is_safe_description_url(u)]
