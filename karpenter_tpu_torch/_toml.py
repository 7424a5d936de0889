"""TOML read shim: stdlib ``tomllib`` (3.11+) with a ``tomli`` fallback.

The admission chain and the bottlerocket image family both parse operator
TOML; on Python 3.10 the stdlib module doesn't exist yet, and the two
import sites drifting out of sync is exactly how the 3.10 test failures
happened. One helper owns the fallback order: ``tomllib`` -> ``tomli`` ->
pip's vendored ``tomli`` (present wherever pip is). ``loads`` raises
``TOMLDecodeError`` from whichever backend loaded.
"""

from __future__ import annotations

try:
    import tomllib as _impl
except ModuleNotFoundError:  # Python < 3.11
    try:
        import tomli as _impl  # type: ignore[no-redef]
    except ModuleNotFoundError:  # last resort: pip always vendors tomli
        from pip._vendor import tomli as _impl  # type: ignore[no-redef]

TOMLDecodeError = _impl.TOMLDecodeError


def loads(text: str) -> dict:
    """Parse a TOML document into a dict (tomllib.loads semantics)."""
    return _impl.loads(text)
