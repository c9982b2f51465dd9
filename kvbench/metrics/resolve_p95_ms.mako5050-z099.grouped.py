"""``resolve_p95_ms`` of a cell whose card sat idle most of its first
traced run (mako5050-z099.grouped: 80.3% on an H100), read in the
traced run: a host-paced tail, so a per-layer reading and not an
end-to-end bound."""

from .resolve_p95_ms import read  # noqa: F401 — the same reading
