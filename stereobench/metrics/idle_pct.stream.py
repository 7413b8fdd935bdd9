"""idle_pct.stream: ``readers.idle_in_service_pct``."""

from stereobench.readers import idle_in_service_pct as read  # noqa: F401
