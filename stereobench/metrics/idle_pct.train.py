"""idle_pct.train: ``readers.idle_pct``."""

from stereobench.readers import idle_pct as read  # noqa: F401
