"""plain_ms.stream: ``readers.plain_ms``."""

from stereobench.readers import plain_ms as read  # noqa: F401
