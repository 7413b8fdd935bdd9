"""host_ms.stream: ``readers.host_ms``."""

from stereobench.readers import host_ms as read  # noqa: F401
