"""Logging setup with request-id propagation and chat-input redaction.

The reference only configures a level (reference ``app/main.py:30-36``) and
defines-but-never-uses privacy flags (``SAFE_LOG_CHAT_INPUT``,
``MAX_LOG_INPUT_CHARS``, reference ``app/config.py:265-266``). Here the
redaction flags are actually honoured via :func:`redact_chat_input`.
"""

from __future__ import annotations

import contextvars
import logging

request_id_var: contextvars.ContextVar[str] = contextvars.ContextVar(
    "request_id", default="-"
)


class _RequestIdFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = request_id_var.get()
        return True


def setup_logging(level: str = "INFO") -> None:
    root = logging.getLogger()
    if root.handlers:
        root.setLevel(level.upper())
        return
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s %(levelname)s [%(request_id)s] %(name)s: %(message)s"
        )
    )
    handler.addFilter(_RequestIdFilter())
    root.addHandler(handler)
    root.setLevel(level.upper())


def redact_chat_input(text: str, safe: bool, max_chars: int) -> str:
    if safe:
        return f"<redacted {len(text)} chars>"
    if len(text) > max_chars:
        return text[:max_chars] + "…"
    return text
