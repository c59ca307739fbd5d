"""The plain state machine of the null operation (0/0 payload): every
request executes once, changes no state and answers the same result, the
reference PBFT's ``"awesome!"`` (``src/message.rs``), which is what a
client must accept."""

from __future__ import annotations


class NullService:
    RESULT = "awesome!"

    def execute(self, operation: str) -> str:
        return self.RESULT
