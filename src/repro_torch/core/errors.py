"""Farm-runtime exceptions, in a leaf module.

``ServiceFailure`` is raised on every path where a service node stops
being usable — in-process fault injection, a dropped socket, a worker
process that was SIGKILLed.  It lives here (not in ``service.py``) so the
transport backends can raise it without importing the in-process worker
implementation, which itself imports the transport registry.
"""

from __future__ import annotations


class ServiceFailure(RuntimeError):
    """Raised to a control thread when the service has died."""


class TransportError(RuntimeError):
    """A transport-layer problem that is not a service death: unknown
    endpoint scheme, malformed frame, oversized message."""


class RemoteProgramError(RuntimeError):
    """The *program* (not the node) raised on a remote worker.  Carries the
    remote traceback text so the client-side error is debuggable."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback

    def __str__(self) -> str:  # surface the remote stack in test output
        base = super().__str__()
        if self.remote_traceback:
            return f"{base}\n--- remote traceback ---\n{self.remote_traceback}"
        return base
